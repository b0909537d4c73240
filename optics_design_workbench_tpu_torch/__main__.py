'''
Command-line entry point — the headless analog of the reference workbench's
toolbar and menu commands (counterpart of the JAX package's `__main__`,
with the same commands and arguments, plus `--device`):

  python -m optics_design_workbench_tpu_torch run <scene> <action>
      actions: fans, singletrue, singlepseudo, true, pseudo, stop, clear
      <scene> is a *.scene.pkl or an FCStd project of the reference
      workbench (ingested without FreeCAD, models.loadFCStd).
      --recording histogram stores Monte-Carlo runs histogram-first.
  python -m optics_design_workbench_tpu_torch info <scene>
  python -m optics_design_workbench_tpu_torch export <scene> out.ply
      [--rays fans]
  python -m optics_design_workbench_tpu_torch runs <scene>

`run` and `export --rays` trace on `--device` (default cuda: it raises
without a card; `--device cpu` runs the kernels' plain PyTorch versions).
`bench` and `dryrun-multichip` are not ported yet and raise, naming their
ROADMAP items.
'''

import argparse
import json
import sys

_NOT_PORTED = {
    'bench': 'A.5 (the port\'s benchmark)',
    'dryrun-multichip': 'A.13 (multi-GPU)',
}


def _loadScene(path):
  if path.endswith('.FCStd'):
    from .models import loadFCStd
    return loadFCStd(path)
  from .jupyter_utils import loadScene, Document
  try:
    return loadScene(path if path.endswith('.scene.pkl')
                     else path + '.scene.pkl')
  except FileNotFoundError:
    return Document(path).scene


def _addDevice(parser):
  parser.add_argument('--device', default='cuda',
                      help="torch device to trace on (default cuda, which "
                           "raises without a card; 'cpu' runs the plain "
                           "PyTorch versions)")


def main(argv=None):
  parser = argparse.ArgumentParser(prog='optics_design_workbench_tpu_torch',
                                   description=__doc__)
  sub = parser.add_subparsers(dest='cmd', required=True)

  runP = sub.add_parser('run', help='run a simulation action on a scene')
  runP.add_argument('scene')
  runP.add_argument('action', choices=['fans', 'singletrue', 'singlepseudo',
                                       'true', 'pseudo', 'stop', 'clear'])
  runP.add_argument('--seed', type=int, default=None)
  runP.add_argument('--store', action='store_true', default=None,
                    help='force storing results for single-shot actions')
  runP.add_argument('--draw', action='store_true',
                    help='collect ray polylines of a single-shot action '
                         'into drawn-rays.ply/.npz in the run folder (the '
                         'headless analog of the GUI ray view)')
  runP.add_argument('--recording', choices=['raw', 'histogram'],
                    default='raw',
                    help='raw hit records (default) or histogram-first '
                         'storage of Monte-Carlo runs')
  _addDevice(runP)

  infoP = sub.add_parser('info', help='print the scene inventory')
  infoP.add_argument('scene')

  runsP = sub.add_parser('runs', help='list raw result folders')
  runsP.add_argument('scene')

  expP = sub.add_parser('export', help='tessellate the scene to a colored '
                        'PLY mesh, optionally with traced rays')
  expP.add_argument('scene')
  expP.add_argument('out', help='output .ply path')
  expP.add_argument('--resolution', type=int, default=48)
  expP.add_argument('--rays', choices=['fans', 'singletrue', 'singlepseudo'],
                    default=None,
                    help='also run this single-shot action and include the '
                         'drawn ray polylines')
  expP.add_argument('--seed', type=int, default=None)
  _addDevice(expP)

  sub.add_parser('bench', help='run the headline benchmark (not ported)')

  dryP = sub.add_parser('dryrun-multichip',
                        help='multi-chip compile check (not ported)')
  dryP.add_argument('n', type=int, nargs='?', default=8)

  args = parser.parse_args(argv)

  if args.cmd in _NOT_PORTED:
    raise NotImplementedError(
        f'{args.cmd} is not ported to the PyTorch package yet: ROADMAP item '
        f'{_NOT_PORTED[args.cmd]}')

  if args.cmd == 'run':
    from . import simulation
    scene = _loadScene(args.scene)
    runPath = simulation.runSimulation(scene, args.action, seed=args.seed,
                                       store=args.store, draw=args.draw,
                                       recording=args.recording,
                                       device=args.device)
    if runPath:
      print(runPath)
    return 0

  if args.cmd == 'export':
    from .geometry.tessellate import writeScenePLY
    scene = _loadScene(args.scene)
    drawn = None
    if args.rays:
      from . import simulation
      from .simulation.draw import DrawnRays
      drawn = DrawnRays()
      simulation.runSimulation(scene, args.rays, seed=args.seed,
                               draw=drawn, store=False, device=args.device)
    print(writeScenePLY(scene, args.out, resolution=args.resolution,
                        drawnRays=drawn))
    return 0

  if args.cmd == 'info':
    scene = _loadScene(args.scene)
    info = scene.collectGlobalInfo()

    def describeGroup(label):
      from .geometry.surfaces import _KIND_NAMES
      for g in scene.opticalObjects():
        if g.Label == label:
          kinds = {}
          for s in g.surfaces:
            name = _KIND_NAMES.get(s['kind'], str(s['kind']))
            kinds[name] = kinds.get(name, 0) + 1
          return ' + '.join(f'{n} {k}' for k, n in sorted(kinds.items()))
      return ''

    print(json.dumps(dict(
        label=info['label'],
        sources={k: v.get('PowerDensity') for k, v in
                 info['sources'].items()},
        opticalObjects={k: f"{v.get('OpticalType')} ({describeGroup(k)})"
                        for k, v in info['opticalObjects'].items()},
        settings=list(info['settings'])), indent=2))
    return 0

  if args.cmd == 'runs':
    from . import simulation
    from .jupyter_utils import rawFolders
    scene = _loadScene(args.scene)
    folder = simulation.getResultsFolderPath(scene.path or scene.label,
                                             ensure=False)
    for raw in rawFolders(folder):
      prog = raw.progress()
      extra = ''
      if prog:
        extra = (f"  rays={prog.get('totalTracedRays', 0):g} "
                 f"hits={prog.get('totalRecordedHits', 0):g}")
      print(raw.path + extra)
    return 0

  return 1


if __name__ == '__main__':
  sys.exit(main())
