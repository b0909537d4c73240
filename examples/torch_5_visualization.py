'''
Example 5 on the PyTorch / CUDA port — headless visualization (the port's
twin of examples/5_visualization.py): a single-shot run of the
lens-and-mirror scene with ray drawing, the tessellated scene and the
colored ray polylines exported to one PLY (MeshLab / Blender), and a
matplotlib preview where matplotlib is installed.

    python3 examples/torch_5_visualization.py [--device cpu] [--out DIR]

Route: `draw=` runs take the record tracer (tracing/tracer.trace, plain
PyTorch on the device), which records every segment of every ray, as the
reference's record tracer does. Runs on the first CUDA device; `--device
cpu` runs the tracer on the CPU.
'''

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from optics_design_workbench_tpu_torch import benchmarks, simulation
from optics_design_workbench_tpu_torch.geometry.tessellate import \
    writeScenePLY
from optics_design_workbench_tpu_torch.simulation.draw import DrawnRays


def main(device='cuda', out=None):
  '''The draw run and the PLY export; returns (DrawnRays, PLY path, the
  run's wall time in seconds).'''
  out = out or tempfile.mkdtemp(prefix='odw_example5_')
  scene = benchmarks.buildLensMirrorScene(tmpdir=out)
  scene.getObject('SimulationSettings').RaysPerIteration = 300

  # color the ray view: rays start red, turn teal after the fold mirror
  for group in scene.opticalObjects():
    if group.OpticalType == 'Mirror':
      group.ViewColor, group.ViewColorWeight = (0., 0.8, 0.8), 0.8

  drawn = DrawnRays()
  t0 = time.perf_counter()
  simulation.runSimulation(scene, 'singletrue', draw=drawn, seed=1,
                           store=False, device=device)
  seconds = time.perf_counter() - t0
  print(f'traced {drawn.rayCount} rays / {drawn.segmentCount} segments in '
        f'{seconds:.3f} s')

  ply = writeScenePLY(scene, os.path.join(out, 'lens-mirror-scene.ply'),
                      resolution=48, drawnRays=drawn)
  print(f'scene + rays exported to {ply}')

  try:
    import matplotlib
    matplotlib.use('Agg')
    ax = drawn.plot(plane='yz', maxRays=150)
    ax.figure.savefig(os.path.join(out, 'lens-mirror-rays.png'), dpi=130,
                      bbox_inches='tight')
    print('matplotlib preview saved to lens-mirror-rays.png')
  except ImportError:
    print('matplotlib not available; skipped the preview render')
  return drawn, ply, seconds


if __name__ == '__main__':
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[1])
  parser.add_argument('--device', default='cuda')
  parser.add_argument('--out', default=None)
  args = parser.parse_args()
  main(args.device, args.out)
