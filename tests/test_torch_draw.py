'''Ray polylines and drawing (ROADMAP A.10b): the port's `recordsToRays`,
`DrawnRays` and `writeScenePLY` against the JAX package's on the same
records and scene, a `draw=` run and a RecordRays run through
`runSimulation`, and `RawFolder.loadRays` / `drawnRays` reading them.'''

import os

import numpy as np
import pytest
import torch

import torch_port_helpers as H

torch.set_num_threads(1)


@pytest.fixture(scope='module')
def lensRecords():
  '''The lens-and-mirror scene (port and JAX twin) and both record
  tracers' records of the same 256 rays.'''
  from optics_design_workbench_tpu_torch import benchmarks as B
  port = B.buildLensMirrorScene()
  for g in port.opticalObjects():
    if g.OpticalType == 'Mirror':
      g.ViewColor, g.ViewColorWeight = (0., 0.8, 0.8), 0.8
  ref = H.jaxSceneFromPort(port)
  rj, rt, _dev = H.recordTraceBoth(lambda: (ref, None, 6), n=256)
  return port, ref, rj, rt


def test_records_to_rays_equal_reference(lensRecords):
  from optics_design_workbench_tpu.simulation import runner as JR
  from optics_design_workbench_tpu_torch.simulation import runner as TR
  port, ref, rj, rt = lensRecords
  labels = port.compile(device=None)[1]['elementLabels']
  a = TR.recordsToRays({k: torch.as_tensor(v) for k, v in rt.items()},
                       labels)
  b = JR.recordsToRays(rj, labels)
  np.testing.assert_array_equal(a['offsets'], b['offsets'])
  np.testing.assert_array_equal(a['media'], b['media'])
  np.testing.assert_allclose(a['powers'], b['powers'], rtol=1e-5)
  d = np.abs(a['points'] - b['points']).max(-1)
  # polyline vertices at hit points within 1e-4 mm, escape ends (1000 mm
  # away) within two float32 ulps
  assert (d <= np.maximum(1e-4, 2.5e-7 * np.abs(b['points']).max(-1))).all()


def test_drawn_rays_and_ply_equal_reference(lensRecords, tmp_path):
  from optics_design_workbench_tpu.geometry.tessellate import \
      writeScenePLY as jaxPLY
  from optics_design_workbench_tpu.simulation import draw as JD
  from optics_design_workbench_tpu_torch.geometry.tessellate import \
      writeScenePLY as portPLY
  from optics_design_workbench_tpu_torch.simulation import draw as TD
  from optics_design_workbench_tpu_torch.tracing import tracer as TT
  port, ref, rj, _rt = lensRecords
  drawn = {}
  for name, mod, scene, records in (
      ('port', TD, port, {k: torch.as_tensor(v) for k, v in rj.items()}),
      ('ref', JD, ref, rj)):
    d = mod.DrawnRays()
    d.add(records, sourceLabel='Source', **mod.sceneDrawParams(scene))
    drawn[name] = d
  a, b = drawn['port'], drawn['ref']
  assert a.segmentCount == TT.totalSegments(
      {k: torch.as_tensor(v) for k, v in rj.items()}) == b.segmentCount
  for k in ('points', 'offsets', 'colors', 'powers', 'sourceIdx'):
    np.testing.assert_array_equal(getattr(a, k), getattr(b, k), err_msg=k)
  a.writePLY(str(tmp_path / 'a.ply'))
  b.writePLY(str(tmp_path / 'b.ply'))
  assert open(tmp_path / 'a.ply').read() == open(tmp_path / 'b.ply').read()
  pa = portPLY(port, str(tmp_path / 'sa.ply'), resolution=24, drawnRays=a)
  pb = jaxPLY(ref, str(tmp_path / 'sb.ply'), resolution=24, drawnRays=b)
  assert open(pa).read() == open(pb).read()


def test_draw_and_record_rays_runs(tmp_path):
  '''`draw=` on a single-shot run and RecordRays on a stored run take the
  record tracer: the drawn rays land in the run folder, the polylines in
  its ray files, and `RawFolder` reads both back.'''
  from optics_design_workbench_tpu_torch import benchmarks as B
  from optics_design_workbench_tpu_torch import simulation as torchSim
  from optics_design_workbench_tpu_torch.jupyter_utils import RawFolder
  from optics_design_workbench_tpu_torch.simulation.draw import DrawnRays
  scene = B.buildLensMirrorScene(tmpdir=str(tmp_path))
  scene.getObject('SimulationSettings').RaysPerIteration = 300
  drawn = DrawnRays()
  run = torchSim.runSimulation(scene, 'singletrue', draw=drawn, seed=1,
                               store=False, device='cpu')
  assert drawn.rayCount == 300 and drawn.segmentCount > 3 * 300
  back = RawFolder(run).drawnRays()
  assert back.segmentCount == drawn.segmentCount
  assert os.path.exists(os.path.join(run, 'drawn-rays.ply'))
  scene.lightSources()[0].RecordRays = True
  run = torchSim.runSimulation(scene, 'singletrue', seed=2, store=True,
                               device='cpu')
  rays = RawFolder(run).loadRays()
  assert len(rays) == 300
  for r in rays:
    assert len(r['points']) == len(r['powers']) + 1 == len(r['media']) + 1
  assert len(RawFolder(run).loadHits('Detector')) > 0
