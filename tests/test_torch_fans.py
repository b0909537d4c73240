'''Ray fans and hit metadata (ROADMAP A.10a): the port's
`generateRays('fans')` of a point and a surface source against the JAX
package's, a fan run's stored hits and metadata columns against the JAX
package's run ray by ray, `Hits.fanEstimatedPowerDensities` of both, the
host-side random-variable helpers (`findGrid`, `drawPseudo`,
`SampledVectorRandomVariable`), and a Monte-Carlo run storing StoreHit*
columns.'''

import importlib.util
import os

import numpy as np
import pytest
import torch

import torch_port_helpers as H

torch.set_num_threads(1)

_EXAMPLE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'examples', 'torch_1_source_and_detector.py')


def _example1():
  spec = importlib.util.spec_from_file_location('torch_example1', _EXAMPLE)
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod


@pytest.fixture(scope='module')
def fanRuns(tmp_path_factory):
  '''examples/1's scene in both packages and one 'fans' run of each.'''
  from optics_design_workbench_tpu import simulation as jaxSim
  from optics_design_workbench_tpu.jupyter_utils import RawFolder as JRaw
  from optics_design_workbench_tpu_torch import simulation as torchSim
  from optics_design_workbench_tpu_torch.jupyter_utils import RawFolder
  base = tmp_path_factory.mktemp('fans')
  port = _example1().buildScene(path=str(base / 'port'))
  ref = H.jaxSceneFromPort(port)
  ref.path = str(base / 'ref')
  portRun = RawFolder(torchSim.runSimulation(port, 'fans', seed=1,
                                             device='cpu'))
  refRun = JRaw(jaxSim.runSimulation(ref, 'fans', seed=1))
  return port, ref, portRun.loadHits('Detector'), refRun.loadHits('Detector')


def _sameBatch(a, b, metaKeys):
  np.testing.assert_allclose(a['origins'], b['origins'], atol=1e-9)
  np.testing.assert_allclose(a['directions'], b['directions'], atol=1e-12)
  np.testing.assert_array_equal(a['wavelengths'], b['wavelengths'])
  for k in metaKeys:
    np.testing.assert_array_equal(np.asarray(a['metadata'][k]),
                                  np.asarray(b['metadata'][k]), err_msg=k)


def test_point_source_fans_equal_reference(fanRuns):
  port, ref, _p, _r = fanRuns
  a = port.lightSources()[0].generateRays('fans')
  b = ref.lightSources()[0].generateRays('fans')
  assert len(a['origins']) == 42
  keys = ('fanIndex', 'rayIndex', 'totalFanCount', 'totalRaysInFan',
          'initPhi', 'initTheta', 'initRadius')
  _sameBatch(a, b, keys)
  # a worker's strided share of the fans, as the reference's runner slices
  from optics_design_workbench_tpu.simulation import runner as JR
  from optics_design_workbench_tpu_torch.simulation import runner as TR
  _sameBatch(TR._sliceBatch(a, 1, 3), JR._sliceBatch(b, 1, 3), keys)


def test_surface_source_fans_and_host_draws_equal_reference():
  ns = {'port': H.torchNs(), 'ref': H.jaxNs()}
  scenes = {k: v.benchmarks.buildSurfaceSourceScene() for k, v in ns.items()}
  srcs = {k: s.lightSources()[0] for k, s in scenes.items()}
  for s in srcs.values():
    s.FanModeRayCount = 60
  a, b = srcs['port'].generateRays('fans'), srcs['ref'].generateRays('fans')
  assert len(a['origins']) > 20
  _sameBatch(a, b, ('initTheta', 'initPhi'))
  for mode in ('true', 'pseudo'):
    a = srcs['port'].generateRays(mode, rng=np.random.default_rng(3))
    b = srcs['ref'].generateRays(mode, rng=np.random.default_rng(3))
    _sameBatch(a, b, ('initTheta', 'initPhi'))


def _byRay(hits):
  order = np.lexsort((np.asarray(hits['rayIndex']),
                      np.asarray(hits['fanIndex'])))
  n = len(order)
  return {k: np.asarray(v)[order] for k, v in hits.hits.items()
          if np.ndim(v) and len(v) == n}


def test_fan_run_hits_and_metadata_equal_reference(fanRuns):
  _port, _ref, portHits, refHits = fanRuns
  a, b = _byRay(portHits), _byRay(refHits)
  assert 30 < len(a['points']) == len(b['points'])
  assert set(a) == set(b)
  for k in ('fanIndex', 'rayIndex', 'totalFanCount', 'totalRaysInFan',
            'isEntering'):
    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
  # examples/1 enables the four fan columns only
  assert {'fanIndex', 'rayIndex', 'totalFanCount', 'totalRaysInFan'} \
      <= set(a) and 'initTheta' not in a
  np.testing.assert_allclose(a['points'], b['points'], atol=1e-4)
  np.testing.assert_allclose(a['directions'], b['directions'], atol=1e-6)
  np.testing.assert_allclose(a['powers'], b['powers'], rtol=1e-5)


def test_fan_power_densities_equal_reference(fanRuns):
  _port, _ref, portHits, refHits = fanRuns
  a = portHits.fanEstimatedPowerDensities()
  b = refHits.fanEstimatedPowerDensities()
  assert sorted(a) == sorted(b) and len(a) == 2
  for fan in a:
    for x, y in zip(a[fan], b[fan]):
      np.testing.assert_allclose(np.asarray(x, float), np.asarray(y, float),
                                 rtol=1e-3, atol=1e-6)


def test_random_variable_host_helpers_equal_reference():
  from optics_design_workbench_tpu.distributions import (
      ScalarRandomVariable as JS, SampledVectorRandomVariable as JSV)
  from optics_design_workbench_tpu_torch.distributions import (
      ScalarRandomVariable as TS, SampledVectorRandomVariable as TSV)
  args = ('exp(-theta**2/0.02)', (0., 0.3))
  grids = [cls(*args, variable='theta').findGrid(N=15) for cls in (TS, JS)]
  np.testing.assert_allclose(grids[0], grids[1], rtol=1e-12)
  draws = [cls(*args, variable='theta').drawPseudo(
      N=64, rng=np.random.default_rng(2)) for cls in (TS, JS)]
  np.testing.assert_allclose(draws[0], draws[1], rtol=1e-9)
  ranges = [np.linspace(0., 1., 9), np.linspace(-1., 1., 5)]
  probs = np.random.default_rng(1).random((9, 5))
  samples = [cls(ranges, probs).draw(N=100, rng=np.random.default_rng(5))
             for cls in (TSV, JSV)]
  np.testing.assert_allclose(samples[0], samples[1], rtol=1e-9)


def test_metadata_run_stores_enabled_columns(tmp_path):
  '''examples/1's Monte-Carlo settings cut to 2 x 4096 rays: the raw-record
  kernel (plain version) traces the device generator's columns and every
  hit carries the enabled StoreHit* columns of its ray that the source
  produces (InitTheta, InitPhi), as the JAX package's record path does.'''
  from optics_design_workbench_tpu_torch import simulation as torchSim
  from optics_design_workbench_tpu_torch.jupyter_utils import RawFolder
  from optics_design_workbench_tpu_torch.ops import cuda_trace
  scene = _example1().buildScene(path=str(tmp_path / 'mc'))
  settings = scene.activeSimulationSettings()
  settings.RaysPerIteration, settings.EndAfterRays = 4096, 8192
  settings.StoreHitInitTheta = settings.StoreHitInitPhi = True
  calls = []
  traceRaw = cuda_trace.traceRaw

  def counted(*a, **k):
    calls.append(k.get('columns') is not None)
    return traceRaw(*a, **k)

  cuda_trace.traceRaw = counted
  try:
    run = torchSim.runSimulation(scene, 'true', seed=3, device='cpu')
  finally:
    cuda_trace.traceRaw = traceRaw
  assert calls == [True, True]
  hits = RawFolder(run).loadHits('Detector').hits
  assert {'initTheta', 'initPhi'} <= set(hits)
  assert 'fanIndex' not in hits and 'initRadius' not in hits
  n = len(hits['points'])
  assert n > 0.9 * 8192
  # each hit's (unchanged) direction: theta is its angle to the axis
  d = np.asarray(hits['directions'], float)
  np.testing.assert_allclose(np.hypot(d[:, 0], d[:, 1]),
                             np.sin(hits['initTheta']), atol=1e-6)
