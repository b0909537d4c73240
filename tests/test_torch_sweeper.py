'''The PyTorch port's `jupyter_utils.ParameterSweeper` on the CPU
(`device='cpu'`: the kernels' plain versions), against the JAX package's.

Tolerances:
  * `evaluateBatched` in both packages on the reference suite's two cases
    (lens-radius sweep, source-placement sweep; 20,000 rays per variant,
    bins (64, 64)): the two packages draw different random numbers, so the
    comparison is statistical — same argmin, each variant's spot second
    moment within 15 % + 0.5 bins^2, its centre of mass within 1 bin;
  * the same seed twice in the port: identical counts, bin for bin;
  * `optimize` / `sweep`: the rows `RawFolder.loadHits` reads back equal the
    run's `totalRecordedHits`; the best penalty is no worse than the first.
'''

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (both frameworks live in this process)

import torch_port_helpers as H
from optics_design_workbench_tpu.jupyter_utils import (
    ParameterSweeper as RefSweeper, Parameter as RefParameter)
from optics_design_workbench_tpu_torch.jupyter_utils import (
    ParameterSweeper, Parameter, MetaParameter, RawFolder)
from optics_design_workbench_tpu_torch import KernelError
from optics_design_workbench_tpu_torch.ops import cuda_trace

torch.set_num_threads(1)

RAYS = 20000
BINS = (64, 64)
BOUNDS = (-40., 40., -40., 40.)
RADII = [50., 60., 75., 90.]
OFFSETS = [-20., 0., 20.]


def _moments(counts):
  H_ = counts[0]
  n = H_.sum()
  ys, xs = np.indices(H_.shape)
  cy, cx = (H_ * ys).sum() / n, (H_ * xs).sum() / n
  return dict(n=float(n), cy=float(cy), cx=float(cx),
              m2=float((H_ * ((ys - cy) ** 2 + (xs - cx) ** 2)).sum() / n))


def _runBatched(ns, Sweeper, Param, case, tmp, seed=0, **sweeperKw):
  '''evaluateBatched on one of the two cases; returns (metrics, [moments of
  each variant's count histogram], sweeper).'''
  holder, seen = {}, []
  if case == 'radius':
    def setter(r):
      holder['scene'] = H.buildDocScene(ns, str(tmp / 'doc1'), float(r))
    values, name = RADII, 'R'
    first = H.buildDocScene(ns, str(tmp / 'doc1'))
    maxI = 6
  else:
    def setter(x):
      holder['scene'] = H.buildSourceSweepScene(ns, str(tmp / 'srcsweep'),
                                                float(x))
    values, name = OFFSETS, 'x'
    setter(0.)
    first = holder['scene']
    maxI = 4
  sweeper = Sweeper(
      lambda sc: {name: Param(getter=lambda: 0., setter=setter)},
      scene=first, **sweeperKw)

  def metric(power, counts):
    seen.append(_moments(np.asarray(counts)))
    return seen[-1]['m2'] if case == 'radius' else seen[-1]['cx']

  metrics = sweeper.evaluateBatched(
      [{name: v} for v in values], metric,
      sceneFactory=lambda: holder['scene'], raysPerScene=RAYS,
      maxIntersections=maxI, bins=BINS, histBounds=BOUNDS, seed=seed)
  return np.asarray(metrics), seen, sweeper


@pytest.fixture(scope='module', params=('radius', 'placement'))
def batchedCase(request, tmp_path_factory):
  tmp = tmp_path_factory.mktemp('batched')
  case = request.param
  ref = _runBatched(H.jaxNs(), RefSweeper, RefParameter, case, tmp)
  port = _runBatched(H.torchNs(), ParameterSweeper, Parameter, case, tmp,
                     device='cpu')
  again = _runBatched(H.torchNs(), ParameterSweeper, Parameter, case, tmp,
                      device='cpu')
  return dict(case=case, ref=ref, port=port, again=again)


def test_evaluate_batched_same_argmin_and_moments(batchedCase):
  '''(e) both packages rank the variants alike and see the same spots.'''
  (mRef, seenRef, _s), (mPort, seenPort, sweeper) = (batchedCase['ref'],
                                                     batchedCase['port'])
  assert mPort.shape == mRef.shape and np.all(np.isfinite(mPort))
  assert sweeper.lastBatchedRoute == 'sweep'
  if batchedCase['case'] == 'radius':
    assert int(np.argmin(mPort)) == int(np.argmin(mRef))
    assert int(np.argmin(mPort)) in (0, 1)
  for a, b in zip(seenPort, seenRef):
    # the +-40 mm bounds clip the placement sweep's 48 mm beam
    assert a['n'] > 0.85 * RAYS and abs(a['n'] - b['n']) < 0.02 * RAYS
    assert abs(a['m2'] - b['m2']) <= 0.15 * b['m2'] + 0.5, (a, b)
    assert abs(a['cx'] - b['cx']) <= 1. and abs(a['cy'] - b['cy']) <= 1.
  if batchedCase['case'] == 'placement':
    # bin index of world x on the 80-wide detector: (x + 40) / 80 * 64
    for got, x in zip(mPort, OFFSETS):
      assert abs(got - (x + 40.) / 80. * 64.) < 5.


def test_evaluate_batched_is_repeatable(batchedCase):
  '''(e) the same seed twice: identical histograms, hence metrics.'''
  np.testing.assert_array_equal(batchedCase['port'][0],
                                batchedCase['again'][0])
  assert batchedCase['port'][1] == batchedCase['again'][1]


def test_source_sampling_sweep_takes_the_per_variant_route(tmp_path):
  '''(g) sources that differ beyond placement and wavelength cannot share
  one sampler: one launch of the single-scene kernel per variant, each with
  its own sampler, and the results show each variant's own source.'''
  holder = {}

  def setWidth(w):
    scene = H.buildSourceSweepScene(H.torchNs(), str(tmp_path / 's'))
    scene.getObject('Source').PowerDensity = f'exp(-theta^2/{w})'
    holder['scene'] = scene

  setWidth(0.02)
  sweeper = ParameterSweeper(
      lambda sc: dict(w=Parameter(getter=lambda: 0., setter=setWidth)),
      scene=holder['scene'], device='cpu')
  widths = [0.002, 0.02]
  m = sweeper.evaluateBatched(
      [dict(w=w) for w in widths], H.spotMetric,
      sceneFactory=lambda: holder['scene'], raysPerScene=4000,
      maxIntersections=4, bins=BINS, histBounds=(-80., 80., -80., 80.))
  assert sweeper.lastBatchedRoute == 'perVariant'
  assert m[0] < 0.5 * m[1]            # the narrow beam makes the small spot


def test_unported_scene_and_parallel_raise_by_name(tmp_path):
  '''(g) what is not ported says so, with its ROADMAP item; a scene the
  kernels refuse is swept through the fused step's twin.'''
  ns = H.torchNs()
  scene = H.buildDocScene(ns, str(tmp_path / 'doc1'))
  sweeper = ParameterSweeper(
      lambda sc: dict(n=(sc.getObject('Lens'), 'RefractiveIndex')),
      scene=scene, device='cpu')
  with pytest.raises(NotImplementedError, match='ROADMAP item A.10'):
    sweeper.optimizeStrategyStep([dict(minimizeFunc=H.spotSize,
                                       parameters=['n'])], parallel=True)
  assert sweeper.optimizeStrategyStep([]) == []
  # a dispersive n(wavelength) that no in-kernel polynomial fits: the
  # kernels refuse the scene, and each variant goes through the fused
  # step's twin
  scene.getObject('Detector').RefractiveIndex = '1.5 + 0.01*sin(wavelength/10)'
  m = sweeper.evaluateBatched([dict(n=1.4), dict(n=1.6)], H.spotMetric,
                              raysPerScene=256)
  assert sweeper.lastBatchedRoute == 'perVariantTracer'
  assert m.shape == (2,) and np.isfinite(m).all() and m.min() > 0, m
  with pytest.raises(RuntimeError, match='no CUDA device'):
    ParameterSweeper(lambda sc: dict(n=(sc.getObject('Lens'),
                                        'RefractiveIndex')),
                     scene=H.buildDocScene(ns, str(tmp_path / 'doc2'))) \
        .evaluateBatched([dict(n=1.4), dict(n=1.6)], H.spotMetric,
                         raysPerScene=256)


def test_swept_index_rides_one_launch_with_shared_scene(tmp_path):
  '''A parameter that is an attribute of the sweeper's own scene (no
  sceneFactory): the refractive index changes an element row, which is data
  of the stacked table.'''
  scene = H.buildDocScene(H.torchNs(), str(tmp_path / 'doc1'))
  sweeper = ParameterSweeper(
      lambda sc: dict(n=(sc.getObject('Lens'), 'RefractiveIndex')),
      scene=scene, device='cpu')
  before = dict(cuda_trace.launchCounts)
  m = sweeper.evaluateBatched([dict(n=v) for v in (1.3, 1.5, 1.7)],
                              H.spotMetric, raysPerScene=4000,
                              maxIntersections=6, bins=BINS,
                              histBounds=BOUNDS)
  assert sweeper.lastBatchedRoute == 'sweep'
  assert cuda_trace.launchCounts == before      # CPU: plain version only
  assert m[0] > m[1] > m[2]       # a stronger lens gathers the cone tighter


class TestParameters:

  def _sweeper(self, tmp_path):
    scene = H.buildDocScene(H.torchNs(), str(tmp_path / 'doc1'))
    applied = []
    meta = MetaParameter(['a', 'b'], lambda d: applied.append(d))
    sweeper = ParameterSweeper(
        lambda sc: dict(wavelength=(sc.getObject('Source'), 'Wavelength'),
                        a=meta, b=meta),
        scene=scene, device='cpu')
    return sweeper, scene, applied

  def test_set_get_bounds(self, tmp_path):
    sweeper, scene, _applied = self._sweeper(tmp_path)
    assert sweeper.parameterNames() == ['wavelength', 'a', 'b']
    sweeper.setBounds(wavelength=(400., 700.))
    assert sweeper.bounds('wavelength') == (400., 700.)
    assert sweeper.bounds() == dict(wavelength=(400., 700.))
    assert sweeper.set(wavelength=900.)['wavelength'] == 700.    # clamped
    assert sweeper.get('wavelength') == 700.
    assert scene.getObject('Source').Wavelength == 700.

  def test_meta_parameter_applies_once_all_siblings_are_set(self, tmp_path):
    sweeper, _scene, applied = self._sweeper(tmp_path)
    sweeper.set(a=1.)
    assert applied == []
    sweeper.set(b=2.)
    assert applied == [dict(a=1., b=2.)]

  def test_parameter_node_forms(self):
    box = dict(v=1.)
    p = Parameter(getter=lambda: box['v'],
                  setter=lambda v: box.__setitem__('v', v), bounds=(0., 2.))
    assert p.set(5.) == 2. and box['v'] == 2.
    with pytest.raises(ValueError):
      Parameter()
    with pytest.raises(ValueError, match='getParametersFunc'):
      ParameterSweeper(scene=None).parameters()


@pytest.fixture()
def zSweeper(tmp_path):
  '''The reference suite's optimisation case: move the detector along z to
  minimise the spot (3,000 rays per evaluation).'''
  ns = H.torchNs()
  scene = H.buildDocScene(ns, str(tmp_path / 'doc1'))
  settings = scene.activeSimulationSettings()
  settings.EndAfterRays, settings.RaysPerIteration = '3000', 3000
  det = scene.getObject('Detector')
  sweeper = ParameterSweeper(
      lambda sc: dict(z=Parameter(
          getter=lambda: det.placements[0][2, 3],
          setter=lambda z: setattr(det, 'placements',
                                   [ns.T.translation(0, 0, float(z))]),
          bounds=(80., 200.))),
      scene=scene, device='cpu')
  return sweeper


def test_optimize_finds_focus(zSweeper):
  '''(f) `optimize` through `runSimulation` and `RawFolder.loadHits`.'''
  runs = []

  def spotSize(raw):
    runs.append(raw)
    return H.spotSize(raw)

  result = zSweeper.optimize(spotSize, ['z'], method='Nelder-Mead',
                             maxIterations=12, seed=3)
  history = zSweeper.history
  assert result.bestPenalty < history[0]['penalty'] * 1.01
  assert result.bestPenalty == min(h['penalty'] for h in history)
  assert len(history) >= 5 and len(runs) == len(history)
  assert zSweeper.get('z') == result.bestParams['z']     # best restored
  for raw in runs:
    assert isinstance(raw, RawFolder) and raw.exists() and raw.uid()
    assert len(raw.loadHits('Detector')) \
        == raw.progress()['totalRecordedHits'] > 2500


def test_optimize_needs_bounds_and_scores_failures(zSweeper):
  zSweeper.parameters()['z'].bounds = None
  with pytest.raises(ValueError, match='needs bounds'):
    zSweeper.optimize(H.spotSize, ['z'])
  zSweeper.setBounds(z=(80., 200.))

  def broken(raw):
    raise RuntimeError('no metric today')

  result = zSweeper.optimize(broken, ['z'], maxIterations=1, seed=1,
                             retries=0)
  assert result.bestPenalty == 1e99


@pytest.mark.parametrize('error', [KernelError, NotImplementedError])
def test_optimize_raises_what_is_no_designs_fault(zSweeper, error):
  '''A kernel that does not build or launch, and a scene that is not ported,
  are never scored as a penalty: `optimize` and `optimizeStrategyStep` let
  them through, without retries.'''
  calls = []

  def broken(raw):
    calls.append(raw)
    raise error('not a design point')

  with pytest.raises(error, match='not a design point'):
    zSweeper.optimize(broken, ['z'], maxIterations=3, seed=1, retries=2)
  assert len(calls) == 1 and zSweeper.history == []
  with pytest.raises(error, match='not a design point'):
    zSweeper.optimizeStrategyStep(
        [dict(minimizeFunc=broken, parameters=['z'], maxIterations=1)])
  assert len(calls) == 2


def test_optimize_without_a_card_raises(zSweeper):
  '''`device='cuda'` with no card: the first evaluation raises, nothing
  carries on as a row of penalties.'''
  if torch.cuda.is_available():
    pytest.skip('this machine has a card')
  zSweeper.device = 'cuda'
  with pytest.raises(KernelError, match='no CUDA device'):
    zSweeper.optimize(H.spotSize, ['z'], maxIterations=2, seed=1)
  assert zSweeper.history == []


def test_sweep_runs_one_simulation_per_combination(zSweeper):
  '''(f) `sweep`: zipped value lists, one run folder each.'''
  out = zSweeper.sweep(dict(z=[140., 160., 180.]), H.spotSize, seed=5)
  assert [p['z'] for p, _pen, _path in out] == [140., 160., 180.]
  assert len({path for _p, _pen, path in out}) == 3
  for _params, penalty, path in out:
    raw = RawFolder(path)
    assert len(raw.loadHits('Detector')) \
        == raw.progress()['totalRecordedHits']
    assert penalty == H.spotSize(raw)
  assert len(zSweeper.history) == 3
  with pytest.raises(ValueError, match='equal length'):
    zSweeper.sweep(dict(z=[1., 2.], w=[1.]), H.spotSize)


def test_strategy_step_runs_in_process_and_inherits(zSweeper):
  results = zSweeper.optimizeStrategyStep(
      [dict(minimizeFunc=H.spotSize, parameters=['z'], maxIterations=2,
            seed=2), dict(method='Powell')], parallel='auto')
  assert len(results) == 2 and all(r is not None for r in results)
  assert zSweeper.get('z') == zSweeper._bestParams['z']


def test_source_parameter_of_the_shared_scene_is_read_per_variant(tmp_path):
  '''A sweep that moves the source of the sweeper's OWN scene (one source
  object, changed from variant to variant): each variant keeps the
  placement it was compiled with.'''
  scene = H.buildSourceSweepScene(H.torchNs(), str(tmp_path / 's'))
  src = scene.getObject('Source')
  sweeper = ParameterSweeper(
      lambda sc: dict(x=Parameter(
          getter=lambda: src.placement[0, 3],
          setter=lambda x: src.placement.__setitem__((0, 3), float(x)))),
      scene=scene, device='cpu')
  m = sweeper.evaluateBatched([dict(x=x) for x in OFFSETS], H.centreOfMassX,
                              raysPerScene=4000, maxIntersections=4,
                              bins=BINS, histBounds=BOUNDS)
  assert sweeper.lastBatchedRoute == 'sweep'
  for got, x in zip(m, OFFSETS):
    assert abs(got - (x + 40.) / 80. * 64.) < 5., m
