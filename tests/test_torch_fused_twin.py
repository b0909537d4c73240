'''The fused step's twin (tracing/fused.traceHistogram / makeFusedStep,
plain PyTorch over the record tracer's bounce) against the JAX package's
XLA fused step (`fused.traceHistogram`) on the same compiled scenes and the
same ray columns: counters equal, counts equal up to 2 rays changing bins,
power per bin within rtol 1e-4; the fixed trip count and a split into ray
chunks give the same histograms; the scatter gather path by distribution.
Also the per-ray bounce (`tracer.bounceOne`) against the JAX package's and
against the port's batched bounce, and the entry points that route to the
twin on the CPU (`runSimulation(recording='histogram')`, `evaluateBatched`,
`makeBenchStep`).'''

import numpy as np
import pytest
import torch

import torch_port_helpers as H
from test_torch_record_tracer import _roughScatterScene, assertRecordsMatch

torch.set_num_threads(1)

N = 8192
BINS = (64, 64)
MAX_RAY_LENGTH = H.MAX_RAY_LENGTH
DIST_TOL = H.DIST_TOL
DISH_BOUNDS = (-200., 200., -200., 200.)


def _portSequentialDish():
  '''The reference's 200-triangle dish (the port's
  `benchmarks.buildMeshDishScene`) under sequential mode (stages [Dish],
  [Det]): past 128 triangles the kernels refuse it.'''
  from optics_design_workbench_tpu_torch import benchmarks
  scene = benchmarks.buildMeshDishScene()
  settings = scene.activeSimulationSettings()
  settings.SequentialMode = True
  settings.SequentialModeElements = [['Dish'], ['Det']]
  return scene, DISH_BOUNDS, 3


def _jaxSequentialDish():
  scene, bounds, maxI = _portSequentialDish()
  return H.jaxSceneFromPort(scene), bounds, maxI


# name -> JAX scene factory returning (scene, bounds, maxIntersections)
SCENES = {
    'lensMirror': lambda: H.buildBench(H.jaxNs(), 'lensMirror'),
    'sequentialBall': lambda: H.buildSequentialBallScene(H.jaxNs()),
    'dispersiveLens': lambda: H.buildDispersiveLensMirrorScene(H.jaxNs()),
    'sequentialDish': _jaxSequentialDish,
}


def _hostRays(src, n, seed):
  '''(origins, directions, powers, wavelengths) float32 numpy of `n` rays
  of the JAX point source `src` at (theta or radius, phi) drawn uniformly
  over its domains (its distribution's compile does not matter here).'''
  rng = np.random.default_rng(seed)
  first = (src.parsedThetaDomain() if np.isfinite(src.focalLength())
           else src.parsedRadiusDomain())
  b = src.makeRaysHost(rng.uniform(*first, n),
                       rng.uniform(*src.parsedPhiDomain(), n))
  return [np.asarray(b[k], np.float32)
          for k in ('origins', 'directions', 'powers', 'wavelengths')]


def _jaxScene(deviceNp):
  import jax
  import jax.numpy as jnp
  devJ = jax.tree_util.tree_map(jnp.asarray, {
      k: v for k, v in deviceNp.items() if k != 'powerTol'})
  devJ['powerTol'] = 1e-6
  return devJ


def _jaxHistogram(deviceNp, info, bounds, cols, maxI, bins=BINS, key=None):
  from optics_design_workbench_tpu.tracing import fused as JF
  import jax.numpy as jnp
  devJ = _jaxScene(deviceNp)
  spec = JF.makeHistogramSpec(devJ, info, bounds=bounds, bins=bins)
  hist, c = JF.traceHistogram(
      devJ, spec, JF.initHistograms(spec), *map(jnp.asarray, cols),
      maxIntersections=maxI, maxRayLength=MAX_RAY_LENGTH, distTol=DIST_TOL,
      scatterKey=key)
  return ({k: np.asarray(v) for k, v in hist.items()},
          {k: int(v) for k, v in c.items()})


def _twin(deviceNp, info, bounds, cols, maxI, bins=BINS, **kw):
  from optics_design_workbench_tpu_torch import convert
  from optics_design_workbench_tpu_torch.tracing import fused as TF
  prepared = convert.recordSceneFromReference(deviceNp, 'cpu')
  spec = TF.makeHistogramSpec(deviceNp, info, bounds=bounds, bins=bins)
  hist, c = TF.traceHistogram(
      prepared, spec, TF.initHistograms(spec, device='cpu'),
      *map(torch.as_tensor, cols), maxI, MAX_RAY_LENGTH, DIST_TOL, **kw)
  # every hit is binned; the counter is there as in the kernels' steps
  assert int(c.pop('hitOverflow')) == 0
  return ({k: v.numpy() for k, v in hist.items()},
          {k: int(v) for k, v in c.items()})


@pytest.fixture(scope='module', params=sorted(SCENES))
def case(request):
  scene, bounds, maxI = SCENES[request.param]()
  deviceNp, info = scene.compile(devicePut=False)
  deviceNp['powerTol'] = 1e-6
  cols = _hostRays(scene.lightSources()[0], N, seed=5)
  return dict(name=request.param, deviceNp=deviceNp, info=info,
              bounds=bounds, maxI=maxI, cols=cols,
              ref=_jaxHistogram(deviceNp, info, bounds, cols, maxI),
              twin=_twin(deviceNp, info, bounds, cols, maxI))


def assertHistogramsAgree(a, b, rtol=1e-4):
  (ha, ca), (hb, cb) = a, b
  assert ca == cb, (ca, cb)
  assert H.nearlyEqualCounts(ha['counts'], hb['counts']), \
      np.abs(ha['counts'] - hb['counts']).sum()
  same = ha['counts'] == hb['counts']
  np.testing.assert_allclose(ha['power'][same], hb['power'][same],
                             rtol=rtol, atol=1e-6)


def test_twin_matches_reference_fused_step(case):
  from optics_design_workbench_tpu_torch import convert
  from optics_design_workbench_tpu_torch.ops import cuda_trace
  port, _spec = convert._sceneAndSpec(case['deviceNp'], dict(
      elemToDet=np.zeros(1, np.int32), bounds=np.zeros((1, 4)), bins=(1, 1)))
  refused = cuda_trace.ineligibleReason(port)
  assert (refused is not None) == (case['name'] == 'sequentialDish'), refused
  assert case['ref'][1]['hits'] > 0.3 * N, case['ref'][1]
  assertHistogramsAgree(case['ref'], case['twin'])


def test_fixed_trip_count_equals_early_exit(case):
  fixed = _twin(case['deviceNp'], case['info'], case['bounds'], case['cols'],
                case['maxI'], earlyExit=False)
  assertHistogramsAgree(case['twin'], fixed, rtol=1e-6)


def test_ray_chunks_give_the_same_histograms(case):
  from optics_design_workbench_tpu_torch.tracing import fused as TF
  spec = TF.makeHistogramSpec(case['deviceNp'], case['info'],
                              bounds=case['bounds'], bins=BINS)
  names = ('ox', 'oy', 'oz', 'dx', 'dy', 'dz')
  o, d, pw, wl = map(torch.as_tensor, case['cols'])
  cols = dict(zip(names, list(o.T) + list(d.T)), pw=pw, wl=wl)
  nSurf = len(case['deviceNp']['surfaces']['packed'])
  out = []
  for limit in (1 << 26, nSurf * N // 4):
    step = TF.makeFusedStep(case['deviceNp'],
                            lambda gen, n, stratified=False: (cols, {}),
                            spec, N, case['maxI'], MAX_RAY_LENGTH, DIST_TOL,
                            chunkLimit=limit, device='cpu')
    hist, c = step(0, TF.initHistograms(spec, device='cpu'))
    assert int(c.pop('hitOverflow')) == 0
    out.append(({k: v.numpy() for k, v in hist.items()},
                {k: int(v) for k, v in c.items()}, step.chunks))
  assert (out[0][2], out[1][2]) == (1, 4)
  assertHistogramsAgree(out[0][:2], case['twin'], rtol=1e-6)
  assertHistogramsAgree(out[1][:2], case['twin'], rtol=1e-6)


def test_static_flags_skip_only_what_the_scene_lacks(case):
  '''A bounce reads the elements' types that `prepareScene` keeps on the
  host and skips the grating formulas of a scene without a grating: it
  records what the bounce records with them (the same scene with its
  types marked as gratings).'''
  from optics_design_workbench_tpu_torch import convert
  from optics_design_workbench_tpu_torch.tracing import batch_tracer as TB
  from optics_design_workbench_tpu_torch.tracing.element_table import GRATING
  prepared = convert.recordSceneFromReference(case['deviceNp'], 'cpu')
  types = prepared['elements']['_hostOptType']
  assert not (types == GRATING).any()
  marked = dict(prepared, elements=dict(
      prepared['elements'], _hostOptType=np.full_like(types, GRATING)))
  o, d, pw, wl = (torch.as_tensor(x[:512]) for x in case['cols'])
  n = len(pw)
  state = (o, d, pw, wl, torch.full((n,), -1), torch.zeros_like(
      torch.full((n,), -1)), torch.ones(n, dtype=bool))
  calls = []
  grating = TB._gratingDirections

  def counted(*args):
    calls.append(1)
    return grating(*args)

  TB._gratingDirections = counted
  try:
    full = TB.bounceBatch(marked, DIST_TOL, MAX_RAY_LENGTH, *state)
    skipped = TB.bounceBatch(prepared, DIST_TOL, MAX_RAY_LENGTH, *state)
  finally:
    TB._gratingDirections = grating
  assert calls == [1]
  for a, b in zip(full[0], skipped[0]):
    torch.testing.assert_close(a, b, rtol=0, atol=0)
  for k in full[1]:
    torch.testing.assert_close(full[1][k], skipped[1][k], rtol=0, atol=0)


def test_gather_only_scatter_matches_reference_by_distribution():
  '''A scatter scene the kernels refuse (its inverse CDF too rough for their
  fits): the twin draws on the exact gather path from its generator, the
  JAX fused step from its key, so the two histograms agree in distribution
  (`scatterStatsGate`, `marginalsClose`).'''
  import jax
  scene, deviceNp, maxI, _Q = _roughScatterScene()
  info = scene.compile(devicePut=False)[1]
  n = 16384
  cols = _hostRays(scene.lightSources()[0], n, seed=11)
  gen = torch.Generator()
  gen.manual_seed(5)
  twin = _twin(deviceNp, info, H.SCATTER_BOUNDS, cols, maxI, bins=(128, 128),
               generator=gen)
  ref = _jaxHistogram(deviceNp, info, H.SCATTER_BOUNDS, cols, maxI,
                      bins=(128, 128), key=jax.random.PRNGKey(5))
  stats = [H.scatterStats(h, c['hits'], n) for h, c in (twin, ref)]
  ok, sigmas = H.scatterStatsGate(stats[0], stats[1], n, n)
  assert ok, (stats, sigmas)
  assert H.marginalsClose(twin[0]['counts'][0], ref[0]['counts'][0])
  assert twin[1]['segments'] >= 2 * n


BOUNCE_SCENES = {
    'lensMirror': lambda: H.buildBench(H.jaxNs(), 'lensMirror'),
    'prism': lambda: H.buildTirScene(H.jaxNs()),
}


@pytest.mark.parametrize('name', sorted(BOUNCE_SCENES))
def test_bounce_one_matches_reference_and_batch(name):
  '''32 rays, bounce by bounce: the port's `bounceOne` ray by ray against
  the JAX package's vmapped `bounceOne` and against the port's
  `bounceBatch` on the whole batch.'''
  import jax
  import jax.numpy as jnp
  from optics_design_workbench_tpu.tracing import tracer as JT
  from optics_design_workbench_tpu_torch import convert
  from optics_design_workbench_tpu_torch.tracing import batch_tracer as TB
  from optics_design_workbench_tpu_torch.tracing import tracer as TT
  scene, _bounds, maxI = BOUNCE_SCENES[name]()
  deviceNp, _info = scene.compile(devicePut=False)
  deviceNp['powerTol'] = 1e-6
  n = 32
  o, d, pw, wl = _hostRays(scene.lightSources()[0], n, seed=3)
  init = (o, d, pw, wl, np.full(n, -1, np.int32), np.zeros(n, np.int32),
          np.ones(n, bool))

  devJ = _jaxScene(deviceNp)
  jaxBounce = jax.jit(jax.vmap(
      lambda *s: JT.bounceOne(devJ, DIST_TOL, MAX_RAY_LENGTH, *s)))
  state = tuple(map(jnp.asarray, init))
  recJ = []
  for _ in range(maxI):
    state, rec = jaxBounce(*state)
    recJ.append({k: np.asarray(v) for k, v in rec.items()})

  prepared = convert.recordSceneFromReference(deviceNp, 'cpu')
  tInit = [torch.as_tensor(x) for x in init[:4]] + [
      torch.as_tensor(init[4], dtype=torch.int64),
      torch.as_tensor(init[5], dtype=torch.int64), torch.as_tensor(init[6])]
  states = [tuple(x[i] for x in tInit) for i in range(n)]
  recOne = []
  for _ in range(maxI):
    rows = []
    for i in range(n):
      states[i], rec = TT.bounceOne(prepared, DIST_TOL, MAX_RAY_LENGTH,
                                    *states[i])
      rows.append(rec)
    recOne.append({k: torch.stack([r[k] for r in rows]).numpy()
                   for k in rows[0]})

  state = tuple(tInit)
  recBatch = []
  for _ in range(maxI):
    state, rec = TB.bounceBatch(prepared, DIST_TOL, MAX_RAY_LENGTH, *state)
    point = torch.stack([rec['px'], rec['py'], rec['pz']], -1)
    recBatch.append(dict(
        hitElem=rec['hitElem'], hitSurface=rec['hitSurface'], point=point,
        direction=torch.stack([rec['dirX'], rec['dirY'], rec['dirZ']], -1),
        power=rec['power'], isEntering=rec['isEntering'],
        isHit=rec['isHit'], recordHit=rec['recordHit'],
        segValid=rec['segValid'],
        segP1=torch.stack([rec['oX'], rec['oY'], rec['oZ']], -1),
        segP2=point, segPower=rec['segPower'], segMedium=rec['segMedium']))
    recBatch[-1] = {k: v.numpy() for k, v in recBatch[-1].items()}

  stack = lambda recs: {k: np.stack([r[k] for r in recs]) for k in recs[0]}
  one = stack(recOne)
  assert one['isHit'].sum() > n
  assertRecordsMatch(stack(recJ), one)
  assertRecordsMatch(stack(recBatch), one)


def test_per_ray_intersect_matches_reference():
  '''The one-ray forms of `geometry/intersect` (allDistances,
  selectNearest with its tie rule, hitNormal) against the JAX package's,
  vmapped, on the first hits of 32 rays of the lens-and-mirror.'''
  import jax
  import jax.numpy as jnp
  from optics_design_workbench_tpu.geometry import intersect as JI
  from optics_design_workbench_tpu_torch import convert
  from optics_design_workbench_tpu_torch.geometry import intersect as TI
  scene, _bounds, _maxI = BOUNCE_SCENES['lensMirror']()
  deviceNp, _info = scene.compile(devicePut=False)
  n = 32
  o, d, _pw, _wl = _hostRays(scene.lightSources()[0], n, seed=4)
  surfJ = _jaxScene(deviceNp)['surfaces']
  medium = np.full(n, -1, np.int32)

  def refOne(o1, d1, m1):
    t = JI.allDistances(surfJ, o1, d1, DIST_TOL)
    idx, tHit, hasHit = JI.selectNearest(t, surfJ['elem'], m1, DIST_TOL,
                                         MAX_RAY_LENGTH)
    nrm, entering = JI.hitNormal(surfJ, idx, o1 + tHit * d1, d1)
    return t, idx, tHit, hasHit, nrm, entering

  ref = [np.asarray(x) for x in jax.jit(jax.vmap(refOne))(
      jnp.asarray(o), jnp.asarray(d), jnp.asarray(medium))]
  surf = convert.recordSceneFromReference(deviceNp, 'cpu')['surfaces']
  rows = []
  for i in range(n):
    o1, d1 = torch.as_tensor(o[i]), torch.as_tensor(d[i])
    t = TI.allDistances(surf, o1, d1, DIST_TOL)
    idx, tHit, hasHit = TI.selectNearest(t, surf['elem'],
                                         torch.tensor(-1), DIST_TOL,
                                         MAX_RAY_LENGTH)
    nrm, entering = TI.hitNormal(surf, idx, o1 + tHit * d1, d1)
    rows.append((t, idx, tHit, hasHit, nrm, entering))
  got = [torch.stack([r[k] for r in rows]).numpy() for k in range(6)]
  assert got[3].all() and (ref[1] == got[1]).all()
  np.testing.assert_array_equal(np.isfinite(ref[0]), np.isfinite(got[0]))
  finite = np.isfinite(ref[0])
  np.testing.assert_allclose(got[0][finite], ref[0][finite], rtol=1e-5,
                             atol=1e-4)
  np.testing.assert_allclose(got[2], ref[2], rtol=1e-5, atol=1e-4)
  np.testing.assert_allclose(got[4], ref[4], atol=1e-5)
  np.testing.assert_array_equal(got[5], ref[5])


# ---------------------------------------------------------- the entry points


def test_histogram_run_on_a_refused_scene_takes_the_twin(tmp_path):
  '''`runSimulation(recording='histogram')` on the sequential dish: the
  snapshot's counts are the twin's own step at the run's first seed, and
  the raw sample goes through the record tracer.'''
  from optics_design_workbench_tpu_torch import simulation
  from optics_design_workbench_tpu_torch.ops import cuda_trace
  from optics_design_workbench_tpu_torch.simulation import results_store
  from optics_design_workbench_tpu_torch.tracing import fused as TF
  from test_torch_runner import loadAllHits
  scene, bounds, maxI = _portSequentialDish()
  scene.path = str(tmp_path / 'dish')
  settings = scene.activeSimulationSettings()
  settings.RaysPerIteration = 2048
  before = dict(cuda_trace.launchCounts)
  runPath = simulation.runSimulation(
      scene, 'singletrue', seed=4, recording='histogram', store=True,
      histBounds=bounds, histBins=BINS, rawSampleRays=512, device='cpu')
  assert cuda_trace.launchCounts == before
  snap = results_store.loadHistogramSnapshots(runPath)['Src']['Det']

  run = simulation.runner.SimulationRun(scene, settings, device='cpu')
  src = scene.lightSources()[0]
  spec = TF.makeHistogramSpec(run.device, run.info, bounds=bounds, bins=BINS)
  step = TF.makeFusedStep(run.sceneFor(src), src.deviceGenerator('cpu'),
                          spec, 2048, run.maxIntersections(src),
                          run.maxRayLength(src),
                          max(settings.distanceTolerance(), 1e-4),
                          device='cpu')
  gen = torch.Generator()
  gen.manual_seed(4)
  hist, counters = step(simulation.runner._drawSeeds(gen, 1)[0],
                        TF.initHistograms(spec, device='cpu'))
  np.testing.assert_array_equal(snap['counts'], hist['counts'][0].numpy())
  assert int(counters['hits']) == snap['counts'].sum() > 1000
  sample = loadAllHits(results_store, runPath)
  assert sample is not None and 0 < len(sample['points']) <= 2 * 512


def test_record_rays_source_takes_the_kernel_in_histogram_mode(
    tmp_path, monkeypatch):
  '''Histogram-first recording takes the fused step for a RecordRays
  source too, as the reference does: on the lens-and-mirror that is the
  kernel (its plain version on the CPU), not the twin, and no polylines
  are stored.'''
  from optics_design_workbench_tpu_torch import benchmarks, simulation
  from optics_design_workbench_tpu_torch.jupyter_utils import RawFolder
  from optics_design_workbench_tpu_torch.ops import cuda_trace
  from optics_design_workbench_tpu_torch.tracing import fused as TF
  built = []
  for module, name in ((cuda_trace, 'makeTraceStep'), (TF, 'makeFusedStep')):
    fn = getattr(module, name)
    monkeypatch.setattr(module, name, lambda *a, _fn=fn, _n=name, **k: (
        built.append(_n), _fn(*a, **k))[1])
  scene = benchmarks.buildLensMirrorScene(tmpdir=str(tmp_path))
  scene.getObject('Source').RecordRays = True
  scene.activeSimulationSettings().RaysPerIteration = 1024
  progress = []
  runPath = simulation.runSimulation(
      scene, 'singletrue', seed=2, recording='histogram', store=True,
      rawSampleRays=0, progressCallback=progress.append, device='cpu')
  assert built == ['makeTraceStep'], built
  assert progress[-1]['totalRecordedHits'] > 0.8 * 1024
  assert not RawFolder(runPath).loadRays('Source')


def test_bench_step_on_a_refused_scene_is_the_twin():
  from optics_design_workbench_tpu_torch import benchmarks
  scene, bounds, maxI = _portSequentialDish()
  step, hist, meta = benchmarks.makeBenchStep(
      scene=scene, raysPerStep=2048, maxIntersections=maxI,
      histBounds=bounds, device='cpu')
  assert meta['backend'] == 'tracer'
  hist, counters = step(1, hist)
  assert int(counters['hits']) == int(hist['counts'].sum()) > 1000
  _step, _hist, meta = benchmarks.makeBenchStep(
      raysPerStep=1024, useKernel=False, device='cpu')
  assert meta['backend'] == 'tracer'


def test_sweep_of_a_source_without_device_sampling_fails_as_reference():
  '''`evaluateBatched` of a source that cannot draw on the device (a
  surface source with no active faces): the JAX package's per-variant
  path fails in its `deviceGenerator` with a ValueError, the port with a
  ValueError that says why.'''
  from optics_design_workbench_tpu import jupyter_utils as JJ
  from optics_design_workbench_tpu_torch import jupyter_utils as TJ
  for ns, J, kw in ((H.jaxNs(), JJ, {}), (H.torchNs(), TJ,
                                          dict(device='cpu'))):
    bench = ns.benchmarks.buildSourceDetectorScene()
    scene = ns.Scene(label='nofaces')
    for group in bench.opticalObjects():
      scene.addOpticalGroup(group)
    scene.addSource(ns.SurfaceSource(Label='Src', ActiveSurfaces=[],
                                     PowerDensity='1'))
    scene.addSimulationSettings(RaysPerIteration=64, MaxIntersections=2)
    sweeper = J.ParameterSweeper(
        lambda sc: dict(w=(sc.getObject('Src'), 'Wavelength')), scene=scene,
        **kw)
    with pytest.raises(ValueError, match='faces|device sampling'):
      sweeper.evaluateBatched([dict(w=500.), dict(w=600.)],
                              lambda power, counts: counts.sum(),
                              raysPerScene=64, maxIntersections=2)
