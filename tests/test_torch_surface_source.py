'''Surface sources on the PyTorch port (the surface-source sampler in the
trace kernels), on the CPU against the JAX package:

  * the column maths (`surfaceSampleColumns`) against the JAX package's
    `_surfaceSampleColumns` on the same numpy-made uniforms, for an emitter
    of a plane rectangle, an annulus facing -z, a sphere zone and a cylinder
    under two placements: positions atol 1e-5 mm, directions atol 1e-6;
  * `samplerSpec()` against `pallasSamplerSpec()`: faces, windows and the
    theta marginal equal to float32;
  * the histogram kernel's and the raw-record kernel's plain versions in
    uniforms mode (five draws a ray: face, u, v, theta, phi) against the JAX
    Pallas kernels in interpret mode fed the same uniforms, on that emitter
    and on the reference's surface-source throughput scene: counters equal,
    counts within the 2-ray bin-edge budget, power within 1 %, raw rows ray
    by ray within atol 1e-4;
  * seed mode by distribution against the JAX host sampler (face fractions
    and theta marginal, L1 <= 0.15), and the detected share and mean
    detected power of the throughput scene against the JAX package's fused
    step at 65,536 rays, within 3 sigma;
  * `runSimulation` raw and histogram-first with a surface source;
  * the refusals that name their ROADMAP items (A.10a) and the sweep's.
'''

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (both frameworks live in this process)

import torch_port_helpers as H
from optics_design_workbench_tpu.models.surface_source import \
    _surfaceSampleColumns as refSurfaceSampleColumns
from optics_design_workbench_tpu.tracing.batch_tracer import _evalPwpoly
from optics_design_workbench_tpu_torch import convert
from optics_design_workbench_tpu_torch.distributions.device_sampler import \
    evalPwpoly
from optics_design_workbench_tpu_torch.models import surface_source
from optics_design_workbench_tpu_torch.ops import cuda_trace
from optics_design_workbench_tpu_torch.tracing import fused

torch.set_num_threads(1)

N = 1 << 14


def _uniforms(n, seed):
  return np.random.default_rng(seed).random((5, n)).astype(np.float32)


def _theta(spec, uT):
  '''The theta column both sides get: the JAX package's marginal of uT.'''
  t = spec['theta']
  out = (_evalPwpoly(t, uT) if t[0] == 'pwpoly'
         else t[1] + uT * (t[2] - t[1]))
  return np.asarray(out, np.float32)


@pytest.fixture(scope='module')
def emitters():
  '''(JAX source, port source) of the multi-face emitter scene.'''
  jaxScene, _b, _m = H.buildSurfaceEmitterScene(H.jaxNs())
  portScene, _b, _m = H.buildSurfaceEmitterScene(H.torchNs())
  return jaxScene.lightSources()[0], portScene.lightSources()[0]


def test_surface_sample_columns_match_reference(emitters):
  ref, port = emitters
  spec = ref.pallasSamplerSpec()
  us = _uniforms(N, 3)
  theta = _theta(spec, us[3])
  phi = us[4] * np.float32(2. * np.pi)
  want = refSurfaceSampleColumns(spec['faces'], *us[:3], theta, phi,
                                 spec['wavelength'])
  t = lambda u: torch.as_tensor(np.array(u))  # noqa: E731
  got = surface_source.surfaceSampleColumns(
      port.samplerSpec()['faces'], *(t(u) for u in us[:3]), t(theta), t(phi),
      float(port.Wavelength))
  for k, atol in (('ox', 1e-5), ('oy', 1e-5), ('oz', 1e-5), ('dx', 1e-6),
                  ('dy', 1e-6), ('dz', 1e-6), ('pw', 0.), ('wl', 0.)):
    np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0.,
                               atol=atol, err_msg=k)
  # every face is drawn, the orient -1 annulus emits along -z of its frame
  faces = surface_source.faceIndexColumn(port.samplerSpec()['faces'],
                                         t(us[0]))
  assert set(faces.numpy().astype(int).tolist()) == set(range(8))


def test_sampler_spec_matches_reference(emitters):
  ref, port = emitters
  want, got = ref.pallasSamplerSpec(), port.samplerSpec()
  assert got['type'] == want['type'] == 'surface'
  assert got['wavelength'] == want['wavelength']
  assert len(got['faces']) == len(want['faces']) == 8
  f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
  for a, b in zip(got['faces'], want['faces']):
    assert a['kind'] == b['kind']
    for k in ('params', 'trim', 'orient', 'R', 'off', 'cumLo', 'cumHi'):
      np.testing.assert_array_equal(f32(a[k]), f32(b[k]), err_msg=k)
  assert got['theta'][0] == want['theta'][0] == 'pwpoly'
  np.testing.assert_array_equal(f32(got['theta'][2:]), f32(want['theta'][2:]))
  assert len(got['theta'][1]) == len(want['theta'][1])
  for a, b in zip(got['theta'][1], want['theta'][1]):
    np.testing.assert_array_equal(f32(a[:4]), f32(b[:4]))
    np.testing.assert_array_equal(f32(a[4]), f32(b[4]))
  # the marginal the kernel evaluates: the same float32 theta
  uT = _uniforms(N, 4)[3]
  np.testing.assert_array_equal(
      evalPwpoly(got['theta'], torch.as_tensor(uT)).numpy(), _theta(want, uT))
  # the spec carried across by convert is the port's own
  assert convert.samplerSpecFromReference(want) == got


@pytest.fixture(scope='module', params=sorted(H.SURFACE_SCENES))
def surfaceCase(request):
  return H.runUniformsCase(H.SURFACE_SCENES[request.param])


def test_histogram_plain_matches_reference_kernel(surfaceCase):
  H.assertHistogramsMatch(surfaceCase)
  ref, _port = surfaceCase['hist']
  assert ref['counters']['hits'] > 0.4 * H.N_RAYS


def test_raw_plain_matches_reference_kernel(surfaceCase):
  H.assertRawRowsMatch(surfaceCase)


def test_uniforms_take_five_rows_and_no_strata(surfaceCase):
  tables = surfaceCase['tables']
  assert cuda_trace.samplerUniforms(tables) == 5
  with pytest.raises(ValueError, match=r'shape \(5, 256\)'):
    cuda_trace.traceRaw(tables, 256, 3, 1000., 1e-4,
                        uniforms=torch.zeros((2, 256)))
  # strata are the point sampler's: a strata tile changes nothing here
  us = torch.as_tensor(_uniforms(512, 5))
  a = cuda_trace.traceRaw(tables, 512, 3, 1000., 1e-4, uniforms=us)
  b = cuda_trace.traceRaw(tables, 512, 3, 1000., 1e-4, uniforms=us,
                          strataTile=128)
  assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_seed_mode_statistics_match_host_sampler(emitters):
  ref, port = emitters

  class Settings:
    def raysPerIteration(self):
      return N

  host = ref.generateRays('true', settings=Settings(),
                          rng=np.random.default_rng(1))
  gen = torch.Generator()
  gen.manual_seed(2)
  cols = port.deviceColumnsGenerator(device='cpu')(gen, N)
  # faces by area: the host draws them with the area weights
  faces = ref._faceConstants()
  weights = np.array([f['cumHi'] - f['cumLo'] for f in faces])
  frac = np.bincount(cols['_face'].numpy().astype(int), minlength=8) / N
  assert np.abs(frac - weights / weights.sum()).sum() <= 0.15
  edges = np.linspace(0., np.pi / 2, 21)
  a = np.histogram(cols['_theta'].numpy(), edges)[0] / N
  b = np.histogram(host['metadata']['initTheta'], edges)[0] / N
  assert np.abs(a - b).sum() <= 0.15
  # the kernel's seed mode on the CPU: the plain sampler on torch uniforms
  spec = port.samplerSpec()
  scene, bounds, _m = H.buildSurfaceEmitterScene(H.torchNs())
  sceneNp, info = scene.compile(device=None)
  histSpec = fused.makeHistogramSpec(sceneNp, info, bounds=bounds,
                                     bins=H.BINS)
  tables = cuda_trace.buildTraceTables(sceneNp, histSpec, samplerSpec=spec,
                                       device='cpu')
  gen.manual_seed(3)
  us = torch.rand((5, N), generator=gen)
  ox, oy, oz = cuda_trace.sampleSurfaceRaysPlain(tables, us)[:3]
  origins = torch.stack([ox, oy, oz], 1).numpy()
  np.testing.assert_allclose(origins.mean(0), host['origins'].mean(0),
                             atol=0.5)
  np.testing.assert_allclose(origins.std(0), host['origins'].std(0),
                             rtol=0.05)


# the JAX package's fused step on the surface-source throughput scene at
# 65,536 rays (seed 0): the detected share and the mean detected power that
# chip_smoke.py holds the card's run against
REF_DETECTED_SHARE = 0.68133544921875
REF_MEAN_POWER = 0.9838300736950235
REF_RAYS = 1 << 16


def test_bench_scene_statistics_agree_with_reference():
  from optics_design_workbench_tpu.tracing import fused as refFused
  from optics_design_workbench_tpu_torch import benchmarks
  scene, bounds, maxI = H.buildSurfaceBench(H.jaxNs())
  device, info = scene.compile()
  device['powerTol'] = 1e-6
  histSpec = refFused.makeHistogramSpec(device, info, bounds=bounds,
                                        bins=(128, 128))
  step = refFused.makeFusedStep(
      device, scene.lightSources()[0].deviceGenerator(), histSpec,
      raysPerStep=REF_RAYS, maxIntersections=maxI,
      maxRayLength=scene.activeSimulationSettings().maxRayLength(),
      distTol=1e-4)
  hist, counters = step(jax.random.PRNGKey(0),
                        refFused.initHistograms(histSpec))
  refShare = int(counters['hits']) / REF_RAYS
  refPower = float(np.asarray(hist['power'], np.float64).sum()
                   / np.asarray(hist['counts'], np.float64).sum())
  # the constants chip_smoke.py uses are this run's
  assert refShare == pytest.approx(REF_DETECTED_SHARE, abs=1e-9)
  assert refPower == pytest.approx(REF_MEAN_POWER, abs=1e-9)
  stepP, histP, _meta = benchmarks.makeBenchStep(
      scene=benchmarks.buildSurfaceSourceScene(), raysPerStep=REF_RAYS,
      maxIntersections=maxI, histBounds=bounds, device='cpu')
  histP, c = stepP(5, histP)
  share = int(c['hits']) / REF_RAYS
  power = float(histP['power'].double().sum() / histP['counts'].double().sum())
  sigma = np.sqrt(2 * refShare * (1 - refShare) / REF_RAYS)
  assert abs(share - refShare) <= 3 * sigma, (share, refShare)
  # detected power is 0.98 (met the mirror) or 1 (came straight)
  q = (1. - refPower) / 0.02
  sigmaP = 0.02 * np.sqrt(2 * q * (1 - q) / (refShare * REF_RAYS))
  assert abs(power - refPower) <= 3 * sigmaP, (power, refPower)
  assert int(c['hitOverflow']) == 0 and float(histP['counts'].sum()) == \
      int(c['hits'])


def _emitterOnDetectorScene(ns, path):
  '''The JAX suite's runner scene (tests/test_surface_source_device.py): a
  disc emitter of radius 5 mm below a 400 x 400 mm absorbing detector at
  z = 40, 10,000 rays an iteration, 40,000 in all.'''
  S, T = ns.S, ns.T
  scene = ns.Scene(label='ss', path=path)
  scene.addOpticalGroup(ns.OpticalGroup(
      OpticalType='Mirror', Label='Emitter',
      surfaces=[S.plane(np.eye(4), elem=0, radius=5.)],
      placements=[T.translation(0, 0, 0)]))
  scene.addOpticalGroup(ns.OpticalGroup(
      OpticalType='Absorber', Label='Det', RecordHits=True,
      surfaces=[S.plane(np.eye(4), elem=0, halfExtents=(200., 200.))],
      placements=[T.translation(0, 0, 40.)]))
  scene.addSource(ns.SurfaceSource(Label='SS', ActiveSurfaces=['Emitter'],
                                   PowerDensity='cos(theta)**2'))
  scene.addSimulationSettings(RaysPerIteration=1e4, MaxIntersections=3,
                              EndAfterRays=4e4)
  return scene


def test_run_simulation_raw_and_histogram(tmp_path):
  from optics_design_workbench_tpu_torch import simulation
  from optics_design_workbench_tpu_torch.jupyter_utils import RawFolder
  from optics_design_workbench_tpu_torch.simulation import results_store
  scene = _emitterOnDetectorScene(H.torchNs(), str(tmp_path / 'ss'))
  progress = []
  run = simulation.runSimulation(scene, 'true', seed=3, device='cpu',
                                 progressCallback=progress.append)
  rows = len(RawFolder(run).loadHits('Det'))
  assert rows == progress[-1]['totalRecordedHits'] > 3.5e4
  progress.clear()
  run = simulation.runSimulation(scene, 'true', seed=4, device='cpu',
                                 recording='histogram',
                                 histBounds=(-200., 200., -200., 200.),
                                 progressCallback=progress.append)
  counts = results_store.loadHistogramSnapshots(run)['SS']['Det']['counts']
  # the emitter faces +z: a cos^2 lobe from each point meets the detector
  # plane for every draw with theta < ~pi/2
  assert counts.sum() == progress[-1]['totalRecordedHits'] > 3.5e4
  assert len(RawFolder(run).loadHits('Det')) > 0     # the raw sample


def test_refusals_name_their_items(tmp_path):
  ns = H.torchNs()
  from optics_design_workbench_tpu_torch import simulation
  # faces of the other kinds are sampled now (A.6): a cone face gives a spec
  scene = ns.Scene(label='cone')
  cone = ns.S._surf(ns.S.CONE, (6., -0.5), (0., 0., 8.), np.eye(4), 0, 1.)
  scene.addOpticalGroup(ns.OpticalGroup(OpticalType='Mirror',
                                        Label='Emitter', surfaces=[cone]))
  src = scene.addSource(ns.SurfaceSource(Label='SS',
                                         ActiveSurfaces=['Emitter']))
  assert src.samplerSpec()['faces'][0]['kind'] == ns.S.CONE
  bench = ns.benchmarks.buildSurfaceSourceScene()
  # the host modes and metadata runs are ported (ROADMAP A.10a): fans
  # give rays, and a run stores the enabled metadata column
  fans = bench.lightSources()[0].generateRays('fans')
  assert len(fans['origins']) > 0
  runScene = _emitterOnDetectorScene(ns, str(tmp_path / 'meta'))
  settings = runScene.activeSimulationSettings()
  settings.StoreHitInitTheta = True
  settings.RaysPerIteration, settings.EndAfterRays = 2048, 2048
  run = simulation.runSimulation(runScene, 'true', seed=1, device='cpu')
  from optics_design_workbench_tpu_torch.jupyter_utils import RawFolder
  hits = RawFolder(run).loadHits('Det').hits
  assert 'initTheta' in hits and len(hits['initTheta']) > 1000
  assert 'initPhi' not in hits
  # the sweep refuses a surface sampler, as the reference's does
  sceneNp, info = bench.compile(device=None)
  spec = bench.lightSources()[0].samplerSpec()
  with pytest.raises(cuda_trace.SweepUnavailable, match='point-source'):
    cuda_trace.makeSweepStep([(sceneNp, info)] * 2, (-120., 120., -120., 120.),
                             (8, 8), spec, 256, 4, 1000., 1e-4, device='cpu')
  histSpec = fused.makeHistogramSpec(sceneNp, info)
  with pytest.raises(cuda_trace.SweepUnavailable, match='point-source'):
    cuda_trace.packSweepTables([sceneNp] * 2, histSpec, [spec] * 2)
