'''Differentiable design on the port (tracing/diff.py on torch autograd)
against the JAX package's tracing/diff.py on the same compiled scene and
the same rays: `applyParams` moves every view of the tables as the JAX
package's does (and leaves them equal at p = 0), `makeSpotLoss`'s value and
gradient match the JAX package's and central finite differences, and
`optimizeGradient` focuses a lens (the JAX suite's own focusing test).'''

import numpy as np
import pytest
import torch

import torch_port_helpers as H

torch.set_num_threads(1)

RAYS = 1024
LENS, MIRROR, DETECTOR = 0, 1, 2          # the lens-and-mirror's elements
PIVOT = (0., 0., 60.)


def _hostBatch(src, n, seed):
  '''`n` rays of the lens-and-mirror's point source: theta ~ |N(0, 0.1)|
  clipped to its domain (its exp(-theta^2/0.02) density), phi uniform, by
  the JAX source's `makeRaysHost`; numpy float32.'''
  rng = np.random.default_rng(seed)
  t1, t2 = src.parsedThetaDomain()
  theta = np.clip(np.abs(rng.normal(0., 0.1, n)), t1, t2)
  b = src.makeRaysHost(theta, rng.uniform(*src.parsedPhiDomain(), n))
  return {k: np.asarray(b[k], np.float32)
          for k in ('origins', 'directions', 'powers', 'wavelengths')}


@pytest.fixture(scope='module')
def lens():
  import jax
  import jax.numpy as jnp
  from optics_design_workbench_tpu_torch import convert
  scene, _bounds, _maxI = H.buildBench(H.jaxNs(), 'lensMirror')
  deviceNp, info = scene.compile(devicePut=False)
  devJ = jax.tree_util.tree_map(jnp.asarray, deviceNp)
  devJ['powerTol'] = 1e-6
  packed = deviceNp['surfaces']['packed']
  elems = packed[:, 13].astype(int).tolist()
  kinds = np.asarray(deviceNp['surfaces']['kind']).tolist()
  sphere = next(i for i, (e, k) in enumerate(zip(elems, kinds))
                if e == LENS and k == 1)
  return dict(devJ=devJ, deviceNp=deviceNp, info=info, sphere=sphere,
              elems=elems, port=convert.recordSceneFromReference(deviceNp,
                                                                 'cpu'),
              batch=_hostBatch(scene.lightSources()[0], RAYS, seed=3))


def _gratingScene(ns):
  '''The JAX suite's grating-rotation scene (tests/test_diff.py
  `TestGratingRotation.makeScene`): a 600 lines/mm reflection grating tilted
  15 deg at z = 100 before a spherical absorber.'''
  S, T = ns.S, ns.T
  scene = ns.Scene(label='gratrot')
  scene.addOpticalGroup(ns.OpticalGroup(
      OpticalType='Grating', Label='G', GratingType='Reflection',
      GratingLinesPerMillimeter=600., GratingDiffractionOrder=1,
      GratingLinesOrientation=(0.6, 0.8, 0.),
      surfaces=[S.plane(np.eye(4), elem=0, halfExtents=(40., 40.),
                        orient=-1)],
      placements=[T.compose(T.translation(0, 0, 100),
                            T.rotation((1, 0, 0), 15.))]))
  scene.addOpticalGroup(ns.OpticalGroup(
      OpticalType='Absorber', Label='Det',
      surfaces=[S.sphere(T.translation(0, 0, 100), elem=0, radius=300.,
                         orient=-1)],
      placements=[np.eye(4)]))
  scene.addSource(ns.PointSource(Label='Src', PowerDensity='1',
                                 ThetaDomain='0, 0.1', Wavelength=532.))
  scene.addSimulationSettings(RaysPerIteration=64, MaxIntersections=3,
                              MaxRayLength=2000)
  return scene


def _views(sc):
  '''Every view applyParams must move, as numpy: the flat surface arrays,
  the packed rows, the byKind slices and the element rows.'''
  host = lambda x: np.asarray(x.detach().cpu() if hasattr(x, 'detach')
                              else x)
  s = sc['surfaces']
  out = {k: host(s[k]) for k in ('w2lRot', 'w2lOff', 'params', 'packed')}
  for name, sub in s['byKind'].items():
    for k in ('params', 'w2lRot', 'w2lOff'):
      out[f'byKind.{name}.{k}'] = host(sub[k])
  out['elements.packed'] = host(sc['elements']['packed'])
  return out


SPECS = {
    'translate': lambda L: ('translate', 3, (0., 0.3, 1.)),
    'rotate': lambda L: ('rotate', 1, (1., 0., 0.), PIVOT),
    'surfaceParam': lambda L: ('surfaceParam', L['sphere'], 0),
    'refrIndex': lambda L: ('refrIndex', LENS),
    'translateGroup': lambda L: ('translateGroup', LENS, (0., 0., 1.)),
    'rotateGroup': lambda L: ('rotateGroup', MIRROR, (1., 1., 0.), PIVOT),
}


@pytest.mark.parametrize('kind', sorted(SPECS) + ['coRotateRuling'])
def test_apply_params_moves_every_view_as_reference(lens, kind):
  import jax
  import jax.numpy as jnp
  from optics_design_workbench_tpu.tracing import diff as JD
  from optics_design_workbench_tpu_torch import convert
  from optics_design_workbench_tpu_torch.tracing import diff as TD
  if kind == 'coRotateRuling':
    # eager, no trace: the ruling turns with the grating
    deviceNp, _info = _gratingScene(H.jaxNs()).compile(devicePut=False)
    devJ = jax.tree_util.tree_map(jnp.asarray, deviceNp)
    port = convert.recordSceneFromReference(deviceNp, 'cpu')
    spec, value = ('rotateGroup', 0, (1., 0., 0.), (0., 0., 100.),
                   'coRotateRuling'), 0.15
  else:
    devJ, port = lens['devJ'], lens['port']
    spec = SPECS[kind](lens)
    value = {'refrIndex': 0.05, 'rotate': 0.1, 'rotateGroup': -0.2}.get(
        kind, 2.5)
  ref = JD.applyParams(devJ, [spec], jnp.array([value], jnp.float32))
  got = TD.applyParams(port, [spec], torch.tensor([value]))
  ref, got, before = _views(ref), _views(got), _views(port)
  assert set(ref) == set(got)
  moved = False
  for k in ref:
    np.testing.assert_allclose(got[k], ref[k], atol=1e-5, rtol=0, err_msg=k)
    moved |= not np.array_equal(got[k], before[k])
  assert moved
  # the port's own views agree with each other bit for bit
  s = TD.applyParams(port, [spec], torch.tensor([value]))['surfaces']
  torch.testing.assert_close(s['packed'][:, 0:9], s['w2lRot'].reshape(-1, 9),
                             rtol=0, atol=0)
  torch.testing.assert_close(s['packed'][:, 9:12], s['w2lOff'], rtol=0,
                             atol=0)
  torch.testing.assert_close(s['packed'][:, 15:], s['params'], rtol=0,
                             atol=0)


def test_apply_params_at_zero_is_the_input(lens):
  from optics_design_workbench_tpu_torch.tracing import diff as TD
  specs = [f(lens) for f in SPECS.values()]
  sc = TD.applyParams(lens['port'], specs, torch.zeros(len(specs)))
  for k, v in _views(lens['port']).items():
    np.testing.assert_array_equal(_views(sc)[k], v, err_msg=k)


def test_apply_params_prepares_a_host_scene_where_it_resolves(lens):
  '''A compiled host scene is prepared on the device asked for, else on
  the card `p` lies on, else on 'cuda', which raises without a card rather
  than running on the CPU.'''
  from optics_design_workbench_tpu_torch import KernelError
  from optics_design_workbench_tpu_torch.tracing import diff as TD
  specs = [SPECS['translate'](lens)]
  p = torch.tensor([2.5])
  got = TD.applyParams(lens['deviceNp'], specs, p, device='cpu')
  assert got['surfaces']['w2lOff'].device.type == 'cpu'
  want = _views(TD.applyParams(lens['port'], specs, p))
  for k, v in _views(got).items():
    np.testing.assert_array_equal(v, want[k], err_msg=k)
  if torch.cuda.is_available():
    onCard = TD.applyParams(lens['deviceNp'], specs, p)
    assert onCard['surfaces']['w2lOff'].device.type == 'cuda'
  else:
    with pytest.raises(KernelError, match='no CUDA device'):
      TD.applyParams(lens['deviceNp'], specs, p)


def test_apply_params_refuses_as_reference(lens):
  from optics_design_workbench_tpu_torch import convert
  from optics_design_workbench_tpu_torch.tracing import diff as TD
  port = lens['port']
  with pytest.raises(ValueError, match='no surfaces belong to element 9'):
    TD.applyParams(port, [('translateGroup', 9, (0., 0., 1.))],
                   torch.zeros(1))
  with pytest.raises(ValueError, match='coRotateRuling on non-grating'):
    TD.applyParams(port, [('rotateGroup', MIRROR, (1., 0., 0.), PIVOT,
                           'coRotateRuling')], torch.zeros(1))
  with pytest.raises(ValueError, match='unknown parameter spec kind'):
    TD.applyParams(port, [('scale', 0)], torch.zeros(1))
  scene, _b, _m = H.buildDispersiveLensMirrorScene(H.jaxNs())
  dispersive = convert.recordSceneFromReference(
      scene.compile(devicePut=False)[0], 'cpu')
  with pytest.raises(ValueError, match='dispersion table'):
    TD.applyParams(dispersive, [('refrIndex', LENS)], torch.zeros(1))


@pytest.fixture(scope='module')
def spotLosses(lens):
  '''The same merit in both packages: one loss over the lens's
  translation, its sphere's radius, its index and the mirror's rotation.'''
  import jax.numpy as jnp
  from optics_design_workbench_tpu.tracing import diff as JD
  from optics_design_workbench_tpu_torch.tracing import diff as TD
  specs = [SPECS[k](lens) for k in ('translateGroup', 'surfaceParam',
                                    'refrIndex', 'rotateGroup')]
  batch = lens['batch']
  jaxLoss = JD.makeSpotLoss(lens['devJ'], specs,
                            {k: jnp.asarray(v) for k, v in batch.items()},
                            detectorElem=DETECTOR, maxIntersections=6)
  portLoss = TD.makeSpotLoss(lens['port'], specs,
                             {k: torch.as_tensor(v) for k, v in batch.items()},
                             detectorElem=DETECTOR, maxIntersections=6)
  # finite-difference steps: the JAX suite's (tests/test_diff.py) per kind
  return jaxLoss, portLoss, np.array([1e-3, 1e-3, 1e-4, 1e-4])


@pytest.mark.parametrize('p', ([0., 0., 0., 0.], [0.8, -0.3, 0.02, 0.004]))
def test_spot_loss_matches_reference_and_finite_differences(spotLosses, p):
  '''Value within rtol 1e-5 and gradient within rtol 1e-3 of the JAX
  package's, the gradient within 2 % of central differences. At p = 0 the
  sphere cap's apex sits on its zRange bound, so a larger radius trims a
  disc off the apex and the merit has a kink there (ROADMAP C,
  Sensitivities): that component is held to its backward difference. A
  discriminant that cancels to exactly 0 makes the JAX package's gradient
  NaN (its sqrt guard lets sqrt'(0) through; ROADMAP C); the port's stays
  finite and is held to the finite differences alone there.'''
  import jax.numpy as jnp
  jaxLoss, portLoss, eps = spotLosses
  p = np.array(p)
  vJ, gJ = jaxLoss(jnp.array(p, jnp.float32))
  vT, gT = portLoss(torch.tensor(p))
  vJ, gJ, vT, gT = float(vJ), np.asarray(gJ), float(vT), gT.numpy()
  assert np.isfinite(gT).all() and np.abs(gT).max() > 0
  np.testing.assert_allclose(vT, vJ, rtol=1e-5)
  finite = np.isfinite(gJ)
  np.testing.assert_allclose(gT[finite], gJ[finite], rtol=1e-3,
                             atol=1e-6 * np.abs(gJ[finite]).max())
  value = lambda q: float(portLoss(torch.tensor(q))[0])
  for k in range(len(p)):
    step = np.zeros(len(p))
    step[k] = eps[k]
    if not p.any() and k == 1:
      fd = (vT - value(p - step)) / eps[k]
    else:
      fd = (value(p + step) - value(p - step)) / (2 * eps[k])
    assert abs(fd - gT[k]) <= 2e-2 * max(abs(fd), 1e-9), (k, fd, gT[k])


def test_gradient_stays_finite_where_a_discriminant_cancels(spotLosses):
  '''At this p one dead ray, 1e5 mm away, grazes the lens barrel with a
  discriminant that cancels to exactly 0 (b^2 = 4ac in float32). The JAX
  package's sqrt guard lets sqrt'(0) = inf through there, and its gradient
  of the mirror's rotation comes out NaN (ROADMAP C); the port's guard
  (`surfaces.sqrtPositive`) keeps every component finite and equal to the
  JAX package's where that one is finite.'''
  import jax.numpy as jnp
  jaxLoss, portLoss, _eps = spotLosses
  p = [0.8, 0.3, 0.02, 0.004]
  gJ = np.asarray(jaxLoss(jnp.array(p, jnp.float32))[1])
  gT = portLoss(torch.tensor(p))[1].numpy()
  assert np.isfinite(gT).all(), gT
  finite = np.isfinite(gJ)
  np.testing.assert_allclose(gT[finite], gJ[finite], rtol=1e-3)


def test_gradient_descent_focuses_detector(tmp_path):
  '''The JAX suite's focusing test on the port: a plano-convex lens, the
  detector distance optimized by Adam (60 steps at learning rate 5 over
  512 rays) until the spot is a quarter of its start.'''
  from optics_design_workbench_tpu_torch.tracing import diff as TD
  ns = H.torchNs()
  S, T = ns.S, ns.T
  scene = ns.Scene(label='focus', path=str(tmp_path / 'focus'))
  scene.addOpticalGroup(ns.OpticalGroup(
      OpticalType='Lens', Label='L', RefractiveIndex=1.5,
      surfaces=[S.sphere(np.eye(4), elem=0, radius=100.,
                         zRange=(95., 100.), orient=+1),
                S.plane(T.translation(0, 0, 95.), elem=0,
                        radius=31.225, orient=-1)],
      placements=[T.translation(0, 0, -60)]))
  scene.addOpticalGroup(ns.OpticalGroup(
      OpticalType='Absorber', Label='Det',
      surfaces=[S.plane(np.eye(4), elem=1, halfExtents=(120., 120.))],
      placements=[T.translation(0, 0, 120)]))
  scene.addSource(ns.PointSource(Label='Src', PowerDensity='1',
                                 ThetaDomain='0, pi/40'))
  scene.addSimulationSettings(RaysPerIteration=64, MaxIntersections=5,
                              MaxRayLength=2000)
  host, _info = scene.compile(device=None)
  assert host['surfaces']['packed'][1, 13] == 1    # row 1 is the detector
  gen = torch.Generator()
  gen.manual_seed(1)
  cols, _meta = scene.lightSources()[0].deviceGenerator(device='cpu')(
      gen, 512)
  batch = dict(origins=torch.stack([cols['ox'], cols['oy'], cols['oz']], -1),
               directions=torch.stack([cols['dx'], cols['dy'], cols['dz']],
                                      -1),
               powers=cols['pw'], wavelengths=cols['wl'])
  lg = TD.makeSpotLoss(host, [('translate', 1, (0., 0., 1.))], batch,
                       detectorElem=1, maxIntersections=5, maxRayLength=2000.)
  v0 = float(lg(torch.zeros(1))[0])
  bestP, history = TD.optimizeGradient(lg, torch.zeros(1), steps=60,
                                       learningRate=5.)
  vBest = min(v for _s, v in history)
  assert vBest < 0.25 * v0, (v0, vBest)
  assert np.isfinite(float(bestP[0]))
