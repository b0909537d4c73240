'''The record tracer of the port (tracing/tracer.trace, batch_tracer,
geometry/surfaces' intersectors and normals) against the JAX package's
`tracer.trace` on the same compiled scene and the same ray columns, scene
by scene: hitElem / hitSurface equal, hit points and segment ends within
1e-4 mm (or the budget ROADMAP C records for the scene), powers within
rtol 1e-5; the scatter gather path by distribution. Also the two routes of
a fan or metadata run: the record tracer and the raw-record kernel's plain
version in its columns mode give the same hit rows.'''

import numpy as np
import pytest
import torch

import torch_port_helpers as H

torch.set_num_threads(1)

N = 512
MAX_RAY_LENGTH = H.MAX_RAY_LENGTH
DIST_TOL = H.DIST_TOL


def _bench(name):
  from optics_design_workbench_tpu_torch import benchmarks as B
  return lambda: (H.jaxSceneFromPort(getattr(B, name)()), None, 6)


# name -> (JAX scene factory returning (scene, bounds, maxI), traced source)
SCENES = {
    'lensMirror': (lambda: H.buildBench(H.jaxNs(), 'lensMirror'), 0),
    'prism': (lambda: H.buildTirScene(H.jaxNs()), 0),
    'spectrometer': (_bench('buildSpectrometerScene'), 0),
    'dispersiveLens': (lambda: H.buildDispersiveLensMirrorScene(H.jaxNs()),
                       0),
    'sequentialBall': (lambda: H.buildSequentialBallScene(H.jaxNs()), 0),
    'kinds': (_bench('buildKindsScene'), 0),
    'primSlot': (_bench('buildPrimSlotScene'), 0),
    'bitmapSlot': (_bench('buildBitmapSlotScene'), 0),
    'maskedSource': (lambda: H.buildMaskedSourcesScene(H.jaxNs()), 1),
    'meshLens': (lambda: H.buildMeshLensScene(H.jaxNs()), 0),
}

# ROADMAP C's sensitivity budgets, (max mm, share of rows past 1e-4 mm):
# the JAX package's CPU arithmetic contracts a * b + c; the cone and quadric
# discriminants cancel as (distance / size)^2 on the kinds scene (directions
# there within 1e-4); two facet refractions on the mesh lens carry an ulp
# of direction to 2e-3 mm
LOOSE = {'kinds': (0.25, 0.25), 'meshLens': (2e-3, 0.1)}


def assertRecordsMatch(rj, rt, atol=1e-4, loose=None):
  '''Integer and boolean records equal; the hit points within `atol` (or
  the scene's `loose` = (atol, share of rows) budget), segment ends that
  escape (maxRayLength away) within 2 float32 ulps; powers to rtol 1e-5.'''
  assert set(rj) == set(rt)
  for k in ('hitElem', 'hitSurface', 'isEntering', 'isHit', 'recordHit',
            'segValid', 'segMedium'):
    np.testing.assert_array_equal(rj[k].astype(np.int64),
                                  rt[k].astype(np.int64), err_msg=k)
  hit = rj['isHit']
  live = rj['segValid']
  for k in ('point', 'segP2', 'segP1', 'direction'):
    a, b = rj[k], rt[k]
    d = np.abs(a - b).max(-1)
    scale = np.abs(a).max(-1)
    rows = hit if k in ('point', 'segP2') else live
    escape = live & ~hit if k in ('point', 'segP2') else np.zeros_like(live)
    tol = atol if k != 'direction' else (1e-5 if loose is None else 1e-4)
    bad = rows & (d > tol)
    if loose is not None and k != 'direction':
      assert d[rows].max() <= loose[0], (k, d[rows].max())
      assert bad.sum() <= loose[1] * rows.sum(), (k, bad.sum(), rows.sum())
    else:
      assert not bad.any(), (k, d[rows].max())
    assert (d[escape] <= 2.5e-7 * scale[escape] + 1e-6).all(), k
  np.testing.assert_allclose(rj['power'][live], rt['power'][live],
                             rtol=1e-5, atol=1e-7)
  np.testing.assert_allclose(rj['segPower'][live], rt['segPower'][live],
                             rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize('name', sorted(SCENES))
def test_trace_matches_reference(name):
  build, source = SCENES[name]
  rj, rt, _ = H.recordTraceBoth(build, source)
  assert rj['isHit'].any()
  loose = LOOSE.get(name)
  assertRecordsMatch(rj, rt, loose=(None if loose is None
                                    else (loose[0], loose[1])))


def _roughScatterScene():
  '''The diffuser scene with its reflected-phi inverse CDF made too rough
  for the kernels' fits: the kernels refuse it (GATHER_ONLY_REASON), the
  record tracer draws it on the exact gather path.'''
  scene, _bounds, maxI = H.buildScatterScene(H.jaxNs(), 'diffuse')
  H.compileOnce(scene)
  deviceNp, info = scene.compile(devicePut=False)
  sc = dict(deviceNp['scatter'])
  noisy = np.cumsum(np.random.default_rng(7).exponential(size=257) ** 6)
  phiInv = np.array(sc['phiInv'])
  phiInv[0, 0] = noisy / noisy[-1] * 2 * np.pi
  Q = phiInv.shape[-1]
  sc['phiInv'] = phiInv
  sc['phiInvPairs'] = np.stack([phiInv[..., :-1], phiInv[..., 1:]],
                               -1).reshape(-1, 2).astype(np.float32)
  deviceNp = dict(deviceNp, scatter=sc, powerTol=1e-6)
  return scene, deviceNp, maxI, Q


def _hitStats(records, det):
  '''Per detected row: x, y and r^2 on the detector.'''
  m = records['recordHit'] & (records['hitElem'] == det)
  p = records['point'][m]
  return p[:, 0], p[:, 1], (p[:, 0] ** 2 + p[:, 1] ** 2)


def test_gather_only_scatter_matches_reference_by_distribution():
  import jax
  import jax.numpy as jnp
  from optics_design_workbench_tpu.tracing import tracer as JT
  from optics_design_workbench_tpu_torch import convert
  from optics_design_workbench_tpu_torch.ops import cuda_trace
  from optics_design_workbench_tpu_torch.tracing import scatter as SC
  from optics_design_workbench_tpu_torch.tracing import tracer as TT
  scene, deviceNp, maxI, _Q = _roughScatterScene()
  port, _spec = convert._sceneAndSpec(
      deviceNp, dict(elemToDet=np.array([-1, 0]), bounds=np.zeros((1, 4)),
                     bins=(8, 8)))
  assert cuda_trace.ineligibleReason(port) == SC.GATHER_ONLY_REASON
  n = 8192
  src = scene.lightSources()[0]
  rng = np.random.default_rng(11)
  b = src.makeRaysHost(rng.uniform(*src.parsedThetaDomain(), n),
                       rng.uniform(*src.parsedPhiDomain(), n))
  cols = [np.asarray(b[k], np.float32)
          for k in ('origins', 'directions', 'powers', 'wavelengths')]
  devJ = jax.tree_util.tree_map(jnp.asarray, {
      k: v for k, v in deviceNp.items() if k != 'powerTol'})
  _, rj = JT.trace(devJ, *map(jnp.asarray, cols), maxIntersections=maxI,
                   maxRayLength=MAX_RAY_LENGTH, distTol=DIST_TOL,
                   key=jax.random.PRNGKey(5))
  gen = torch.Generator()
  gen.manual_seed(5)
  _, rt = TT.trace(deviceNp, *map(torch.as_tensor, cols), maxI,
                   MAX_RAY_LENGTH, DIST_TOL, generator=gen)
  rj = {k: np.asarray(v) for k, v in rj.items()}
  rt = {k: v.numpy() for k, v in rt.items()}
  det = 1
  sj, st = _hitStats(rj, det), _hitStats(rt, det)
  assert len(sj[0]) > 0.8 * n and len(st[0]) > 0.8 * n
  for a, b in zip(sj, st):
    se = np.sqrt(a.var() / len(a) + b.var() / len(b))
    assert abs(a.mean() - b.mean()) < 3 * se, (a.mean(), b.mean(), se)
  ratio = len(st[0]) / len(sj[0])
  assert abs(ratio - 1) < 3 * np.sqrt(2. / len(sj[0]))


def test_record_tracer_and_raw_kernel_give_the_same_hit_rows():
  '''The two routes of fans and metadata runs on the lens-and-mirror:
  the record tracer and the raw-record kernel (its plain version, columns
  input mode) record the same hits of the same rays.'''
  from optics_design_workbench_tpu_torch import benchmarks as B
  from optics_design_workbench_tpu_torch.ops import cuda_trace
  from optics_design_workbench_tpu_torch.tracing import fused
  from optics_design_workbench_tpu_torch.tracing import tracer as TT
  scene = B.buildLensMirrorScene()
  host, info = scene.compile(device=None)
  host['powerTol'] = 1e-6
  src = scene.lightSources()[0]
  gen = torch.Generator()
  gen.manual_seed(2)
  cols, _meta = src.deviceGenerator(device='cpu')(gen, N)
  columns = torch.stack([cols[k] for k in cuda_trace._COLUMN_KEYS])
  histSpec = fused.makeHistogramSpec(host, info)
  tables = cuda_trace.buildTraceTables(host, histSpec, device='cpu')
  slots = cuda_trace.autoHitSlots(host, histSpec, 6)
  ring, _c = cuda_trace.traceRaw(tables, N, 6, MAX_RAY_LENGTH, DIST_TOL,
                                 hitSlots=slots, columns=columns)
  raw = cuda_trace.recordsFromRing(ring)
  _, rec = TT.trace(host, columns[0:3].T, columns[3:6].T, columns[6],
                    columns[7], 6, MAX_RAY_LENGTH, DIST_TOL,
                    recordSegments=False)

  def rows(r):
    m = r['recordHit']
    order = torch.nonzero(m.T)          # ray-major: (ray, slot)
    sel = (order[:, 1], order[:, 0])
    return {k: r[k][sel].numpy() for k in ('hitElem', 'point', 'direction',
                                           'power', 'isEntering')}, \
        order[:, 0].numpy()

  a, rayA = rows(raw)
  b, rayB = rows(rec)
  assert len(rayA) > 0.5 * N
  np.testing.assert_array_equal(rayA, rayB)
  np.testing.assert_array_equal(a['hitElem'], b['hitElem'])
  np.testing.assert_array_equal(a['isEntering'], b['isEntering'])
  np.testing.assert_allclose(a['point'], b['point'], atol=1e-4)
  np.testing.assert_allclose(a['direction'], b['direction'], atol=1e-5)
  np.testing.assert_allclose(a['power'], b['power'], rtol=1e-5)


def test_surface_helpers_match_reference():
  '''intersectLocal / normalLocal of one surface of each kind, and the
  tracer's interaction formulas, against the JAX package's.'''
  import jax.numpy as jnp
  from optics_design_workbench_tpu.geometry import surfaces as JS
  from optics_design_workbench_tpu.tracing import tracer as JT
  from optics_design_workbench_tpu_torch.geometry import surfaces as TS
  from optics_design_workbench_tpu_torch.tracing import tracer as TT
  rng = np.random.default_rng(4)
  o = np.zeros((64, 3), np.float32)
  o[:, :2] = rng.uniform(-3, 3, (64, 2))
  o[:, 2] = -40.
  d = np.tile(np.float32([0, 0, 1]), (64, 1))
  cases = [(TS.SPHERE, (10.,), (0., -10., 10.)),
           (TS.CYLINDER, (5.,), (0., -50., 50.)),
           (TS.CONE, (4., 0.2), (0., -50., 50.)),
           (TS.TORUS, (6., 2.), (0., -np.pi, np.pi))]
  for kind, params, trim in cases:
    p = np.zeros(9, np.float32)
    p[:len(params)] = params
    t = np.zeros(6, np.float32)
    t[:3] = trim
    ref = np.array([float(JS.intersectLocal(kind, jnp.asarray(p),
                                            jnp.asarray(t), jnp.asarray(oo),
                                            jnp.asarray(dd), 1e-4))
                    for oo, dd in zip(o[:8], d[:8])])
    port = TS.intersectLocal(kind, torch.as_tensor(p), torch.as_tensor(t),
                             torch.as_tensor(o[:8]), torch.as_tensor(d[:8]),
                             1e-4).numpy()
    np.testing.assert_allclose(port, ref, atol=1e-4)
  n = np.float32([0., 0., 1.])
  dIn = np.float32([0.3, 0., 0.9539392])
  np.testing.assert_allclose(
      TT.mirrorDirection(torch.as_tensor(dIn), torch.as_tensor(n)).numpy(),
      np.asarray(JT.mirrorDirection(jnp.asarray(dIn), jnp.asarray(n))),
      atol=1e-7)
  out, tir = TT.snell(torch.as_tensor(dIn), torch.as_tensor(n),
                      torch.tensor(1.), torch.tensor(1.5))
  rOut, rTir = JT.snell(jnp.asarray(dIn), jnp.asarray(n), 1., 1.5)
  np.testing.assert_allclose(out.numpy(), np.asarray(rOut), atol=1e-7)
  assert bool(tir) == bool(rTir)
