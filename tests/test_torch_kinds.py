'''The other surface kinds (B2) and trims (B3) surface by surface: the port's
plain `_intersectPlain` and its winner normal against the JAX package's
Pallas kernel constants (`pallas_trace._intersectConst` / `_normalConst`),
both run eagerly on the CPU on the same 4,096 seeded rays (the JAX columns
shaped (32, 128), the layout its bitmap lookup loops over), and the host
side: `_conicAsQuadric` and the surface table's order against the JAX
`buildSurfaceTable`.

Tolerances: t within rtol 1e-5 and normals within atol 1e-5 of the
reference, at most 2 of 4,096 rays flipping between hit and miss. The JAX
package's CPU arithmetic contracts a * b + c into one rounding and turns a
division by a constant into a multiply by its reciprocal, so its roots
differ from the port's by a few ulps; a torus root that is double (a ray
grazing the tube, the quartic's polish reaches ~sqrt(eps) there, as the
reference documents) is held to rtol 1e-3 where the ray meets the surface
at a cosine below 0.05, and a torus root, found from the ray's closest
approach to the centre, relative to that approach's distance where it is
the larger.'''

import numpy as np
import pytest
import torch

import torch_port_helpers as H

torch.set_num_threads(1)

N = 4096

_CASES = {}


def _scenes():
  from optics_design_workbench_tpu_torch import benchmarks as B
  return {'kinds': lambda: (B.buildKindsScene(), (-300., 300., -300., 300.)),
          'meshFold': lambda: (B.buildMeshFoldScene(),
                               (-300., 300., -300., 300.)),
          'bitmapSlot': lambda: (B.buildBitmapSlotScene(),
                                 (-300., 300., -300., 300.)),
          'primSlot': lambda: (B.buildPrimSlotScene(),
                               (-300., 300., -300., 300.)),
          'chartTrims': lambda: H.buildChartTrimsScene(H.torchNs())[:2]}


def _case(name):
  '''(port tables, reference rows, reference bitmaps) of a scene.'''
  if name not in _CASES:
    from optics_design_workbench_tpu.ops import pallas_trace
    from optics_design_workbench_tpu_torch import convert
    scene, bounds = _scenes()[name]()
    jaxScene = H.jaxSceneFromPort(scene)
    deviceNp, histNp, spec = H.referenceArrays(jaxScene, bounds)
    tables = convert.sceneFromReference(deviceNp, histNp, device='cpu')
    rows, _elems, masks = pallas_trace._sceneRows(deviceNp, histNp)
    _CASES[name] = (tables, rows, masks)
  return _CASES[name]


SURFACES = [('kinds', s) for s in range(7)] \
    + [('meshFold', s) for s in range(2)] \
    + [('bitmapSlot', 0), ('primSlot', 0)] \
    + [('chartTrims', s) for s in range(10)]


def _rays(rows, s, seed):
  '''4,096 rays from points scattered about the surface's frame origin
  towards points near it (both packages' float32 columns).'''
  r = rows[s]
  R = np.array([[r['r00'], r['r01'], r['r02']], [r['r10'], r['r11'], r['r12']],
                [r['r20'], r['r21'], r['r22']]])
  centre = R.T @ -np.array([r['t0'], r['t1'], r['t2']])
  if r['kind'] == 4:                       # a triangle: its centroid
    centre = np.array([r[f'p{k}'] for k in range(9)]).reshape(3, 3).mean(0)
  rng = np.random.default_rng(seed)
  o = centre + rng.normal(size=(N, 3)) * 40.
  d = centre + rng.normal(size=(N, 3)) * 12. - o
  d /= np.linalg.norm(d, axis=1, keepdims=True)
  return [np.ascontiguousarray(x, np.float32) for x in (*o.T, *d.T)]


def _rowsOf(tables):
  from optics_design_workbench_tpu_torch.ops import cuda_trace as CT
  tab = tables['table'].numpy()
  cols = CT.SURF_COLS + (CT.GEOM_COLS if tables['geom'] else 0)
  return tab, tab[:tables['nSurf'] * cols].reshape(tables['nSurf'], cols)


@pytest.mark.parametrize('scene,surface', SURFACES)
def test_intersect_and_normal_match_reference(scene, surface):
  import jax.numpy as jnp
  from optics_design_workbench_tpu.ops import pallas_trace
  from optics_design_workbench_tpu_torch.ops import cuda_trace as CT
  tables, rows, masks = _case(scene)
  tab, surfT = _rowsOf(tables)
  assert tables['geom'] and int(surfT[surface, 0]) == rows[surface]['kind']
  cols = _rays(rows, surface, seed=surface)
  tP = CT._intersectPlain(surfT[surface], *(torch.as_tensor(c) for c in cols),
                          1e-4, tab).numpy()
  jc = [jnp.asarray(c.reshape(32, 128)) for c in cols]
  tJ = np.asarray(pallas_trace._intersectConst(rows[surface], *jc, 1e-4,
                                               masks)).reshape(-1)
  hitJ, hitP = tJ < 1e30, tP < 1e30
  assert hitJ.sum() > 100, 'too few rays meet the surface'
  assert int((hitJ != hitP).sum()) <= 2
  both = hitJ & hitP
  # the normal at the reference's hit point, and the cosine it meets
  t = np.where(both, tJ, 0.).astype(np.float32)
  p = [cols[k] + t * cols[3 + k] for k in range(3)]
  R = surfT[surface, 1:10].astype(np.float32)
  off = surfT[surface, 10:13]
  loc = [R[3 * k] * p[0] + R[3 * k + 1] * p[1] + R[3 * k + 2] * p[2] + off[k]
         for k in range(3)]
  nJ = np.stack([np.asarray(v).reshape(-1) for v in pallas_trace._normalConst(
      rows[surface], *(jnp.asarray(v.reshape(32, 128)) for v in loc))])
  row = torch.as_tensor(np.repeat(surfT[surface:surface + 1], N, 0))
  zero = torch.zeros(N)
  nP = torch.stack(CT._geomNormalPlain(
      row, row[:, 0], *(torch.as_tensor(v) for v in loc),
      zero, zero, zero + 1.)).numpy()
  if rows[surface]['kind'] in (0, 1, 2):     # the kernels' own normals
    kind = rows[surface]['kind']
    if kind == 1:
      nP = np.stack(loc) / np.linalg.norm(np.stack(loc), axis=0)
    elif kind == 2:
      xy = np.stack([loc[0], loc[1], np.zeros_like(loc[0])])
      nP = xy / np.linalg.norm(xy, axis=0)
  np.testing.assert_allclose(nP[:, both], nJ[:, both], rtol=0., atol=1e-5)
  scale = np.abs(tJ[both])
  torus = rows[surface]['kind'] == 7
  if torus:
    # the torus re-anchors the ray at its closest approach to the centre:
    # a root carries the anchor's ulps
    lo = [R[3 * k] * cols[0] + R[3 * k + 1] * cols[1]
          + R[3 * k + 2] * cols[2] + off[k] for k in range(3)]
    ld = [R[3 * k] * cols[3] + R[3 * k + 1] * cols[4]
          + R[3 * k + 2] * cols[5] for k in range(3)]
    tMid = -sum(a * b for a, b in zip(lo, ld)) / sum(b * b for b in ld)
    scale = np.maximum(scale, np.abs(tMid[both]))
  rel = np.abs(tP[both] - tJ[both]) / scale
  d = np.stack(cols[3:])[:, both]
  cosInc = np.abs((d * nJ[:, both]).sum(axis=0))
  tol = np.where(torus & (cosInc < 0.05), 1e-3, 1e-5)
  assert (rel <= tol).all(), (rel.max(), cosInc[np.argmax(rel - tol)])


def test_conic_rewrite_and_table_order_match_reference():
  '''`_conicAsQuadric` rewrites exactly what the JAX package rewrites (an
  exact conic becomes a quadric with the z band of its radial trim; a
  polynomial asphere, a bitmap-trimmed conic and a flat one stay), and the
  kind-sorted surface table — kinds, params, trims, transforms, bitmap and
  primitive stacks — equals the JAX `buildSurfaceTable`'s.'''
  import copy
  from optics_design_workbench_tpu.geometry import surfaces as JS
  from optics_design_workbench_tpu_torch.geometry import surfaces as PS
  T = H.torchNs().T
  slot = dict(mask=np.eye(8, dtype=np.uint8), u0=-1., v0=-1., invDu=4.,
              invDv=4.)
  surfs = [PS.asphere(T.translation(0, 0, 5), 0, 1. / 50., conic=-0.5,
                      rMax=10.),
           PS.asphere(np.eye(4), 1, -1. / 30., conic=-1., rMin=2.),
           PS.asphere(np.eye(4), 2, 1. / 20., conic=-3.),
           PS.asphere(np.eye(4), 3, 1. / 40., coeffs=(1e-6,), rMax=8.),
           PS.asphere(np.eye(4), 4, 0., rMax=8.),
           dict(PS.asphere(np.eye(4), 5, 1. / 60., rMax=9.),
                trimBitmap=slot),
           PS.torus(np.eye(4), 6, 30., 8.),
           dict(PS.plane(T.translation(1, 2, 3), 7, radius=5.),
                trimPrims=dict(holes=[(2., 0., 0., 1., 0., 0., 0.)])),
           PS.cone(np.eye(4), 8, 3., 0.2, (0., 4.)),
           PS.triangle((0, 0, 0), (1, 0, 0), (0, 1, 0), 9),
           PS.sphere(np.eye(4), 10, 7.)]
  for s in surfs:
    mine, ref = PS._conicAsQuadric(dict(s)), JS._conicAsQuadric(dict(s))
    assert mine['kind'] == ref['kind']
    np.testing.assert_array_equal(mine['params'], ref['params'])
    np.testing.assert_array_equal(mine['trim'], ref['trim'])
  assert [PS._conicAsQuadric(dict(s))['kind'] for s in surfs[:6]] \
      == [PS.QUADRIC] * 3 + [PS.ASPHERE] * 3
  own = PS.buildSurfaceTable(copy.deepcopy(surfs))
  ref = JS.buildSurfaceTable(copy.deepcopy(surfs), devicePut=False)
  for k in ('kind', 'elem', 'params', 'trim', 'packed', 'orient',
            'trimMasks', 'trimMaskIdx', 'trimPrims'):
    np.testing.assert_array_equal(own[k], np.asarray(ref[k]), err_msg=k)
