'''Triangle meshes on the PyTorch port, host side: the port's
`geometry/mesh.py` loaders and `meshSurfaces` against the JAX package's on
the same files (the cases of tests/test_mesh.py), the triangle table and
its chunk boxes (`cuda_trace._packTable`) against the JAX package's
`pallas_trace._sceneRows(..., smemTris=True)` bit for bit, and the
refusals of meshes past 128 triangles with the JAX package's own words.'''

import numpy as np
import pytest

import torch_port_helpers as H
from optics_design_workbench_tpu.geometry import mesh as jaxMesh
from optics_design_workbench_tpu.ops import pallas_trace
from optics_design_workbench_tpu.tracing import fused as jaxFused
from optics_design_workbench_tpu_torch import benchmarks as B
from optics_design_workbench_tpu_torch import convert
from optics_design_workbench_tpu_torch.geometry import mesh as M
from optics_design_workbench_tpu_torch.geometry import surfaces as S
from optics_design_workbench_tpu_torch.geometry import transforms as T
from optics_design_workbench_tpu_torch.models import OpticalGroup, Scene
from optics_design_workbench_tpu_torch.ops import cuda_trace

QUAD = np.array([[-10., -10., 0.], [10., -10., 0.], [10., 10., 0.],
                 [-10., 10., 0.]])
QUAD_FACES = np.array([[0, 1, 2], [0, 2, 3]])


def _asciiSTL(path):
  verts = QUAD[QUAD_FACES].reshape(-1, 3)
  lines = ['solid quad']
  for i in range(0, len(verts), 3):
    lines += ['facet normal 0 0 1', 'outer loop']
    lines += [f'vertex {x} {y} {z}' for x, y, z in verts[i:i + 3]]
    lines += ['endloop', 'endfacet']
  path.write_text('\n'.join(lines + ['endsolid quad']))


def _obj(path):
  path.write_text('v -1 -1 0\nv 1 -1 0\nv 1 1 0\nv -1 1 0\nv 0 0 2\n'
                  'f 1/1/1 2/2/2 3/3/3 4/4/4\nf -1 1 2\n')


BREP_V2 = '''DBRep_DrawableShape
Triangulations 1
4 2 1 0.01
-10 -10 0 10 -10 0 10 10 0 -10 10 0
0 0 1 0 1 1 0 1
1 2 3 1 3 4
'''

# OCC >= 7.6: a normals flag follows the deflection
BREP_V3 = '''DBRep_DrawableShape
Triangulations 1
4 2 0 0.01 1
-10 -10 0 10 -10 0 10 10 0 -10 10 0
0 0 1 0 0 1 0 0 1 0 0 1
1 2 3 1 3 4
'''


@pytest.mark.parametrize('case', ['binarySTL', 'asciiSTL', 'obj'])
def test_loaders_match_reference(case, tmp_path):
  path = tmp_path / 'mesh'
  if case == 'binarySTL':
    M.writeBinarySTL(path, QUAD, QUAD_FACES)
    load, loadRef = M.loadSTL, jaxMesh.loadSTL
  elif case == 'asciiSTL':
    _asciiSTL(path)
    load, loadRef = M.loadSTL, jaxMesh.loadSTL
  else:
    _obj(path)
    load, loadRef = M.loadOBJ, jaxMesh.loadOBJ
  (v, f), (vRef, fRef) = load(path), loadRef(path)
  np.testing.assert_array_equal(v, vRef)
  np.testing.assert_array_equal(f, fRef)
  assert f.shape == ((3, 3) if case == 'obj' else (2, 3))
  if case == 'binarySTL':
    np.testing.assert_array_equal(v[f], QUAD[QUAD_FACES])
  if case == 'obj':                        # the fan and a negative index
    np.testing.assert_array_equal(f, [[0, 1, 2], [0, 2, 3], [4, 0, 1]])


@pytest.mark.parametrize('text', [BREP_V2, BREP_V3], ids=['v2', 'v3'])
def test_brep_triangulations_match_reference(text):
  out, ref = M.parseBRepTriangulations(text), \
      jaxMesh.parseBRepTriangulations(text)
  assert len(out) == len(ref) == 1
  for (v, f), (vRef, fRef) in zip(out, ref):
    np.testing.assert_array_equal(v, vRef)
    np.testing.assert_array_equal(f, fRef)
  surfs = M.brepMeshSurfaces(text, elem=0, transform=T.translation(0, 0, 5))
  surfsRef = jaxMesh.brepMeshSurfaces(text, elem=0,
                                      transform=T.translation(0, 0, 5))
  for a, b in zip(surfs, surfsRef):
    np.testing.assert_array_equal(a['params'], b['params'])


@pytest.mark.parametrize('text, match', [
    ('DBRep_DrawableShape\nTShapes 3\n', 'no Triangulations'),
    ('Triangulations 0\n', '0 triangulations')])
def test_brep_without_triangulation_raises(text, match):
  for parse in (M.parseBRepTriangulations,
                jaxMesh.parseBRepTriangulations):
    with pytest.raises(ValueError, match=match):
      parse(text)


def test_mesh_surfaces_match_reference():
  place = T.compose(T.translation(3., -2., 5.), T.rotation((1, 1, 0), 30.))
  for orient in (1, -1):
    surfs = M.meshSurfaces(QUAD, QUAD_FACES, elem=0, transform=place,
                           orient=orient)
    ref = jaxMesh.meshSurfaces(QUAD, QUAD_FACES, elem=0, transform=place,
                               orient=orient)
    assert len(surfs) == 2 and all(s['kind'] == S.TRIANGLE for s in surfs)
    for a, b in zip(surfs, ref):
      for k in ('kind', 'params', 'trim', 'transform', 'orient'):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
  with pytest.raises(ValueError, match='out of range'):
    M.meshSurfaces(QUAD, [[0, 1, 9]], elem=0)
  with pytest.raises(ValueError, match=r'\(V, 3\)'):
    M.meshSurfaces(QUAD[:, :2], QUAD_FACES, elem=0)


def stlSphereScene(tmpdir):
  '''A UV sphere (224 triangles) written as a binary STL, loaded with
  `loadSTL`, and placed by its group's rotated and shifted placement (so
  its rows carry a transform the triangle table maps out).'''
  tris = H.uvSphereTriangles(12.)
  path = tmpdir / 'sphere.stl'
  M.writeBinarySTL(path, tris.reshape(-1, 3),
                   np.arange(3 * len(tris)).reshape(-1, 3))
  v, f = M.loadSTL(path)
  scene = Scene(label='stl_sphere')
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Mirror', Label='Ball', surfaces=M.meshSurfaces(v, f, 0),
      placements=[T.compose(T.translation(5., -3., 60.),
                            T.rotation((0.3, 1., 0.2), 37.))]))
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Absorber', Label='Det',
      surfaces=[S.plane(np.eye(4), elem=0, halfExtents=(200., 200.))]))
  return scene


TABLE_SCENES = {'dish200': lambda tmp: B.buildMeshDishScene(10),
                'dish1800': lambda tmp: B.buildMeshDishScene(30),
                'stlSphere': stlSphereScene}


def _referenceTables(jaxScene, bounds=(-200., 200., -200., 200.)):
  device, info = jaxScene.compile(devicePut=False)
  histSpec = jaxFused.makeHistogramSpec(device, info, bounds=bounds,
                                        bins=(8, 8))
  parts = pallas_trace._sceneRows(device, histSpec, smemTris=True)
  histNp = dict(elemToDet=np.asarray(histSpec['elemToDet']),
                bounds=np.asarray(histSpec['bounds']),
                bins=tuple(histSpec['bins']))
  return device, histNp, parts[3], parts[4]


@pytest.mark.parametrize('name', sorted(TABLE_SCENES))
def test_triangle_table_matches_reference_bit_for_bit(name, tmp_path):
  scene = TABLE_SCENES[name](tmp_path)
  device, histNp, triRef, boxRef = _referenceTables(
      H.jaxSceneFromPort(scene))
  # the JAX package's compiled arrays, packed by the port
  sceneNp, histSpec = convert._sceneAndSpec(device, histNp)
  _table, facts = cuda_trace._packTable(sceneNp, histSpec)
  # the port's own compile of the same scene
  portNp, info = scene.compile(device=None)
  _table, own = cuda_trace._packTable(portNp, histSpec)
  nTri = len(triRef)
  assert nTri > cuda_trace.TABLE_TRIANGLES and len(boxRef) == -(-nTri // 32)
  for f in (facts, own):
    assert f['nTri'] == nTri and f['nTriChunks'] == len(boxRef)
    assert f['triTable'].dtype == np.float32 == f['triBoxes'].dtype
    np.testing.assert_array_equal(f['triTable'].view(np.uint32),
                                  triRef.view(np.uint32))
    np.testing.assert_array_equal(f['triBoxes'].view(np.uint32),
                                  boxRef.view(np.uint32))
    # the table's triangles leave the surface rows; what stays is plain
    assert f['nSurf'] == 1 and not f['geom']


def _jaxDish(nQ):
  return H.jaxSceneFromPort(B.buildMeshDishScene(nQ)).compile(
      devicePut=False)[0]


def test_mesh_refusals_use_the_reference_words():
  device = _jaxDish(10)
  S_ = len(device['surfaces']['kind'])
  seq = dict(device, seqMask=np.ones((2, S_), bool))
  mask = np.ones(S_, bool)
  mask[7] = False
  masked = dict(device, surfMask=mask)
  for scene, words in ((seq, 'with sequential mode'),
                       (masked, 'per-source ignore mask on mesh surfaces')):
    sceneNp, _h = convert._sceneAndSpec(scene, dict(
        elemToDet=np.zeros(2, int), bounds=np.zeros((1, 4)), bins=(8, 8)))
    reason = cuda_trace.ineligibleReason(sceneNp)
    assert words in reason
    assert reason == pallas_trace.pallasIneligibleReason(scene)
  # a mask that leaves the mesh whole is no refusal (the detector plane is
  # the table's first surface)
  mask = np.ones(S_, bool)
  mask[0] = False
  sceneNp, _h = convert._sceneAndSpec(dict(device, surfMask=mask), dict(
      elemToDet=np.zeros(2, int), bounds=np.zeros((1, 4)), bins=(8, 8)))
  assert cuda_trace.ineligibleReason(sceneNp) is None


def test_large_meshes_are_eligible_and_analytic_rows_stay_capped():
  big, _info = B.buildMeshDishScene(80).compile(device=None)
  assert cuda_trace.tableTriangles(big) == 12800
  assert cuda_trace.ineligibleReason(big) is None
  assert not cuda_trace.needsGeom(big)
  assert 'SMEM' in pallas_trace.pallasIneligibleReason(_jaxDish(80))
  # 128 triangles stay surface rows (the GEOM instance), as before
  small = dict(big, surfaces={k: v[:129] for k, v in big['surfaces'].items()})
  assert (small["surfaces"]["kind"] == S.TRIANGLE).sum() == 128
  assert cuda_trace.tableTriangles(small) == 0 and cuda_trace.needsGeom(small)
  # 257 analytic rows beside a table mesh ride the surface table (ROADMAP
  # B8); 257 that stay surface rows are refused with the reference's words
  S_ = cuda_trace.MAX_SURFACES + 1
  planes = lambda trim0: dict(
      packed=np.zeros((S_, 24), np.float32),
      trim=np.tile(np.float32([trim0, 0., 1., 0., 0., 0.]), (S_, 1)),
      kind=np.zeros(S_, np.int32))
  many = lambda trim0: dict(big, surfaces={
      k: np.concatenate([big['surfaces'][k], planes(trim0)[k]])
      for k in ('packed', 'trim', 'kind')})
  assert cuda_trace.ineligibleReason(many(0.)) is None
  assert cuda_trace.tableSurfaces(many(0.)).sum() == S_ + 1
  reason = cuda_trace.ineligibleReason(dict(
      many(3.), surfaces=dict(many(3.)['surfaces'],
                              trimPrims=np.zeros((12800 + S_ + 1, 4, 7)))))
  assert f'{S_} analytic surfaces with bitmap/prim trims' in reason


# chip_smoke.py REF_DISH: the JAX package's fused step on the 1800-triangle
# dish at 65,536 rays, seed 0 (its XLA path: its kernel holds that mesh in
# scalar memory only on the TPU)
REF_DISH_RAYS = 1 << 16
REF_DISH = dict(share=1.0, power=1.0, r2=3966.9451117515564,
                r4=35904789.590858854)


def test_dish_statistics_of_reference():
  '''The detected share, mean power and r^2 moments the card's run of the
  1800-triangle dish is held to (3 sigma) are the JAX package's.'''
  scene = H.jaxSceneFromPort(B.buildMeshDishScene(30))
  ref = H.fusedStatsOfReference(scene, H.MESH_BOUNDS, 3, REF_DISH_RAYS)
  for k, v in REF_DISH.items():
    assert ref[k] == pytest.approx(v, abs=1e-9), k
