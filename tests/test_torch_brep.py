'''BRep ingest on the PyTorch port: the port's `geometry/brep.py` against the
JAX package's on the synthetic blobs of `fcstd_fixtures` (a box, a
cylinder, a sphere, the lens of the lens-and-mirror scene, a slotted and an
irregular plate, a paraboloid), record for record and surface for surface,
bit for bit; what each face becomes, held against its geometry; the
Locations section's records of both types; the blobs both refuse, with the
same words; and the slotted plate's trims on the port's intersectors.'''

import numpy as np
import pytest
import torch

import fcstd_fixtures as F
from optics_design_workbench_tpu.geometry import brep as jaxBrep
from optics_design_workbench_tpu_torch.geometry import brep as B
from optics_design_workbench_tpu_torch.geometry import intersect as I
from optics_design_workbench_tpu_torch.geometry import surfaces as S

torch.set_num_threads(1)

ROT = F.translation(5., -3., 2.) @ F.rotation((1., 2., 3.), 35.)
BLOBS = {
    'box': lambda: F.boxBlob(),
    'boxPlaced': lambda: F.boxBlob(location=ROT),
    'cylinder': lambda: F.cylinderBlob(),
    'sphere': lambda: F.sphereBlob(),
    'lens': lambda: F.lensBlob(),
    'lensPlaced': lambda: F.lensBlob(F.LENS_AT),
    'slot': lambda: F.platePolygonBlob(**F.SLOT_PLATE),
    'irregular': lambda: F.platePolygonBlob(**F.IRREGULAR_PLATE),
    'paraboloid': lambda: F.paraboloidBlob(),
}


@pytest.fixture(scope='module')
def converted():
  '''{name: (text, (port surfaces, notes), (JAX surfaces, notes))}, each
  blob written and converted once.'''
  out = {}
  for name, make in BLOBS.items():
    text = make()
    out[name] = (text, B.brepToSurfaces(text, elem=0),
                 jaxBrep.brepToSurfaces(text, elem=0))
  return out


def assertSurfacesEqual(port, ref):
  '''Surface dicts equal key for key: kind and elem; params, trim,
  transform and orient bit for bit; trimPrims and trimBitmap likewise.'''
  assert len(port) == len(ref)
  for a, b in zip(port, ref):
    assert sorted(a) == sorted(b)
    assert a['kind'] == b['kind'] and a['elem'] == b['elem']
    for key in ('params', 'trim', 'transform', 'orient'):
      np.testing.assert_array_equal(np.asarray(a[key]), np.asarray(b[key]))
    if 'trimPrims' in b:
      assert sorted(a['trimPrims']) == sorted(b['trimPrims'])
      for key, prims in b['trimPrims'].items():
        np.testing.assert_array_equal(np.asarray(a['trimPrims'][key]),
                                      np.asarray(prims))
    if 'trimBitmap' in b:
      assert sorted(a['trimBitmap']) == sorted(b['trimBitmap'])
      for key, value in b['trimBitmap'].items():
        got = np.asarray(a['trimBitmap'][key])
        assert got.dtype == np.asarray(value).dtype
        np.testing.assert_array_equal(got, np.asarray(value))


@pytest.mark.parametrize('name', sorted(BLOBS))
def test_parse_matches_reference(name, converted):
  text = converted[name][0]
  a, b = B.parseBRep(text), jaxBrep.parseBRep(text)
  for key in ('locations', 'curves2d', 'curves', 'surfaces', 'tshapes'):
    assert len(getattr(a, key)) == len(getattr(b, key)), key
  for la, lb in zip(a.locations, b.locations):
    np.testing.assert_array_equal(la, lb)
  assert a.roots == b.roots
  assert [(t.shapeType, t.flags, t.refs) for t in a.tshapes] == \
      [(t.shapeType, t.flags, t.refs) for t in b.tshapes]
  fa, fb = B.iterFaces(a), jaxBrep.iterFaces(b)
  assert len(fa) == len(fb) > 0
  for (ta, la, sa), (tb, lb, sb) in zip(fa, fb):
    assert sa == sb and ta.data['surf'] == tb.data['surf']
    np.testing.assert_array_equal(la, lb)


@pytest.mark.parametrize('name', sorted(BLOBS))
def test_surfaces_match_reference(name, converted):
  _text, (port, notes), (ref, refNotes) = converted[name]
  assert notes == refNotes
  assertSurfacesEqual(port, ref)


def test_faces_become_their_geometry(converted):
  '''What each fixture face becomes, held against the solid it bounds (so
  that both packages cannot agree on a wrong face).'''
  surfs, notes = converted['box'][1]
  assert notes == ['rect'] * 6 and {s['kind'] for s in surfs} == {S.PLANE}
  halves = sorted(tuple(sorted((float(s['trim'][1]), float(s['trim'][2]))))
                  for s in surfs)
  assert halves == [(5., 9.)] * 2 + [(5., 20.)] * 2 + [(9., 20.)] * 2
  for s in surfs:
    # the face's outward normal (orient x local +z) points away from the
    # box's centre (5, 9, 20)
    m = np.asarray(s['transform'])
    n = m[:3, 2] * float(s['orient'])
    assert n @ (m[:3, 3] - (5., 9., 20.)) > 0

  surfs, notes = converted['cylinder'][1]
  assert notes == ['zRange', 'disc/annulus', 'disc/annulus']
  assert surfs[0]['kind'] == S.CYLINDER and float(surfs[0]['params'][0]) == 9.
  np.testing.assert_allclose(np.asarray(surfs[0]['trim'])[:3], (0., 0., 14.))
  assert [float(s['trim'][2]) for s in surfs[1:]] == [9., 9.]

  surfs, notes = converted['sphere'][1]
  assert notes == ['zRange'] and float(surfs[0]['params'][0]) == 20.
  assert tuple(np.asarray(surfs[0]['trim'])[:3]) == (0., -20., 20.)

  # the lens: the cap of buildLensMirrorScene's sphere, its barrel from
  # the cap's rim to z = 6, the disc of radius 25 at z = 6 + 50
  surfs, notes = converted['lensPlaced'][1]
  assert notes == ['zRange', 'zRange', 'disc/annulus']
  cap, barrel, disc = surfs
  assert cap['kind'] == S.SPHERE and float(cap['params'][0]) == F.LENS_R
  np.testing.assert_allclose(np.asarray(cap['transform'])[:3, 3],
                             (0., 0., 50. + F.LENS_R), atol=1e-12)
  np.testing.assert_allclose(np.asarray(cap['trim'])[1:3],
                             (-F.LENS_R, F.LENS_SAG - F.LENS_R), atol=1e-9)
  np.testing.assert_allclose(np.asarray(barrel['trim'])[1:3],
                             (F.LENS_SAG, F.LENS_THICKNESS), atol=1e-9)
  np.testing.assert_allclose(np.asarray(disc['transform'])[:3, 3],
                             (0., 0., 56.), atol=1e-12)
  assert float(disc['trim'][2]) == pytest.approx(F.LENS_APERTURE, abs=1e-9)
  assert [float(s['orient']) for s in surfs] == [1., 1., 1.]

  # the slot: the plate's rectangle minus one rectangular hole
  surfs, notes = converted['slot'][1]
  (plate,) = surfs
  assert 'trimBitmap' not in plate and float(plate['trim'][0]) == 4.
  (hole,) = plate['trimPrims']['holes']
  assert hole[0] == 1. and sorted(np.abs(hole[3:5])) == \
      pytest.approx([2., 15.])
  surfs, notes = converted['irregular'][1]
  assert 'trimBitmap' in surfs[0] and notes[0].startswith('bitmap trim')

  # the paraboloid: ASPHERE k = -1 whose sag is the parabola's
  surfs, notes = converted['paraboloid'][1]
  (dish,) = surfs
  assert dish['kind'] == S.ASPHERE and notes == ['rRange']
  assert float(dish['params'][1]) == -1.
  assert float(dish['params'][0]) == pytest.approx(1. / 50.)
  rec = next(r for r in B.parseBRep(converted['paraboloid'][0]).surfaces)
  P = B.evalSurface(rec, np.linspace(0, 2 * np.pi, 9),
                    np.linspace(.5, 20., 7)).reshape(-1, 3)
  inv = np.linalg.inv(dish['transform'])
  pl = P @ inv[:3, :3].T + inv[:3, 3]
  sag = float(dish['params'][0]) * (pl[:, 0] ** 2 + pl[:, 1] ** 2) / 2.
  assert np.abs(pl[:, 2] - sag).max() < 1e-9


def test_locations_of_both_record_types(converted):
  '''A placed blob's root location is two type 1 records composed by a
  type 2 record with a power of 2: both parsers read the same matrices,
  the root is the placement, and every surface is the unplaced blob's
  moved by it (analytic kinds keep their trims).'''
  for name, m in (('lensPlaced', F.LENS_AT), ('boxPlaced', ROT)):
    text = converted[name][0]
    assert '\n2  1 2 2 1 0\n' in text
    brep = B.parseBRep(text)
    assert len(brep.locations) == 4
    np.testing.assert_allclose(brep.locations[3], m, atol=1e-12)
    (_sign, _idx, loc), = brep.roots
    assert loc == 3
    placed = converted[name][1][0]
    bare = converted[name.replace('Placed', '')][1][0]
    for a, b in zip(placed, bare):
      np.testing.assert_allclose(np.asarray(a['transform']),
                                 m @ np.asarray(b['transform']), atol=1e-9)
      np.testing.assert_allclose(np.asarray(a['trim']), np.asarray(b['trim']),
                                 atol=1e-9)


def _refusal(module, text):
  with pytest.raises(ValueError) as e:
    module.brepToSurfaces(text, elem=0)
  return str(e.value)


@pytest.mark.parametrize('case', ['triangulationOnly', 'noHeader', 'noFaces',
                                  'noSurfaces'])
def test_refusals_use_the_reference_words(case):
  bw = F.BRepWriter()
  if case == 'noFaces':
    # surface geometry, but the root is a wire
    bw.plane(np.zeros(3), F.EX, F.EY)
    v = bw.vertex((0., 0., 0.))
    w = bw.vertex((1., 0., 0.))
    e = bw.edge(v, w, bw.line3((0., 0., 0.), F.EX), 0., 1.)
    text = bw.text(bw.wire([(+1, e)]))
  elif case == 'noSurfaces':
    text = bw.text(bw.vertex((0., 0., 0.)))
  else:
    text = dict(triangulationOnly=F.BREP_TRIANGULATION_ONLY,
                noHeader='Locations 0\nTShapes 0\n')[case]
  words = dict(triangulationOnly='not a CASCADE Topology V1 BRep blob',
               noHeader='not a CASCADE Topology V1 BRep blob',
               noFaces='BRep blob contains no faces',
               noSurfaces='BRep blob contains no surface geometry')[case]
  assert _refusal(B, text) == _refusal(jaxBrep, text) == words


def test_slot_plate_passes_rays_through_the_slot(converted):
  '''The slot plate's trim primitives on the port's intersectors: rays from
  below aimed into the slot pass the plate, rays aimed at the plate's
  material stop there (the case of tests/test_brep.py's boolean slot).'''
  surfs = [dict(s) for s in converted['slot'][1][0]]
  table = S.buildSurfaceTable(surfs)
  table = dict(table, byKind=S.byKind(table, 'cpu'))
  rng = np.random.default_rng(5)
  inSlot = np.stack([rng.uniform(-1.9, 1.9, 64), rng.uniform(-14.9, 14.9, 64),
                     np.zeros(64)], 1)
  onPlate = np.stack([rng.uniform(-24.9, 24.9, 256),
                      rng.uniform(-24.9, 24.9, 256), np.zeros(256)], 1)
  onPlate = onPlate[(np.abs(onPlate[:, 0]) > 2.1)
                    | (np.abs(onPlate[:, 1]) > 15.1)]
  origin = np.array([0.3, -0.2, -40.])
  for targets, hit in ((inSlot, False), (onPlate, True)):
    d = targets - origin
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = torch.as_tensor(np.broadcast_to(origin, d.shape).copy(),
                        dtype=torch.float32)
    t = I.allDistances(table, o, torch.as_tensor(d, dtype=torch.float32),
                       1e-6)[0].numpy()
    assert np.isfinite(t).all() == hit and np.isfinite(t).any() == hit
    if hit:
      np.testing.assert_allclose(t, -origin[2] / d[:, 2], rtol=1e-5)
