'''The surface table (B8) on the PyTorch port, host side: the table, its
runs and chunk boxes (`cuda_trace._packTable`) against the JAX package's
`pallas_trace._sceneRows(..., smemSurfs=True)` bit for bit, the invariants
of `_chunkSurfRows` (the reference's own host test), never-hit padding rows,
what is eligible and what is refused with the reference's words, the
tables a sweep stacks, and the statistics the card's run of the wall is
held to.'''

import numpy as np
import pytest
import torch

import torch_port_helpers as H
from optics_design_workbench_tpu.ops import pallas_trace
from optics_design_workbench_tpu.tracing import fused as jaxFused
from optics_design_workbench_tpu_torch import benchmarks as B
from optics_design_workbench_tpu_torch import convert
from optics_design_workbench_tpu_torch.geometry import surfaces as S
from optics_design_workbench_tpu_torch.ops import cuda_trace

TABLE_SCENES = ('wall', 'slabArray', 'coneQuadric', 'tie', 'bothTables')


def _referenceTables(jaxScene, bounds):
  '''(the JAX package's numpy scene, histogram spec, its surface table,
  plain runs, chunk boxes and chunked runs).'''
  device, info = jaxScene.compile(devicePut=False)
  histSpec = jaxFused.makeHistogramSpec(device, info, bounds=bounds,
                                        bins=(8, 8))
  parts = pallas_trace._sceneRows(
      device, histSpec, smemTris=cuda_trace.tableTriangles(device) > 0,
      smemSurfs=True)
  histNp = dict(elemToDet=np.asarray(histSpec['elemToDet']),
                bounds=np.asarray(histSpec['bounds']),
                bins=tuple(histSpec['bins']))
  return (device, histNp) + tuple(parts[-4:])


@pytest.mark.parametrize('name', TABLE_SCENES)
def test_surface_table_matches_reference_bit_for_bit(name):
  scene, bounds, _maxI = H.SURFACE_TABLE_SCENES[name](H.torchNs())
  device, histNp, tabRef, plainRef, boxRef, chunkRef = _referenceTables(
      H.jaxSceneFromPort(scene), bounds)
  # the JAX package's compiled arrays packed by the port, and the port's
  # own compile of the same scene
  sceneNp, histSpec = convert._sceneAndSpec(device, histNp)
  portNp, _info = scene.compile(device=None)
  for np_ in (sceneNp, portNp):
    _table, f = cuda_trace._packTable(np_, histSpec)
    assert f['nSurfTable'] == len(tabRef) > 0
    assert f['nSurfChunks'] == len(boxRef)
    assert f['surfTable'].dtype == np.float32 == f['surfBoxes'].dtype
    np.testing.assert_array_equal(f['surfTable'].view(np.uint32),
                                  tabRef.view(np.uint32))
    np.testing.assert_array_equal(f['surfBoxes'].view(np.uint32),
                                  boxRef.view(np.uint32))
    assert f['surfPlainRuns'] == plainRef
    assert f['surfChunkRuns'] == chunkRef
    # what stays a surface row: the complex rows only
    kinds = np.asarray(np_['surfaces']['kind'])
    assert f['nSurf'] == len(kinds) - int(cuda_trace.tableSurfaces(
        np_).sum()) - cuda_trace.tableTriangles(np_)
  if name == 'wall':
    # 520 discs in 33 chunks of 16, the cap's and the detector's plain runs
    assert f['nSurf'] == 0 and not f['geom']
    assert chunkRef == ((S.PLANE, 0., 0, 33, 0),)
    assert plainRef == ((S.PLANE, 1., 528, 529), (S.SPHERE, 0., 529, 530))
  if name == 'coneQuadric':
    kindsIn = {k for k, *_r in plainRef} | {k for k, *_r in chunkRef}
    assert kindsIn == set(cuda_trace.TABLE_SURF_KINDS)
  if name == 'bothTables':
    assert f['nTri'] == 200 and f['nSurfTable'] > 0


def _planeEntry(rng, radius):
  row = np.zeros(21, np.float32)
  row[0] = row[4] = row[8] = 1.
  row[9:12] = rng.uniform(-50., 50., 3)
  row[12] = 1.
  row[20] = radius                       # a disc of this radius
  return (S.PLANE, 0., row, (np.asarray(-row[9:12], float), radius))


def test_chunking_host_invariants():
  '''`_chunkSurfRows` (the reference's test_smem_surface_chunking_host_
  invariants): a long run with bounding spheres is Morton-chunked at a
  fixed stride, padded with never-hit rows; every real row appears once;
  each chunk box holds its members' spheres; a run without spheres stays
  plain; equal to the JAX package's `_chunkSurfRows` bit for bit.'''
  rng = np.random.default_rng(5)
  entries = [_planeEntry(rng, 5.) for _ in range(80)]
  rowU = np.zeros(21, np.float32)
  rowU[0] = rowU[4] = rowU[8] = 1.
  rowU[12], rowU[20] = 1., 1e30
  entries.append((S.PLANE, 1., rowU, None))   # unbounded window: plain
  table, plain, boxes, chunkRuns = cuda_trace._chunkSurfRows(entries)
  ref = pallas_trace._chunkSurfRows(entries)
  np.testing.assert_array_equal(table.view(np.uint32), ref[0].view(np.uint32))
  np.testing.assert_array_equal(boxes.view(np.uint32), ref[2].view(np.uint32))
  assert (plain, chunkRuns) == (ref[1], ref[3])
  assert len(chunkRuns) == 1 and len(plain) == 1
  _kind, _t0, c0, c1, rowStart = chunkRuns[0]
  nCh = c1 - c0
  assert nCh == -(-80 // cuda_trace._SURF_CHUNK) and len(boxes) == nCh
  block = table[rowStart:rowStart + nCh * cuda_trace._SURF_CHUNK]
  real = block[np.abs(block[:, 20] - 5.) < 1e-6]
  assert len(real) == 80
  assert sorted(map(tuple, real[:, 9:12].tolist())) == sorted(
      map(tuple, np.stack([e[2][9:12] for e in entries[:80]]).tolist()))
  for c in range(nCh):
    rows = block[c * 16:(c + 1) * 16]
    cen = -rows[np.abs(rows[:, 20] - 5.) < 1e-6][:, 9:12]
    assert (cen - 5. >= boxes[c, :3] - 1e-3).all()
    assert (cen + 5. <= boxes[c, 3:] + 1e-3).all()
  # a run of 16 rows or fewer stays plain even with spheres
  short = cuda_trace._chunkSurfRows(entries[:16])
  assert short[1] == ((S.PLANE, 0., 0, 16),) and not len(short[2])


@pytest.mark.parametrize('kind, trim0', [(0, 0.), (0, 1.), (1, 0.), (1, 1.),
                                         (2, 0.), (2, 1.), (5, 0.), (5, 1.),
                                         (6, 0.), (6, 1.)])
def test_padding_rows_are_never_hit(kind, trim0):
  '''The padding row of every kind and trim of the table, through the
  port's plain table intersection, misses 4,096 random rays.'''
  rng = np.random.default_rng(kind * 10 + int(trim0))
  row = torch.as_tensor(cuda_trace._dummySurfRow(kind, trim0))
  o = torch.as_tensor(rng.uniform(-20., 20., (3, 4096)), dtype=torch.float32)
  d = rng.normal(size=(3, 4096))
  d = torch.as_tensor(d / np.linalg.norm(d, axis=0), dtype=torch.float32)
  t = cuda_trace._tableIntersectPlain(kind, trim0, list(row), *o, *d,
                                      1e-4)[0]
  assert float(t.min()) >= 0.5 * cuda_trace._BIG
  np.testing.assert_array_equal(row.numpy(),
                                pallas_trace._dummySurfRow(kind, trim0))


def _compiled(build):
  scene = build()
  return scene.compile(device=None)[0]


def test_walls_and_both_tables_are_eligible():
  for build, nSurf in ((B.buildSurfWallScene, 522),
                       (B.buildSurfWall5kScene, 5071)):
    sceneNp = _compiled(build)
    assert len(sceneNp['surfaces']['kind']) == nSurf
    assert cuda_trace.ineligibleReason(sceneNp) is None
    assert cuda_trace.tableSurfaces(sceneNp).all()
    assert not cuda_trace.needsGeom(sceneNp)
  both = _compiled(lambda: H.buildBothTablesScene(H.torchNs())[0])
  assert cuda_trace.ineligibleReason(both) is None
  assert cuda_trace.tableTriangles(both) == 200
  assert cuda_trace.tableSurfaces(both).sum() == 257
  # 256 analytic surfaces (and triangles beside them) stay surface rows
  keep = np.r_[0:256, 257:457]          # all but one analytic surface
  assert (both['surfaces']['kind'][keep] != S.TRIANGLE).sum() == 256
  small = dict(both, surfaces={k: v[keep] for k, v in
                               both['surfaces'].items()})
  assert not cuda_trace.tableSurfaces(small).any()


def _manyPlanes(n, trim0=0.):
  trim = np.zeros((n, 6), np.float32)
  trim[:, 0], trim[:, 2] = trim0, 1.
  return dict(packed=np.zeros((n, 24), np.float32), trim=trim,
              kind=np.zeros(n, np.int32),
              trimPrims=np.zeros((n, 4, 7), np.float32))


def test_refusals_use_the_reference_words():
  '''Past 256 analytic surfaces the reference refuses more than 256 rows
  that cannot ride its table (bitmap / primitive trims, iterative kinds),
  and sequential mode or a source mask; the port refuses the same scenes
  with the same words, and takes 257 plain discs.'''
  elements = dict(packed=np.zeros((1, 11), np.float32),
                  optType=np.full(1, 3, np.int32),
                  recordHits=np.zeros(1, bool))
  plain = dict(surfaces=_manyPlanes(257), elements=elements)
  assert cuda_trace.ineligibleReason(plain) is None
  assert pallas_trace.pallasIneligibleReason(plain) is None
  complexRows = dict(surfaces={k: np.concatenate([a, b]) for (k, a), b in zip(
      _manyPlanes(257, 3.).items(), _manyPlanes(10).values())},
      elements=elements)
  masked = dict(plain, surfMask=np.ones(257, bool))
  seq = dict(plain, seqMask=np.ones((2, 257), bool))
  for scene, words in ((complexRows, '> the 256-surface immediates budget'),
                       (masked, 'sequential mode or a per-source ignore'),
                       (seq, 'sequential mode or a per-source ignore')):
    reason = cuda_trace.ineligibleReason(scene)
    assert words in reason
    assert reason == pallas_trace.pallasIneligibleReason(scene)
  # 256 analytic surfaces with a mask are no refusal
  few = dict(surfaces=_manyPlanes(256), elements=elements,
             surfMask=np.ones(256, bool))
  assert cuda_trace.ineligibleReason(few) is None


def test_sweep_stacks_the_surface_tables():
  '''`packSweepTables` stacks the surface table and its boxes per variant
  (the wall under 3 detector heights: the detector row differs, the runs
  do not); `variantTables` gives each variant's; variants whose runs
  differ are traced one by one (SweepUnavailable).'''
  scenes = [_compiled(lambda z=z: B.buildSurfWallScene(detectorZ=z))
            for z in (-20., -10., 0.)]
  histSpec = dict(elemToDet=np.array([-1, 0]),
                  bounds=np.array([H.WALL_BOUNDS]), bins=(8, 8))
  stacked, facts = cuda_trace.packSweepTables(scenes, histSpec, None)
  assert facts['surfTable'].shape == (3, 530, cuda_trace.SURF_TABLE_COLS)
  assert facts['surfBoxes'].shape == (3, 33, cuda_trace.BOX_COLS)
  for v, scene in enumerate(scenes):
    _t, f = cuda_trace._packTable(scene, histSpec)
    np.testing.assert_array_equal(facts['surfTable'][v], f['surfTable'])
    np.testing.assert_array_equal(facts['surfBoxes'][v], f['surfBoxes'])
  assert not np.array_equal(facts['surfTable'][0], facts['surfTable'][2])
  tables = dict(facts, table=torch.as_tensor(stacked),
                **cuda_trace._globalTensors(facts, 'cpu'))
  one = cuda_trace.variantTables(tables, 1)
  np.testing.assert_array_equal(one['surfTable'].numpy(),
                                facts['surfTable'][1])
  five = _compiled(B.buildSurfWall5kScene)
  with pytest.raises(cuda_trace.SweepUnavailable):
    cuda_trace.packSweepTables([scenes[0], five], histSpec, None)


# chip_smoke.py REF_WALL: the JAX package's fused step on the 522-surface
# wall at 65,536 rays, seed 0 (its XLA path: its kernel holds the wall's
# surface table in scalar memory only on the TPU)
REF_WALL_RAYS = 1 << 16
REF_WALL = dict(share=0.8999786376953125, power=1.0, r2=8371.303931728278,
                r4=139473323.46917462)


def test_wall_statistics_of_reference():
  '''The detected share, mean power and r^2 moments the card's run of the
  522-surface wall is held to (3 sigma) are the JAX package's.'''
  scene, bounds, maxI = H.buildWallScene(H.jaxNs())
  ref = H.fusedStatsOfReference(scene, bounds, maxI, REF_WALL_RAYS)
  for k, v in REF_WALL.items():
    assert ref[k] == pytest.approx(v, abs=1e-9), k
