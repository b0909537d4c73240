'''The two-level table sweeps with a shrinking cap (the kernels' group boxes
over the chunk boxes of the triangle table, B7, and of the surface table,
B8) on the PyTorch port, host side and in the plain version, without the
JAX package's interpret-mode kernel: the rows and chunk boxes still equal
the JAX package's `_chunkTriangles` / `_chunkSurfRows` on the reference's
1800-triangle dish and 522-surface wall; every group box holds its chunks'
boxes and no group spans two runs of the surface table; the kernels' box
packs and launch runs; every ray's winning row (the lowest index on a tie)
lies in a chunk and a group that the ray enters when it tests each box
against its segment capped at min(the entry cap, its winner so far +
window); and the plain version's counts of the two-level sweep are never
above the one-level counts. Exact comparisons throughout: the same float32
operations on the same rows.'''

import numpy as np
import pytest
import torch

import torch_port_helpers as H
from optics_design_workbench_tpu.ops import pallas_trace
from optics_design_workbench_tpu_torch import benchmarks as B
from optics_design_workbench_tpu_torch.ops import cuda_trace as C
from optics_design_workbench_tpu_torch.tracing import fused

torch.set_num_threads(1)

N_RAYS = 4096
MAX_RAY_LENGTH = 1000.
DIST_TOL = 1e-4
WINDOW = 2 * DIST_TOL                   # the kernels' same-medium window


def _dish1800():
  return B.buildMeshDishScene(30), H.MESH_BOUNDS, 3


def _wall522():
  return B.buildSurfWallScene(), H.WALL_BOUNDS, 3


# name -> scene function; the tie scenes duplicate a dish triangle and a
# wall disc, so two rows tie on every ray that meets them
SCENES = {'dish1800': _dish1800, 'wall522': _wall522,
          'tieMesh': lambda: H.buildTieMeshScene(H.torchNs()),
          'tieTable': lambda: H.SURFACE_TABLE_SCENES['tie'](H.torchNs())}


@pytest.fixture(scope='module')
def packed():
  '''name -> (compiled numpy scene, histogram spec, CPU tables, bounds,
  intersections), each scene built and packed once.'''
  out = {}
  for name, make in SCENES.items():
    scene, bounds, maxI = make()
    sceneNp, info = scene.compile(device=None)
    histSpec = fused.makeHistogramSpec(sceneNp, info, bounds=bounds,
                                       bins=(8, 8))
    tables = C.buildTraceTables(
        sceneNp, histSpec, scene.lightSources()[0].samplerSpec(),
        device='cpu')
    out[name] = (sceneNp, histSpec, tables, bounds, maxI)
  return out


@pytest.mark.parametrize('name', ['dish1800', 'wall522'])
def test_rows_and_chunk_boxes_equal_the_reference(name, packed):
  sceneNp, histSpec, tables, _b, _m = packed[name]
  _s, _e, _n, _m2, triRows, surfEntries = C._sceneRows(sceneNp, histSpec)
  if name == 'dish1800':
    rows = np.asarray(triRows, np.float32)
    refTable, refBoxes = pallas_trace._chunkTriangles(rows)
    table, boxes = C._chunkTriangles(rows)
    runs = refRuns = ()
  else:
    ordered = sorted(surfEntries, key=lambda e: (e[0], e[1]))
    refTable, refPlain, refBoxes, refChunk = pallas_trace._chunkSurfRows(
        ordered)
    table, plain, boxes, chunk = C._chunkSurfRows(surfEntries)
    runs, refRuns = (plain, chunk), (refPlain, refChunk)
  np.testing.assert_array_equal(table.view(np.uint32),
                                np.asarray(refTable).view(np.uint32))
  np.testing.assert_array_equal(boxes.view(np.uint32),
                                np.asarray(refBoxes).view(np.uint32))
  assert runs == refRuns
  key = 'triBoxes' if name == 'dish1800' else 'surfBoxes'
  np.testing.assert_array_equal(tables[key].numpy().view(np.uint32),
                                boxes.view(np.uint32))
  assert len(boxes) == (57 if name == 'dish1800' else 33)


def _tableParts(tables):
  '''[(chunk boxes, group boxes, group spans, pack)] of the tables' triangle
  table and surface table (those with chunks).'''
  parts = []
  if tables['nTri'] and tables['nTriChunks']:
    parts.append((tables['triBoxes'], tables['triGroups'],
                  C.groupSpans([(0, tables['nTriChunks'])]),
                  tables['triBoxPack']))
  if tables['nSurfTable'] and tables['nSurfChunks']:
    parts.append((tables['surfBoxes'], tables['surfGroups'],
                  C.groupSpans([r[2:4] for r in tables['surfChunkRuns']]),
                  tables['surfBoxPack']))
  return parts


@pytest.mark.parametrize('name', sorted(SCENES))
def test_group_boxes_hold_their_chunks_and_keep_to_runs(name, packed):
  tables = packed[name][2]
  parts = _tableParts(tables)
  assert parts
  for boxes, groups, spans, pack in parts:
    assert len(groups) == len(spans) >= -(-len(boxes) // C.SWEEP_GROUP)
    assert [a for a, _b in spans[1:]] == [b for _a, b in spans[:-1]]
    for (a, b), g in zip(spans, groups):
      assert 0 < b - a <= C.SWEEP_GROUP
      assert (g[:3] <= boxes[a:b, :3]).all() and (g[3:] >= boxes[a:b, 3:]) \
          .all()
      # the union exactly: each face is some chunk's face
      assert (g[:3] == boxes[a:b, :3].amin(0)).all()
      assert (g[3:] == boxes[a:b, 3:].amax(0)).all()
    # the kernels' pack: the group boxes, then the chunk boxes, 8 floats
    both = torch.cat([groups, boxes])
    head = pack[:len(both)]
    assert head.shape == (len(both), C.BOX_STRIDE)
    assert torch.equal(head[:, 0:3], both[:, 0:3])
    assert torch.equal(head[:, 4:7], both[:, 3:6])
    assert not pack[:, 3].any() and not pack[:, 7].any()
    # then the leaf boxes (tests/test_torch_leaf_boxes.py)
    assert len(pack) > len(both)
  if tables['nSurfTable']:
    runs = C.surfaceRuns(tables['surfPlainRuns'], tables['surfChunkRuns'])
    spans = C.groupSpans([r[2:4] for r in tables['surfChunkRuns']])
    for kind, t0, first, last, row0, chunked, g0 in runs:
      if not chunked:
        continue
      nG = -(-(last - first) // C.SWEEP_GROUP)
      # the run's groups cover its chunks and no other run's
      assert spans[g0][0] == first and spans[g0 + nG - 1][1] == last
    assert len(spans) == tables['nSurfGroups']


def _rays(tables, seed):
  '''N_RAYS rays of the scene's sampler, then N_RAYS more from where the
  first ones end on the tables' rows, in directions drawn at random: the
  first segment of a bounce and later ones.'''
  rng = np.random.default_rng(seed)
  us = torch.as_tensor(rng.random((2, N_RAYS)), dtype=torch.float32)
  cols = C.samplerColumnsPlain(tables, us)
  o = torch.stack(cols[:3], 1)
  d = torch.stack(cols[3:6], 1)
  t = rng.uniform(5., 60., (N_RAYS, 1)).astype(np.float32)
  o2 = o + torch.as_tensor(t) * d
  d2 = torch.as_tensor(rng.normal(size=(N_RAYS, 3)), dtype=torch.float32)
  d2 = d2 / torch.linalg.norm(d2, dim=1, keepdim=True)
  return torch.cat([o, o2]), torch.cat([d, d2])


def _blocks(tables, o, d):
  '''The tables' sweep in the kernels' order: (plain distances (N, n) or
  None, [(chunk, (N, rows) distances)]) of the triangle table or else the
  surface table, each distance _BIG where a row is missed or past the
  ray length.'''
  oc = [o[:, k:k + 1] for k in range(3)]
  dc = [d[:, k:k + 1] for k in range(3)]
  if tables['nTri']:
    rows = tables['triTable']
    n = C._TRI_CHUNK
    return None, [(c, C._TriangleTablePlain.distances(
        rows[c * n:(c + 1) * n], oc, dc, 1e-4, MAX_RAY_LENGTH))
        for c in range(tables['nTriChunks'])]

  def dist(kind, trim0, r):
    t = C._tableIntersectPlain(kind, trim0, [r[None, :, k] for k in
                                             range(C.SURF_TABLE_COLS)],
                               *oc, *dc, 1e-4)[0]
    return torch.where(t <= MAX_RAY_LENGTH, t, torch.full_like(t, C._BIG))

  rows = tables['surfTable']
  plain = [dist(k, t0, rows[a:b]) for k, t0, a, b in tables['surfPlainRuns']]
  n = C._SURF_CHUNK
  chunked = [(c, dist(k, t0, rows[r0 + (c - c0) * n:
                                  r0 + (c - c0 + 1) * n]))
             for k, t0, c0, c1, r0 in tables['surfChunkRuns']
             for c in range(c0, c1)]
  return torch.cat(plain, 1) if plain else None, chunked


@pytest.mark.parametrize('name', sorted(SCENES))
def test_winner_lies_in_entered_chunk_and_group(name, packed):
  tables = packed[name][2]
  o, d = _rays(tables, seed=sorted(SCENES).index(name))
  plain, chunked = _blocks(tables, o, d)
  n = o.shape[0]
  big = torch.full((n,), C._BIG)
  # the winner over every row in sweep order (the first on a tie)
  allT = torch.cat(([plain] if plain is not None else [])
                   + [t for _c, t in chunked], 1)
  tWin = allT.min(1).values
  first = (allT == tWin[:, None]).to(torch.int8).argmax(1)
  # the plain runs' winner enters the entry cap, as in the kernels
  tPlain = plain.min(1).values if plain is not None else big
  tCap = torch.clamp(tPlain, max=MAX_RAY_LENGTH) + WINDOW
  # the ray alone through the group boxes, then the chunk boxes of the
  # groups it enters, each against its segment capped at min(tCap, its
  # winner so far + window)
  boxes, groups, spans, _pack = _tableParts(tables)[-1]
  inv = C._inverseDirections(d[:, 0], d[:, 1], d[:, 2])
  og = (o[:, 0], o[:, 1], o[:, 2])
  tRun, idx = tPlain.clone(), torch.full((n,), -1)
  base = 0 if plain is None else plain.shape[1]
  dist = dict(chunked)
  offsets, at = {}, base
  for c, t in chunked:
    offsets[c] = at
    at += t.shape[1]
  entered = torch.zeros((n, len(boxes)), dtype=torch.bool)
  for g, (a, b) in enumerate(spans):
    inGroup = C._slabIn(groups[g], og, inv,
                        torch.minimum(tCap, tRun + WINDOW))
    for c in range(a, b):
      enters = inGroup & C._slabIn(boxes[c], og, inv,
                                   torch.minimum(tCap, tRun + WINDOW))
      entered[:, c] = enters
      tc = dist[c].min(1).values
      kc = (dist[c] == tc[:, None]).to(torch.int8).argmax(1)
      better = enters & (tc < tRun)
      idx = torch.where(better, kc + offsets[c], idx)
      tRun = torch.where(better, tc, tRun)
  # every ray whose winner is a chunk's row within the entry cap: the ray
  # entered that chunk (and its group) and found the same row
  inChunk = (first >= base) & (tWin <= tCap) & (tWin < C._BIG)
  assert int(inChunk.sum()) > 100
  assert torch.equal(idx[inChunk], first[inChunk])
  assert torch.equal(tRun[inChunk], tWin[inChunk])
  rowChunk = torch.bucketize(first, torch.tensor(
      [offsets[c] for c, _t in chunked[1:]]), right=True)
  chunkOf = torch.tensor([c for c, _t in chunked])[rowChunk]
  assert entered[inChunk, chunkOf[inChunk]].all()
  if name.startswith('tie'):
    # the duplicated row ties: the lowest one won and the tie was met
    ties = ((allT == tWin[:, None]).sum(1) > 1) & inChunk
    assert int(ties.sum()) > 0


@pytest.mark.parametrize('name', sorted(SCENES))
def test_two_level_counts_never_exceed_one_level(name, packed):
  _s, _h, tables, bounds, maxI = packed[name]
  rng = np.random.default_rng(3)
  us = torch.as_tensor(rng.random((2, N_RAYS)), dtype=torch.float32)
  cols = C.samplerColumnsPlain(tables, us)
  shape = (tables['nDet'],) + tables['bins']
  hist = dict(power=torch.zeros(shape), counts=torch.zeros(shape))
  triStats, surfStats = {}, {}
  C.traceHistogramPlain(tables, hist, cols, maxI, MAX_RAY_LENGTH, DIST_TOL,
                        1e-6, C.autoHitSlots(packed[name][0], packed[name][1],
                                             maxI),
                        triangleStats=triStats, surfaceStats=surfStats)
  for stats, nChunks, nGroups in (
      (triStats, tables['nTriChunks'], tables['nTriGroups']),
      (surfStats, tables['nSurfChunks'], tables['nSurfGroups'])):
    if not stats or not nChunks:
      continue
    rb = stats['rayBounces']
    assert stats['groupTests'] == nGroups * rb
    assert stats['chunkTests'] <= nChunks * rb
    assert stats['capChunks'] <= stats['chunks']
    assert stats['capChunks'] <= stats['chunkTests']
  if triStats and tables['nTriChunks']:
    assert triStats['capTriangles'] <= triStats['triangles']
  if surfStats:
    assert set(surfStats['capRows']) == set(surfStats['rows'])
    for kind, n in surfStats['capRows'].items():
      assert n <= surfStats['rows'][kind]
  if name == 'dish1800':
    # the shrinking cap and the groups take work away on the dish
    assert triStats['capTriangles'] < triStats['triangles']
    assert triStats['chunkTests'] < tables['nTriChunks'] \
        * triStats['rayBounces']
