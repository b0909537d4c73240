'''The third level of the table sweeps (leaf boxes over 8 triangle rows of
a chunk of the triangle table, B7, and over 4 rows of a chunk of the
surface table, B8) on the PyTorch port, host side and in the plain
version, without the JAX package's interpret-mode kernel, on the
reference's 1800-triangle dish and 522-surface wall and the two tie scenes:
every leaf box holds its rows' vertices or bounding spheres and lies inside
its chunk's box, and a leaf of padding rows only is entered by no segment;
the kernels' box pack (groups, chunks, leaves) and its stacking per variant
of a sweep; every ray's winning row (the lowest on a tie) lies in a leaf, a
chunk and a group that the ray enters under the shrinking cap, alone and as
its warp sweeps; and the plain version's three-level counts are never above
its two-level counts, and the warp's never below the rays' own and equal
to them where the 32 rays of each warp are one ray. Exact
comparisons throughout: the same float32 operations on the same rows.'''

import numpy as np
import pytest
import torch

import torch_port_helpers as H
from optics_design_workbench_tpu_torch import benchmarks as B
from optics_design_workbench_tpu_torch.ops import cuda_trace as C
from optics_design_workbench_tpu_torch.tracing import fused

torch.set_num_threads(1)

N_RAYS = 4096
WINNER_RAYS = 2048
MAX_RAY_LENGTH = 1000.
DIST_TOL = 1e-4
WINDOW = 2 * DIST_TOL                   # the kernels' same-medium window
SCENES = {
    'dish1800': lambda: (B.buildMeshDishScene(30), H.MESH_BOUNDS, 3),
    'wall522': lambda: (B.buildSurfWallScene(), H.WALL_BOUNDS, 3),
    'tieMesh': lambda: H.buildTieMeshScene(H.torchNs()),
    'tieTable': lambda: H.SURFACE_TABLE_SCENES['tie'](H.torchNs())}
NAMES = sorted(SCENES)


@pytest.fixture(scope='module')
def packed():
  '''name -> (compiled numpy scene, histogram spec, CPU tables,
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
    out[name] = (sceneNp, histSpec, tables, maxI,
                 scene.lightSources()[0].samplerSpec())
  return out


def _table(tables):
  '''(triangle table?, rows, group spans, group, chunk and leaf boxes, box
  pack, rows a chunk, rows a leaf, first row of each chunk) of the tables'
  triangle table, else their surface table.'''
  if tables['nTri'] and tables['nTriChunks']:
    nC = tables['nTriChunks']
    return (True, tables['triTable'], C.groupSpans([(0, nC)]),
            tables['triGroups'], tables['triBoxes'], tables['triLeaves'],
            tables['triBoxPack'], C._TRI_CHUNK, C._TRI_LEAF,
            [c * C._TRI_CHUNK for c in range(nC)])
  runs = tables['surfChunkRuns']
  return (False, tables['surfTable'], C.groupSpans([r[2:4] for r in runs]),
          tables['surfGroups'], tables['surfBoxes'], tables['surfLeaves'],
          tables['surfBoxPack'], C._SURF_CHUNK, C._SURF_LEAF,
          [r0 + (c - c0) * C._SURF_CHUNK for _k, _t, c0, c1, r0 in runs
           for c in range(c0, c1)])


def _leafRows(tables):
  '''Per leaf box of the table, its rows [a, b) (b - a < rows a leaf only
  in a triangle table's last leaf; a surface leaf counts its padding
  rows).'''
  tri, rows, _s, _g, boxes, leaves, _p, perChunk, perLeaf, starts = \
      _table(tables)
  out = []
  for c, a in enumerate(starts):
    n = min(perChunk, len(rows) - a)
    out += [(a + k, a + min(k + perLeaf, n)) for k in range(0, perChunk,
                                                            perLeaf)
            if k < n or not tri]
  assert len(out) == len(leaves)
  return out


def _spheres(sceneNp, histSpec):
  '''Each surface-table row's bounding sphere (centre, radius), keyed by the
  row's bytes (two equal rows share one sphere).'''
  entries = C._sceneRows(sceneNp, histSpec)[5]
  return {np.asarray(e[2], np.float32).tobytes(): e[3] for e in entries}


@pytest.mark.parametrize('name', NAMES)
def test_leaf_boxes_hold_their_rows_inside_their_chunk(name, packed):
  sceneNp, histSpec, tables, _m, _spec = packed[name]
  tri, rows, _s, _g, boxes, leaves, _p, perChunk, perLeaf, starts = \
      _table(tables)
  rows, boxes, leaves = rows.numpy(), boxes.numpy(), leaves.numpy()
  lo, hi = leaves[:, :3].astype(np.float64), leaves[:, 3:].astype(np.float64)
  spheres = None if tri else _spheres(sceneNp, histSpec)
  padding, empty = 0, 0
  for j, (a, b) in enumerate(_leafRows(tables)):
    c = j // (perChunk // perLeaf)
    if tri:
      v0 = rows[a:b, 0:3].astype(np.float64)
      pts = np.concatenate([v0, v0 + rows[a:b, 3:6], v0 + rows[a:b, 6:9]])
      ptsLo = ptsHi = pts
    else:
      members = [spheres.get(r.tobytes()) for r in rows[a:b]]
      pad = [m is None for m in members]
      padding += sum(pad)
      if all(pad):
        empty += 1
        assert (leaves[j] == C._EMPTY_LEAF).all()
        continue
      cen = np.array([m[0] for m in members if m is not None], np.float64)
      rho = np.array([m[1] for m in members if m is not None], np.float64)
      ptsLo, ptsHi = cen - rho[:, None], cen + rho[:, None]
    assert (lo[j] <= ptsLo.min(0)).all() and (hi[j] >= ptsHi.max(0)).all()
    assert (leaves[j, :3] >= boxes[c, :3]).all()
    assert (leaves[j, 3:] <= boxes[c, 3:]).all()
  if not tri:
    # the padding rows: `_dummySurfRow`s at the end of each run's last chunk
    for kind, t0, c0, c1, r0 in tables['surfChunkRuns']:
      chunked = rows[r0:r0 + (c1 - c0) * perChunk]
      pad = np.array([r.tobytes() not in spheres for r in chunked])
      nPad = int(pad.sum())
      assert nPad < perChunk and pad[len(pad) - nPad:].all()
      assert (chunked[pad] == C._dummySurfRow(kind, t0)).all()
    assert padding // perLeaf <= empty == int(
        (leaves == C._EMPTY_LEAF).all(1).sum())


@pytest.mark.parametrize('name', NAMES)
def test_pack_holds_groups_chunks_then_leaves(name, packed):
  tables = packed[name][2]
  tri, rows, spans, groups, boxes, leaves, pack, perChunk, perLeaf, _st = \
      _table(tables)
  nG, nC = len(groups), len(boxes)
  if tri:
    assert len(leaves) == -(-len(rows) // perLeaf) == tables['nTriLeaves'] \
        == C.triLeafCount(len(rows), nC)
  else:
    assert len(leaves) == nC * perChunk // perLeaf == tables['nSurfLeaves']
  assert pack.shape == (nG + nC + len(leaves), C.BOX_STRIDE)
  for part, box in ((pack[:nG], groups), (pack[nG:nG + nC], boxes),
                    (pack[nG + nC:], leaves)):
    assert torch.equal(part[:, 0:3], box[:, 0:3])
    assert torch.equal(part[:, 4:7], box[:, 3:6])
  assert not pack[:, 3].any() and not pack[:, 7].any()


@pytest.mark.parametrize('name', NAMES)
def test_sweep_stacks_each_variant_pack(name, packed):
  sceneNp, histSpec, tables, _m, spec = packed[name]
  stacked = C.buildSweepTables([sceneNp, sceneNp], histSpec, [spec, spec],
                               device='cpu')
  key = 'triBoxPack' if tables['nTri'] else 'surfBoxPack'
  one = tables[key]
  assert stacked[key].shape == (2,) + tuple(one.shape)
  # the kernels' per-variant offset: (groups + chunks + leaves) boxes
  if tables['nTri']:
    perVariant = (tables['nTriGroups'] + tables['nTriChunks']
                  + C.triLeafCount(tables['nTri'], tables['nTriChunks']))
  else:
    perVariant = tables['nSurfGroups'] + tables['nSurfChunks'] * (
        1 + C._SURF_CHUNK // C._SURF_LEAF)
  flat = stacked[key].reshape(-1)
  stride = perVariant * C.BOX_STRIDE
  for v in range(2):
    assert torch.equal(flat[v * stride:(v + 1) * stride], one.reshape(-1))
    assert torch.equal(C.variantTables(stacked, v)[key], one)
  for k in ('nTriLeaves', 'nSurfLeaves'):
    assert stacked[k] == tables[k]


def _rays(tables, seed, n):
  '''n rays of the scene's sampler, then n more from where the first ones
  end on the tables' rows, in directions drawn at random.'''
  rng = np.random.default_rng(seed)
  us = torch.as_tensor(rng.random((2, n)), dtype=torch.float32)
  cols = C.samplerColumnsPlain(tables, us)
  o = torch.stack(cols[:3], 1)
  d = torch.stack(cols[3:6], 1)
  t = rng.uniform(5., 60., (n, 1)).astype(np.float32)
  d2 = torch.as_tensor(rng.normal(size=(n, 3)), dtype=torch.float32)
  d2 = d2 / torch.linalg.norm(d2, dim=1, keepdim=True)
  return torch.cat([o, o + torch.as_tensor(t) * d]), torch.cat([d, d2])


def _distances(tables, o, d):
  '''(plain runs' distances (N, n) or None, chunked rows' distances (N,
  rows) in table order from the first chunked row): each _BIG where a row
  is missed or past the ray length.'''
  oc = [o[:, k:k + 1] for k in range(3)]
  dc = [d[:, k:k + 1] for k in range(3)]
  if tables['nTri']:
    return None, C._TriangleTablePlain.distances(
        tables['triTable'], oc, dc, 1e-4, MAX_RAY_LENGTH)

  def dist(kind, trim0, r):
    t = C._tableIntersectPlain(kind, trim0, [r[None, :, k] for k in
                                             range(C.SURF_TABLE_COLS)],
                               *oc, *dc, 1e-4)[0]
    return torch.where(t <= MAX_RAY_LENGTH, t, torch.full_like(t, C._BIG))

  rows = tables['surfTable']
  plain = [dist(k, t0, rows[a:b]) for k, t0, a, b in tables['surfPlainRuns']]
  n = C._SURF_CHUNK
  chunked = [dist(k, t0, rows[r0:r0 + (c1 - c0) * n])
             for k, t0, c0, c1, r0 in tables['surfChunkRuns']]
  return torch.cat(plain, 1) if plain else None, torch.cat(chunked, 1)


@pytest.fixture(scope='module')
def traced(packed):
  '''name -> (origins, directions, plain runs' distances or None, chunked
  rows' distances) of 2 x WINNER_RAYS rays (`_rays`, `_distances`).'''
  out = {}
  for name in NAMES:
    tables = packed[name][2]
    o, d = _rays(tables, NAMES.index(name), WINNER_RAYS)
    out[name] = (o, d) + _distances(tables, o, d)
  return out


def _threeLevel(tables, o, d, dist, tCap, tRun, warp):
  '''The kernels' three-level sweep of the chunked rows (distances
  `dist`), each ray alone or as its warp (32 consecutive rays) votes:
  (winning chunked row or -1, its distance, per leaf whether the ray swept
  it, per chunk and per group whether it entered the box).'''
  tri, rows, spans, groups, boxes, leaves, _p, perChunk, perLeaf, starts = \
      _table(tables)
  first = starts[0]
  inv = C._inverseDirections(d[:, 0], d[:, 1], d[:, 2])
  og = (o[:, 0], o[:, 1], o[:, 2])
  n = o.shape[0]
  idx = torch.full((n,), -1)
  vote = C._warpAny if warp else (lambda x: x)
  everyone = torch.ones(n, dtype=torch.bool)
  leafRows = _leafRows(tables)
  sweptLeaf = torch.zeros((n, len(leaves)), dtype=torch.bool)
  inChunk = torch.zeros((n, len(boxes)), dtype=torch.bool)
  inGroup = torch.zeros((n, len(groups)), dtype=torch.bool)
  enter = lambda box, within: vote(C._slabIn(
      box, og, inv, torch.minimum(tCap, tRun + WINDOW)) & within) & within
  perLeaves = perChunk // perLeaf
  for g, (a, b) in enumerate(spans):
    inGroup[:, g] = enter(groups[g], everyone)
    for c in range(a, b):
      inChunk[:, c] = enter(boxes[c], inGroup[:, g])
      for j in range(c * perLeaves, (c + 1) * perLeaves):
        if j >= len(leaves):
          break
        sweptLeaf[:, j] = enter(leaves[j], inChunk[:, c])
        r0, r1 = leafRows[j]
        tl = dist[:, r0 - first:r1 - first]
        tMin = tl.min(1).values
        k = (tl == tMin[:, None]).to(torch.int8).argmax(1)
        better = sweptLeaf[:, j] & (tMin < tRun)
        idx = torch.where(better, k + r0, idx)
        tRun = torch.where(better, tMin, tRun)
  return idx, tRun, sweptLeaf, inChunk, inGroup


@pytest.mark.parametrize('warp', [False, True], ids=['alone', 'warp'])
@pytest.mark.parametrize('name', NAMES)
def test_winner_lies_in_entered_leaf_chunk_and_group(name, warp, packed,
                                                     traced):
  tables = packed[name][2]
  tri, rows, spans, _g, _b, leaves, _p, perChunk, perLeaf, starts = \
      _table(tables)
  o, d, plain, dist = traced[name]
  n = o.shape[0]
  big = torch.full((n,), C._BIG)
  # the winner over every row in sweep order (the first on a tie)
  allT = torch.cat(([plain] if plain is not None else []) + [dist], 1)
  tWin = allT.min(1).values
  base = 0 if plain is None else plain.shape[1]
  firstAll = (allT == tWin[:, None]).to(torch.int8).argmax(1)
  tPlain = plain.min(1).values if plain is not None else big
  tCap = torch.clamp(tPlain, max=MAX_RAY_LENGTH) + WINDOW
  idx, tRun, sweptLeaf, inChunk, inGroup = _threeLevel(
      tables, o, d, dist, tCap, tPlain.clone(), warp)
  # every ray whose winner is a chunked row within the entry cap: the ray
  # swept that row's leaf, entered its chunk and group, and found the row
  won = (firstAll >= base) & (tWin <= tCap) & (tWin < C._BIG)
  assert int(won.sum()) > 100
  row = firstAll - base + starts[0]
  assert torch.equal(idx[won], row[won])
  assert torch.equal(tRun[won], tWin[won])
  leafOf = torch.bucketize(row, torch.tensor([a for a, _b in
                                              _leafRows(tables)[1:]]),
                           right=True)
  chunkOf = leafOf // (perChunk // perLeaf)
  groupOf = torch.bucketize(chunkOf, torch.tensor([a for a, _b in spans[1:]]),
                            right=True)
  assert sweptLeaf[won, leafOf[won]].all()
  assert inChunk[won, chunkOf[won]].all()
  assert inGroup[won, groupOf[won]].all()
  # a leaf of padding rows only is never swept
  empty = (leaves == torch.as_tensor(C._EMPTY_LEAF)).all(1)
  assert not sweptLeaf[:, empty].any()
  if name.startswith('tie'):
    ties = ((allT == tWin[:, None]).sum(1) > 1) & won
    assert int(ties.sum()) > 0
  # the leaves keep work away: fewer leaves swept than chunks entered hold
  assert int(sweptLeaf.sum()) < int(inChunk.sum()) * (perChunk // perLeaf)


def _count(entry, us):
  '''(the tables, the plain version's triangle-table stats, or its
  surface-table stats) of the sampler rays of uniforms `us` traced once.'''
  sceneNp, histSpec, tables, maxI, _spec = entry
  cols = C.samplerColumnsPlain(tables, us)
  shape = (tables['nDet'],) + tables['bins']
  hist = dict(power=torch.zeros(shape), counts=torch.zeros(shape))
  triStats, surfStats = {}, {}
  C.traceHistogramPlain(tables, hist, cols, maxI, MAX_RAY_LENGTH,
                        DIST_TOL, 1e-6,
                        C.autoHitSlots(sceneNp, histSpec, maxI),
                        triangleStats=triStats, surfaceStats=surfStats)
  return tables, triStats if tables['nTri'] else surfStats


@pytest.fixture(scope='module')
def counted(packed):
  '''name -> `_count` of one batch of N_RAYS sampler rays.'''
  rng = np.random.default_rng(3)
  us = torch.as_tensor(rng.random((2, N_RAYS)), dtype=torch.float32)
  return {name: _count(packed[name], us) for name in NAMES}


def _rows(stats, key):
  rows = stats[key]
  return rows if isinstance(rows, dict) else {None: rows}


@pytest.mark.parametrize('name', NAMES)
def test_three_level_counts_never_exceed_two_level(name, counted):
  tables, stats = counted[name]
  key = 'capTriangles' if tables['nTri'] else 'capRows'
  three = stats['threeLevel']
  assert three['groupTests'] == stats['groupTests']
  assert three['chunkTests'] <= stats['chunkTests']
  assert three['capChunks'] <= stats['capChunks']
  if tables['nTri']:
    assert three['leafTests'] <= three['capChunks'] * (
        C._TRI_CHUNK // C._TRI_LEAF)
  else:
    assert three['leafTests'] == three['capChunks'] * (
        C._SURF_CHUNK // C._SURF_LEAF)
  assert three['capLeaves'] <= three['leafTests']
  two, got = _rows(stats, key), _rows(three, key)
  assert set(got) == set(two)
  for kind, n in got.items():
    assert n <= two[kind]
  if name in ('dish1800', 'wall522'):
    # the leaves take rows away from the two-level sweep
    assert sum(got.values()) < sum(two.values())
    assert three['capLeaves'] < three['leafTests']


@pytest.mark.parametrize('name', NAMES)
def test_warp_count_never_below_the_rays_own(name, counted):
  tables, stats = counted[name]
  key = 'capTriangles' if tables['nTri'] else 'capRows'
  alone, warp = stats['threeLevel'], stats['warp']
  for k in ('groupTests', 'chunkTests', 'capChunks', 'leafTests',
            'capLeaves'):
    assert warp[k] >= alone[k]
  assert warp['groupTests'] == alone['groupTests']
  mine, theirs = _rows(alone, key), _rows(warp, key)
  assert set(mine) == set(theirs)
  for kind, n in mine.items():
    assert theirs[kind] >= n


@pytest.mark.parametrize('name', NAMES)
def test_warp_of_one_ray_counts_as_the_ray_alone(name, packed):
  # 32 copies of each ray fill each warp: a box one lane enters, all enter
  rng = np.random.default_rng(5)
  us = torch.as_tensor(rng.random((2, N_RAYS // 32)), dtype=torch.float32)
  _tables, stats = _count(packed[name], us.repeat_interleave(32, dim=1))
  assert stats['warp'] == stats['threeLevel']
  assert stats['threeLevel']['capLeaves'] > 0
