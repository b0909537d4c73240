'''The per-bounce surface culls (B12) on the PyTorch port: the host side
(`_boundingSphere`, `beam_cull.normalCone`, `_firstBounceSurfs`,
`beam_cull.propagateBounceSets`, `_cullSets` and the table's cull block)
against the JAX package's functions on the same compiled arrays, scene by
scene; the culled plain steps (K1's histogram, K4's raw rows) against the
JAX package's interpret-mode kernel given the same emission bound; and the
culled plain steps against the unculled ones, bit for bit.

Tolerances: the host sets, spheres and cones are equal exactly (the same
float64 arithmetic on the same rows); against the interpret-mode kernel,
counters and counts are equal in every bin, power within the 1 % the other
port tests allow (the reference bins in bf16) and raw rows within their
atol 1e-4; culled against unculled, every output is equal bit for bit.'''

import numpy as np
import pytest
import torch

import torch_port_helpers as H
from optics_design_workbench_tpu.ops import beam_cull as jaxCull
from optics_design_workbench_tpu.ops import pallas_trace
from optics_design_workbench_tpu.tracing.batch_tracer import scatterConstants
from optics_design_workbench_tpu_torch import convert
from optics_design_workbench_tpu_torch.ops import beam_cull, cuda_trace
from optics_design_workbench_tpu_torch.tracing import fused

torch.set_num_threads(1)


def _portScene(name, bounds, maxI):
  '''A port benchmark scene (`benchmarks.<name>`) or its JAX twin.'''
  def build(ns):
    scene = getattr(H.torchNs().benchmarks, name)()
    return (scene if H._isPort(ns) else H.jaxSceneFromPort(scene), bounds,
            maxI)
  return build


# name -> (scene function, traced source)
HOST_SCENES = {
    **{name: (build, 0) for name, build in H.CULL_SCENES.items()},
    'lensMirror': (lambda ns: H.buildBench(ns, 'lensMirror'), 0),
    'spectrometer': (_portScene('buildSpectrometerScene',
                                (-80., 80., -80., 80.), 3), 0),
    'torus': (_portScene('buildTorusMirrorScene',
                         (-100., 100., -100., 100.), 4), 0),
    'surfaceSource': (_portScene('buildSurfaceSourceScene',
                                 (-120., 120., -120., 120.), 4), 0),
    'scatter': (_portScene('buildDiffuseScatterScene',
                           (-100., 100., -100., 100.), 4), 0),
    'maskedSrc': (H.buildMaskedSourcesScene, 0),
    'maskedBlind': (H.buildMaskedSourcesScene, 1),
    'meshMirror': (H.buildMeshCullScene, 0),
}
# the throughput scenes the port times: the culls prune nothing there
UNCULLED = ('lensMirror', 'spectrometer', 'torus', 'surfaceSource',
            'scatter')
KERNEL_SCENES = ('fold', 'reflectBack', 'ballLens')
# the check scenes whose tables carry a cull block (on the reflect-back
# scene the cull keeps every row on every bounce)
CULLED = ('firstBounce', 'fold', 'ballLens', 'decoy')

_HOST = {}
_JAX_SCENES = {}


def _jaxScene(build):
  '''The JAX twin of a scene, compiled once per module (two traced sources
  of one scene share it).'''
  if build not in _JAX_SCENES:
    scene, bounds, maxI = build(H.jaxNs())
    _JAX_SCENES[build] = (H.compileOnce(scene), bounds, maxI)
  return _JAX_SCENES[build]


def _host(name):
  '''Both packages' host rows of a scene, from the same compiled arrays,
  with each package's emission bound of the traced source.'''
  if name not in _HOST:
    build, source = HOST_SCENES[name]
    scene, bounds, maxI = _jaxScene(build)
    deviceNp, histNp, spec = H.referenceArrays(scene, bounds, source=source)
    nTri = cuda_trace.tableTriangles(deviceNp)
    parts = pallas_trace._sceneRows(deviceNp, histNp, smemTris=nTri > 0)
    jaxRows, jaxElems = parts[:2]
    triTable = parts[3] if nTri else None
    allowed, _seq = pallas_trace._staticMasks(deviceNp)
    posOf = {r['sceneIdx']: p for p, r in enumerate(jaxRows)}
    if allowed is not None:
      allowed = sorted(posOf[s] for s in allowed if s in posOf)
    sceneNp, histSpec = convert._sceneAndSpec(deviceNp, histNp)
    rows, elems, _n, _m, triRows, surfEntries = cuda_trace._sceneRows(
        sceneNp, histSpec)
    portScene = build(H.torchNs())[0]
    _HOST[name] = dict(
        jaxRows=jaxRows, jaxElems=jaxElems, triTable=triTable,
        allowed=allowed, jaxScatter=scatterConstants(deviceNp),
        jaxBound=scene.lightSources()[source].emissionBound(),
        rows=rows, elems=elems, triRows=triRows, surfEntries=surfEntries,
        scatter=cuda_trace.scatterConstantsOf(sceneNp),
        bound=portScene.lightSources()[source].emissionBound(),
        maxI=maxI, deviceNp=deviceNp, histNp=histNp, spec=spec)
  return _HOST[name]


def _assertSame(a, b):
  '''Two (vector, scalar) pairs, or None, equal exactly.'''
  assert (a is None) == (b is None)
  if a is not None:
    np.testing.assert_array_equal(np.asarray(a[0]), np.asarray(b[0]))
    assert float(a[1]) == float(b[1])


@pytest.mark.parametrize('name', list(HOST_SCENES))
def test_spheres_and_normal_cones_match_reference(name):
  h = _host(name)
  assert len(h['rows']) == len(h['jaxRows'])
  for row, ref in zip(h['rows'], h['jaxRows']):
    _assertSame(cuda_trace._boundingSphere(row),
                pallas_trace._boundingSphere(ref))
    _assertSame(beam_cull.normalCone(row), jaxCull.normalCone(ref))
  if name == 'decoy':
    kinds = {r['kind'] for r in h['rows']}
    assert kinds == {0, 3, 7}          # plane, asphere, torus
    assert all(cuda_trace._boundingSphere(r) is not None for r in h['rows'])


@pytest.mark.parametrize('name', list(HOST_SCENES))
def test_bounce_sets_match_reference(name):
  '''The first-bounce set, the propagated sets and the per-bounce sets a
  step sweeps (`_cullSets`, and read back from the table's cull block)
  equal the JAX package's.'''
  h = _host(name)
  bound, maxI = h['bound'], h['maxI']
  for a, b in zip(bound, h['jaxBound']):
    np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)
  assert cuda_trace._firstBounceSurfs(h['rows'], bound) \
      == pallas_trace._firstBounceSurfs(h['jaxRows'], h['jaxBound'])
  unsafe = name == 'meshMirror'
  sets = beam_cull.propagateBounceSets(
      h['rows'], h['elems'], h['scatter'], bound, maxI, allowed=h['allowed'],
      unsafeAfterBounce0=unsafe)
  ref = jaxCull.propagateBounceSets(
      h['jaxRows'], h['jaxElems'], h['jaxScatter'], h['jaxBound'], maxI,
      allowed=h['allowed'], unsafeAfterBounce0=unsafe,
      boundingSphere=pallas_trace._boundingSphere)
  assert sets == ref
  # the sets a step sweeps: the reference's per-bounce sets, a set of every
  # allowed row counting as a full sweep
  refSets, _tail, _unroll = pallas_trace._beamCullSets(
      h['jaxRows'], h['jaxElems'], h['jaxScatter'], h['jaxBound'], maxI,
      h['allowed'], 0, triTable=h['triTable'])
  every = (list(range(len(h['jaxRows']))) if h['allowed'] is None
           else h['allowed'])
  refSets = [None if ss is None or ss == every else ss for ss in refSets]
  portAllowed = [p for p, r in enumerate(h['rows']) if r['stages'] != 0]
  assert portAllowed == every
  cull = cuda_trace._cullSets(
      h['rows'], h['elems'], h['scatter'], bound, maxI, h['allowed'],
      h['triRows'], h['surfEntries'])
  assert cull == refSets
  tables = convert.sceneFromReference(
      h['deviceNp'], h['histNp'], samplerSpec=h['spec'], device='cpu',
      emissionBound=bound, maxIntersections=maxI)
  assert cuda_trace.tableCullSets(tables, maxI) == cull
  assert (tables['cullOff'] < 0) == all(ss is None for ss in cull)
  # what each scene is there to show
  if name in UNCULLED:
    assert tables['cullOff'] == -1
  if name == 'decoy':
    assert cull == [[0], [0, 1], [0], [0, 1]]      # fold, then detector
  if name == 'fold':
    assert cull[0] == [0] and 1 in cull[1]
    assert all(ss is not None and set(ss) <= {0, 1} for ss in cull)
  assert (tables['cullOff'] >= 0) == (name in CULLED + ('maskedBlind',
                                                       'meshMirror'))
  if name in ('firstBounce', 'ballLens'):
    # bounce 0 leaves out the decoy (element 1 and 2 of the two scenes)
    byElem = {int(r['elemF']): p for p, r in enumerate(h['rows'])}
    decoy = byElem[1 if name == 'firstBounce' else 2]
    assert cull[0] is not None and decoy not in cull[0]
  if name == 'reflectBack':
    assert cull == [None] * maxI         # the detector behind stays
  if name == 'maskedBlind':
    # the source sees every row it is allowed; after the absorbers no ray
    # is left to sweep anything
    assert cull == [None] + [[]] * (maxI - 1)
  if name == 'meshMirror':
    assert cull[0] is not None and cull[1:] == [None] * (maxI - 1)


def test_cull_block_layout_and_room():
  '''The table's cull block: one set's words shared by the bounces that
  sweep it, read back as written; a set past the room left is swept in
  full, and no room for the per-bounce offsets means no block.'''
  sets = [[0, 2, 33], [1], None, [0, 2, 33]]
  base, nWords = 100, 2                     # 40 rows: two words a set
  block = cuda_trace._cullBlock(sets, 40, base, 1000)
  words = block.view(np.int32)
  assert len(words) == 1 + 4 + 2 * nWords
  assert words[0] == 4 and words[3] == -1 and words[1] == words[4]

  def readBack(block, maxI):
    table = torch.as_tensor(np.concatenate([np.zeros(base, np.float32),
                                            block]))
    return cuda_trace.tableCullSets(dict(table=table, cullOff=base,
                                         nSurf=40), maxI)

  assert readBack(block, 6) == sets + [None, None]
  tight = cuda_trace._cullBlock(sets, 40, base, 1 + 4 + nWords)
  assert readBack(tight, 4) == [[0, 2, 33], None, None, [0, 2, 33]]
  assert cuda_trace._cullBlock(sets, 40, base, 4) is None
  assert cuda_trace._cullBlock([None, None], 40, base, 1000) is None


@pytest.mark.parametrize('name', KERNEL_SCENES)
def test_culled_plain_matches_reference_kernel(name):
  '''K1's histogram and K4's raw rows of the culled plain step against the
  JAX package's interpret-mode kernel with `emissionBound`, 2,048 rays.'''
  case = H.runUniformsCase(H.CULL_SCENES[name], cull=True)
  assert (case['tables']['cullOff'] >= 0) == (name in CULLED)
  ref, port = case['hist']
  for k in ('segments', 'hits', 'hitOverflow'):
    assert port['counters'][k] == ref['counters'][k], k
  np.testing.assert_array_equal(port['counts'], ref['counts'])
  same = ref['counts'] > 0
  np.testing.assert_allclose(port['power'][same], ref['power'][same],
                             rtol=1e-2)
  if name == 'reflectBack':
    # the concave mirror's reflected directions agree within 6.6e-7 (the
    # reference's CPU arithmetic contracts a * b + c), and the 150 mm
    # flight back to the detector carries that to 3.05e-4 mm on 93 of
    # 2,017 rows; the culls leave this scene's every row in every set
    H.assertRawRowsMatch(case, looseAtol=1e-3, maxLoose=128)
  else:
    H.assertRawRowsMatch(case)


@pytest.mark.parametrize('name', KERNEL_SCENES + ('firstBounce', 'decoy'))
def test_culled_plain_equals_unculled(name):
  '''The same rays through the port's plain K1, K2 and K4 with and without
  the cull block: equal bit for bit.'''
  scene, bounds, maxI = H.CULL_SCENES[name](H.torchNs())
  sceneNp, info = scene.compile(device=None)
  histSpec = fused.makeHistogramSpec(sceneNp, info, bounds=bounds,
                                     bins=H.BINS)
  src = scene.lightSources()[0]
  culled, full = (cuda_trace.buildTraceTables(
      sceneNp, histSpec, samplerSpec=src.samplerSpec(), device='cpu',
      emissionBound=bound, maxIntersections=maxI)
      for bound in (src.emissionBound(), None))
  assert (culled['cullOff'] >= 0) == (name in CULLED)
  assert full['cullOff'] == -1
  kw = dict(maxIntersections=maxI, maxRayLength=H.MAX_RAY_LENGTH,
            distTol=H.DIST_TOL, hitSlots=2, seed=5, strataTile=256)
  out = []
  for tables in (culled, full):
    hist = fused.initHistograms(histSpec, device='cpu')
    c1 = cuda_trace.traceHistogram(tables, hist, H.N_RAYS, **kw)
    bins, c2 = cuda_trace.traceBins(tables, H.N_RAYS, **kw)
    raw, c4 = cuda_trace.traceRaw(tables, H.N_RAYS, **kw)
    out.append((hist['power'], hist['counts'], c1, bins, c2, raw, c4))
  assert int(out[0][2][1]) > 0.3 * H.N_RAYS
  for a, b in zip(*out):
    assert torch.equal(a, b)
