'''The PyTorch port's variant-major sweep step (`ops.cuda_trace.traceSweep`,
`makeSweepStep`; on the CPU its plain version) against the JAX package, on a
surface sweep (the examples/3 lens at radii 45 / 60 / 80 mm) and on a
source-placement sweep (x = 0 / 15 / -25 mm, detector only), 2048 rays per
variant, bins (32, 64).

Tolerances:
  * stacked table rows against the reference's `packTables` rows and
    `_sourceGeomRow`: rtol 1e-6 (both sides round the same doubles to
    float32; the squared radius is formed in double first);
  * the sweep's plain version per variant against the single-scene plain
    version on that variant's table, same uniforms: counters, counts AND
    power exactly equal (same operations in the same order);
  * per variant against the JAX single-scene kernel (interpret mode) fed the
    same uniforms: counters equal, counts within the 2-ray bin-edge budget,
    power per bin within 1 % (the reference bins in bf16);
  * against `makePallasSweepStep(interpret=True)` itself, whose random bits
    cannot be fed and are degenerate in interpret mode (one ray per stratum
    cell, many times): total segments and hits per variant equal, its filled
    bins inside the box of the port's. (The distribution is held through
    the chain sweep == single-scene step per variant == JAX single-scene
    kernel on the same uniforms, and the JAX package's own tests tie its
    sweep step to its single-scene step.)
'''

import numpy as np
import pytest
import torch

import jax

import torch_port_helpers as H
from optics_design_workbench_tpu.jupyter_utils.parameter_sweeper import \
    _sourceGeomRow as refGeomRow
from optics_design_workbench_tpu.ops import pallas_trace
from optics_design_workbench_tpu_torch import convert
from optics_design_workbench_tpu_torch.jupyter_utils.parameter_sweeper import \
    _sourceGeomRow
from optics_design_workbench_tpu_torch.ops import cuda_trace
from optics_design_workbench_tpu_torch.tracing import fused as torchFused

torch.set_num_threads(1)

BINS = (32, 64)
KINDS = ('radius', 'placement')


def _hostScenes(scenes):
  out = []
  for sc in scenes:
    host, info = sc.compile(devicePut=False)
    host['powerTol'] = 1e-6
    out.append((host, info))
  return out


@pytest.fixture(scope='module', params=KINDS)
def sweepCase(request):
  '''One sweep in both packages: the JAX sweep step (interpret mode, its own
  random bits), the JAX single-scene step per variant fed uniforms, and the
  port's sweep on those uniforms.'''
  kind = request.param
  scenes, bounds, maxI = H.sweepVariants(H.jaxNs(), kind)
  hostScenes = _hostScenes(scenes)
  spec = scenes[0].lightSources()[0].pallasSamplerSpec()
  assert spec is not None
  geom = kind == 'placement'
  geoms = np.stack([refGeomRow(sc.lightSources()[0]) for sc in scenes])
  stepJ, packJ = pallas_trace.makePallasSweepStep(
      hostScenes, bounds, BINS, spec, raysPerVariant=H.N_RAYS,
      maxIntersections=maxI, maxRayLength=H.MAX_RAY_LENGTH,
      distTol=H.DIST_TOL, interpret=True, tile=H.TILE, geomMode=geom)
  tableJ = packJ(hostScenes)
  args = (jax.random.PRNGKey(9), tableJ) + ((geoms,) if geom else ())
  powerJ, countsJ, segsJ = stepJ(*args)

  deviceNp, histNp, _spec = H.referenceArrays(scenes[0], bounds, bins=BINS)
  tables = convert.sweepFromReference(
      [h for h, _i in hostScenes], histNp, spec,
      geomRows=geoms if geom else None, device='cpu')

  refs, us = [], None
  for sc in scenes:
    ref, us = H.runReferenceUniforms(sc, bounds, maxI, bins=BINS)
    refs.append(ref)
  V = len(scenes)
  hist = dict(power=torch.zeros((V, 1) + BINS), counts=torch.zeros((V, 1) + BINS))
  counters = cuda_trace.traceSweep(
      tables, hist, H.N_RAYS, maxI, H.MAX_RAY_LENGTH, H.DIST_TOL, hitSlots=1,
      uniforms=torch.as_tensor(us), strataTile=H.TILE)
  return dict(kind=kind, scenes=scenes, tables=tables, tableJ=tableJ,
              geoms=geoms, countsJ=np.asarray(countsJ), segsJ=int(segsJ),
              refs=refs, us=us, hist=hist, counters=counters, maxI=maxI)


def test_stacked_table_rows_match_reference_pack(sweepCase):
  '''(a) the varying surfaces' rows of the port's stacked table are the
  reference's `packTables` rows, column for column.'''
  t = sweepCase['tables']
  V, S = t['nVariants'], t['nSurf']
  surf = t['table'].numpy()[:, :S * cuda_trace.SURF_COLS] \
      .reshape(V, S, cuda_trace.SURF_COLS)
  varying = [s for s in range(S) if (surf[:, s] != surf[0, s]).any()]
  ref = sweepCase['tableJ'].reshape(V, -1, 21)
  assert ref.shape[1] == len(varying)
  assert len(varying) == (1 if sweepCase['kind'] == 'radius' else 0)
  for j, s in enumerate(varying):
    rows, refRows = surf[:, s], ref[:, j]
    np.testing.assert_allclose(rows[:, 1:15], refRows[:, 0:14], rtol=1e-6)
    np.testing.assert_allclose(
        rows[:, 15], (refRows[:, 14].astype(np.float64) ** 2), rtol=1e-6)
    np.testing.assert_allclose(rows[:, 17:19], refRows[:, 19:21], rtol=1e-6)


def test_sampler_geometry_rows_match_reference(sweepCase):
  '''(a) the first 16 floats of each variant's sampler block hold the
  reference's (V, 13) geometry row; the port's `_sourceGeomRow` is the
  reference's.'''
  t = sweepCase['tables']
  off = t['samplerOff']
  block = t['table'].numpy()[:, off + 2:off + 15]
  np.testing.assert_allclose(block, sweepCase['geoms'], rtol=1e-6)
  scenes, _b, _m = H.sweepVariants(H.torchNs(), sweepCase['kind'])
  mine = np.stack([_sourceGeomRow(sc.lightSources()[0]) for sc in scenes])
  np.testing.assert_allclose(mine, sweepCase['geoms'], rtol=1e-6)
  assert t['sameSource'] == (sweepCase['kind'] == 'radius')


def test_sweep_plain_equals_single_scene_plain_per_variant(sweepCase):
  '''(b) variant v of the sweep IS the single-scene histogram step on
  variant v's table with the same uniforms: exactly.'''
  t, us = sweepCase['tables'], torch.as_tensor(sweepCase['us'])
  for v in range(t['nVariants']):
    single = cuda_trace.variantTables(t, v)
    hist = torchFused.initHistograms(
        dict(bounds=np.zeros((1, 4)), bins=BINS), device='cpu')
    c = cuda_trace.traceHistogram(
        single, hist, H.N_RAYS, sweepCase['maxI'], H.MAX_RAY_LENGTH,
        H.DIST_TOL, hitSlots=1, uniforms=us, strataTile=H.TILE)
    assert c.tolist() == sweepCase['counters'][v].tolist()
    assert torch.equal(hist['counts'], sweepCase['hist']['counts'][v])
    assert torch.equal(hist['power'], sweepCase['hist']['power'][v])


def test_sweep_counters_equal_reference_single_scene(sweepCase):
  '''(c) counters per variant equal the JAX single-scene kernel's.'''
  for v, ref in enumerate(sweepCase['refs']):
    got = dict(zip(('segments', 'hits', 'hitOverflow'),
                   sweepCase['counters'][v].tolist()))
    assert got == {k: ref['counters'][k] for k in got}, v
  assert int(sweepCase['counters'][:, 1].min()) > 0.9 * H.N_RAYS


def test_sweep_histograms_match_reference_single_scene(sweepCase):
  '''(c) counts within the 2-ray budget, power within 1 % per bin.'''
  for v, ref in enumerate(sweepCase['refs']):
    counts = sweepCase['hist']['counts'][v].numpy()
    power = sweepCase['hist']['power'][v].numpy()
    assert H.nearlyEqualCounts(counts, ref['counts']), v
    same = (ref['counts'] == counts) & (counts > 0)
    np.testing.assert_allclose(power[same], ref['power'][same], rtol=1e-2)
  c = sweepCase['hist']['counts']
  assert float((c[0] - c[1]).abs().sum()) > 0    # the variants do differ


def test_sweep_agrees_with_reference_sweep_step(sweepCase):
  '''(d) against the JAX sweep step itself. Its random bits cannot be fed,
  and in interpret mode on the CPU the TPU generator hands every ray of a
  stratum cell the same bits, so its histograms hold one ray many times and
  marginals cannot be compared. What it does show: the same segments in
  all, the same hits per variant, and every bin it fills lies inside the
  box of bins the port fills for that variant.'''
  assert int(sweepCase['counters'][:, 0].sum()) == sweepCase['segsJ']
  for v in range(3):
    mine = sweepCase['hist']['counts'][v, 0].numpy()
    ref = sweepCase['countsJ'][v, 0]
    assert mine.sum() == ref.sum() == sweepCase['counters'][v, 1]
    for axis in (0, 1):
      a = np.nonzero(mine.sum(axis=axis))[0]
      b = np.nonzero(ref.sum(axis=axis))[0]
      assert a[0] <= b[0] and b[-1] <= a[-1], (v, axis, a, b)


def test_make_sweep_step_seed_mode_is_repeatable_and_exact_in_rays():
  '''The user-level step: one call per seed, fresh histograms, exactly
  raysPerVariant rays per variant (no rounding to tiles), the same seed
  twice gives identical histograms, and columns are refused where the
  source moves.'''
  scenes, bounds, maxI = H.sweepVariants(H.torchNs(), 'radius')
  host = [sc.compile(device=None) for sc in scenes]
  spec = scenes[0].lightSources()[0].samplerSpec()
  n = 1000                                   # not a multiple of anything
  step, pack = cuda_trace.makeSweepStep(host, bounds, BINS, spec, n, maxI,
                                        H.MAX_RAY_LENGTH, H.DIST_TOL,
                                        device='cpu')
  assert step.strataTile == 0
  table = pack(host)
  rowFloats = 4 * cuda_trace.SURF_COLS + 2 * cuda_trace.ELEM_COLS
  assert table.shape == (3, rowFloats + 544) and table.dtype == np.float32
  p1, c1, segs = step(4, table)
  first = (p1.clone(), c1.clone())
  p2, c2, _ = step(4, table)
  assert torch.equal(first[0], p2) and torch.equal(first[1], c2)
  assert step.histograms.shape == (2, 3, 1) + BINS
  assert c2.sum(dim=(1, 2, 3)).tolist() == [float(n)] * 3
  assert int(segs) == int(step.counters[:, 0].sum()) == 3 * 3 * n
  p3, c3, _ = step(5, table)
  assert not torch.equal(c3, c2)

  moved, mb, mI = H.sweepVariants(H.torchNs(), 'placement')
  mhost = [sc.compile(device=None) for sc in moved]
  mspec = moved[0].lightSources()[0].samplerSpec()
  rows = np.stack([_sourceGeomRow(sc.lightSources()[0]) for sc in moved])
  mstep, mpack = cuda_trace.makeSweepStep(mhost, mb, BINS, mspec, n, mI,
                                          H.MAX_RAY_LENGTH, H.DIST_TOL,
                                          geomMode=True, device='cpu')
  with pytest.raises(ValueError, match='geomRows'):
    mpack(mhost)
  tables = dict(mstep.facts, table=torch.as_tensor(mpack(mhost, rows)))
  assert not tables['sameSource']
  hist = dict(power=torch.zeros((3, 1) + BINS), counts=torch.zeros((3, 1) + BINS))
  with pytest.raises(ValueError, match='placement or wavelength'):
    cuda_trace.traceSweep(tables, hist, n, mI, H.MAX_RAY_LENGTH, H.DIST_TOL,
                          columns=torch.zeros((8, n)))


def _variantWith(ns, **changes):
  '''A variant of the examples/3 scene with one structural change.'''
  scene, _b, _m = H.buildSweepLensScene(ns, 60.)
  lens, det = scene.getObject('Lens'), scene.getObject('Detector')
  S, T = ns.S, ns.T
  if 'extraSurface' in changes:
    det.surfaces.append(S.plane(T.translation(0, 0, 5), elem=0, radius=5.))
  if 'kind' in changes:
    lens.surfaces[1] = S.sphere(T.translation(0, 0, -200), elem=0, radius=205.,
                                zRange=(200., 205.), orient=+1)
  if 'trim' in changes:
    lens.surfaces[1] = S.plane(T.translation(0, 0, 5.), elem=0,
                               halfExtents=(20., 20.), orient=+1)
  if 'optType' in changes:
    det.OpticalType = 'Mirror'
    det.RecordHits = True
  if 'record' in changes:
    lens.RecordHits = True
  return scene


@pytest.mark.parametrize('change, reason', [
    ('extraSurface', 'surface counts differ'),
    ('kind', 'kind, trim mode or element differs'),
    ('trim', 'kind, trim mode or element differs'),
    ('optType', 'optical type, recording flag or detector differs'),
    ('record', 'optical type, recording flag or detector differs'),
])
def test_sweep_unavailable_names_the_structural_difference(change, reason):
  '''(g) what `SweepUnavailable` means: structure, not values.'''
  ns = H.torchNs()
  base, bounds, maxI = H.buildSweepLensScene(ns, 60.)
  other = _variantWith(ns, **{change: True})
  host = [base.compile(device=None), other.compile(device=None)]
  spec = base.lightSources()[0].samplerSpec()
  histSpec = torchFused.makeHistogramSpec(*host[0], bounds=bounds, bins=BINS)
  with pytest.raises(cuda_trace.SweepUnavailable, match=reason):
    cuda_trace.packSweepTables([h for h, _i in host], histSpec, [spec] * 2)


def test_sweep_unavailable_for_one_variant_and_swept_index_is_data():
  ns = H.torchNs()
  base, bounds, maxI = H.buildSweepLensScene(ns, 60.)
  host = [base.compile(device=None)]
  spec = base.lightSources()[0].samplerSpec()
  with pytest.raises(cuda_trace.SweepUnavailable, match='>= 2 variants'):
    cuda_trace.makeSweepStep(host, bounds, BINS, spec, 256, maxI, 1000., 1e-4,
                             device='cpu')
  with pytest.raises(cuda_trace.SweepUnavailable, match='point-source'):
    cuda_trace.makeSweepStep(host * 2, bounds, BINS, None, 256, maxI, 1000.,
                             1e-4, device='cpu')
  # a swept refractive index changes an ELEMENT row: still one launch
  other, _b, _m = H.buildSweepLensScene(ns, 60.)
  other.getObject('Lens').RefractiveIndex = 1.7
  step, pack = cuda_trace.makeSweepStep(
      host + [other.compile(device=None)], bounds, BINS, spec, 512, maxI,
      1000., 1e-4, device='cpu')
  _p, counts, _s = step(1, pack(host + [other.compile(device=None)]))
  assert float((counts[0] - counts[1]).abs().sum()) > 0
