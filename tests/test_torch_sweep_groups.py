'''The sweep kernel's variant groups (`ops.cuda_trace.sweepVariantGroup`,
`sweepGroups`, `sharedDrawsOf`) and its plain version's one draw per ray
(`sampleLocalPlain` + `placeRaysPlain`), on the CPU:

  * the host's group rule: the groups cover every variant once, the last
    one shorter where the group does not divide the variants, one group
    where it is larger than the sweep; on a model of an H100's launch facts
    the rule's group keeps its instance's blocks an SM and fills the card
    SWEEP_WAVES times, and the next group up breaks one of the two; groups
    only where the variants share the draw and the kernel samples;
  * `sharedDraws`: true for a lens-radius, a wavelength and a
    source-placement sweep (only the placement and the wavelength differ),
    false for two Gaussian beam widths (the marginals differ; their
    `sameSource`, which asks of the placement and wavelength only, holds);
  * the split draw + placement equals the point sampler's one-piece form
    bit for bit, with and without strata, and the draw of one variant
    placed by another equals that variant's own sample;
  * a 3-variant wavelength sweep of the spectrometer: the plain version
    draws once for the sweep and holds, per variant, against the JAX
    package's single-scene kernel (interpret mode) fed the same uniforms,
    with the tolerances of test_torch_sweep_step.py: counters equal,
    counts within the 2-ray bin-edge budget, power per bin within 1 % (the
    reference bins in bf16).
'''

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (both frameworks live in this process)

import torch_port_helpers as H
from optics_design_workbench_tpu.jupyter_utils.parameter_sweeper import \
    _sourceGeomRow as refGeomRow
from optics_design_workbench_tpu_torch import benchmarks, convert
from optics_design_workbench_tpu_torch.ops import cuda_trace
from optics_design_workbench_tpu_torch.tracing import fused as torchFused

torch.set_num_threads(1)

BOUNDS = (-40., 40., -40., 40.)
SPECTRO_BOUNDS = (-80., 80., -80., 80.)
WAVELENGTHS = (450., 550., 650.)


@pytest.mark.parametrize('V,group', [(11, 4), (11, 8), (64, 8), (16, 16),
                                     (3, 16), (5, 1)])
def test_groups_cover_every_variant_once(V, group):
  groups = cuda_trace.sweepGroups(V, group)
  covered = [v for first, count in groups for v in range(first,
                                                         first + count)]
  assert covered == list(range(V))
  assert all(count == group for _f, count in groups[:-1])
  if V <= group:
    assert groups == [(0, V)]
  else:
    assert groups[-1][1] == (V % group or group)


# a model of the kernel library's launch facts on an H100 (csrc
# `planSweep`): 132 SMs of 228 KB shared memory, 1 KB of it reserved per
# block; a grouped block holds its group's tables, 3 totals a variant and
# warp, and 6 floats a thread
SM_COUNT = 132
SM_SHARED_BYTES = 228 * 1024


def _modelPlan(V, tableLen, regBlocks):
  def plan(vb):
    held = min(vb, V)
    nbytes = 4 * (held * (tableLen + 3 * 256 // 32) + 6 * 256)
    return (nbytes, min(regBlocks, SM_SHARED_BYTES // (nbytes + 1024)),
            regBlocks)
  return plan


@pytest.mark.parametrize('V,n,tableLen,regBlocks,want', [
    (11, 200_000, 660, 5, 4),           # the user's shape: examples/3
    (64, 1 << 20, 660, 5, 8),           # the design study
    (64, 1 << 20, 620, 4, 16),          # the spectrometer (B4)
    (11, 1 << 18, 660, 5, 8),           # a shorter last group
    (3, 1 << 20, 660, 5, 16),           # a group larger than the sweep
    (3, 1 << 18, 660, 5, 2),            # too few rays for larger groups
    (64, 1 << 20, 20000, 5, 1),         # a table too long to hold two
    (4, 100_000, 660, 5, 1),            # evaluateBatched's default rays
    (8, 100_000, 660, 5, 1),
    (16, 100_000, 660, 5, 2)])
def test_variant_group_rule(V, n, tableLen, regBlocks, want):
  plan = _modelPlan(V, tableLen, regBlocks)
  vb = cuda_trace.sweepVariantGroup(V, n, plan, SM_COUNT)
  assert vb == want
  tiles = -(-n // cuda_trace.KERNEL_BLOCK)

  def fits(g):
    _b, blocks, allowed = plan(g)
    return blocks >= allowed and tiles * len(cuda_trace.sweepGroups(V, g)) \
        >= cuda_trace.SWEEP_WAVES * SM_COUNT * blocks

  if vb > 1:
    assert fits(vb)
  if vb < cuda_trace.MAX_VARIANT_GROUP:   # the next group up breaks a limit
    assert not fits(2 * vb)


def _pack(scenes, bounds, specs=None):
  host = [sc.compile(device=None) for sc in scenes]
  histSpec = torchFused.makeHistogramSpec(*host[0], bounds=bounds,
                                          bins=(32, 32))
  if specs is None:
    specs = [sc.lightSources()[0].samplerSpec() for sc in scenes]
  return cuda_trace.buildSweepTables([h for h, _i in host], histSpec, specs,
                                     device='cpu')


def _beamWidths(widths):
  scenes = []
  for w in widths:
    scene = benchmarks.buildSweepLensScene(60.)
    scene.lightSources()[0].PowerDensity = f'exp(-r^2/{w:g})'
    scenes.append(scene)
  return scenes


@pytest.fixture(scope='module')
def sweeps():
  '''The four sweeps, each source's sampler spec made once (a spectrometer
  spec takes seconds) and varied as `evaluateBatched` varies it.'''
  lens = [benchmarks.buildSweepLensScene(r) for r in (45., 60., 80.)]
  spectro = [benchmarks.buildSpectrometerScene(wavelength=w)
             for w in WAVELENGTHS]
  spec = lens[0].lightSources()[0].samplerSpec()
  spectroSpec = spectro[0].lightSources()[0].samplerSpec()
  offsets = np.array([[1, 0, 0, 0, 1, 0, 0, 0, 1, x, 0., 1e-3, 532.]
                      for x in (0., 15., -25.)])
  return dict(
      radius=_pack(lens, BOUNDS, [spec] * 3),
      wavelength=_pack(spectro, SPECTRO_BOUNDS,
                       [dict(spectroSpec, wavelength=w)
                        for w in WAVELENGTHS]),
      placement=_pack([lens[1]] * 3, BOUNDS,
                      [cuda_trace.samplerSpecWithGeom(spec, row)
                       for row in offsets]),
      beamWidths=_pack(_beamWidths((50., 20.)), BOUNDS))


@pytest.mark.parametrize('kind,shared,same', [
    ('radius', True, True), ('wavelength', True, False),
    ('placement', True, False), ('beamWidths', False, True)])
def test_shared_draws(sweeps, kind, shared, same):
  t = sweeps[kind]
  assert t['sharedDraws'] is shared
  assert t['sameSource'] is same
  assert cuda_trace.sharedDrawsOf(t['table'].numpy(),
                                  t['samplerOff']) is shared


@pytest.mark.parametrize('kind,mode,allowed', [
    ('radius', cuda_trace.MODE_SEED, True),
    ('radius', cuda_trace.MODE_UNIFORMS, True),
    ('radius', cuda_trace.MODE_COLUMNS, False),
    ('wavelength', cuda_trace.MODE_SEED, True),
    ('placement', cuda_trace.MODE_UNIFORMS, True),
    ('beamWidths', cuda_trace.MODE_SEED, False)])
def test_groups_only_where_the_draw_is_shared(sweeps, kind, mode, allowed):
  assert cuda_trace.sweepGroupsAllowed(sweeps[kind], mode) is allowed


def _oneStepSample(tables, u1, u2, strata, strataTile):
  '''The point sampler in one piece, as it was written before the draw and
  the placement were split: stratify, the two marginals, the focal
  geometry, the placement.'''
  tab = tables['table'].numpy()
  sg = tab[tables['samplerOff']:]
  if strata is not None:
    G1, G2 = strata
    cell = torch.arange(u1.shape[0]) // int(strataTile)
    u1 = ((cell // G2).to(torch.float32) + u1) * float(np.float32(1. / G1))
    u2 = ((cell % G2).to(torch.float32) + u2) * float(np.float32(1. / G2))
  t = cuda_trace._marginalPlain(sg[16:16 + 264], u1)
  p = cuda_trace._marginalPlain(sg[16 + 264:16 + 528], u2)
  f32 = lambda x: float(np.float32(x))
  sp, cp = torch.sin(p), torch.cos(p)
  if sg[0] != 0.:
    st, ct = torch.sin(t), torch.cos(t)
    ldx, ldy, ldz = st * sp, -st * cp, ct
    f = float(sg[1])
    lox, loy, loz = f32(-f) * ldx, f32(-f) * ldy, f32(f) * (1. - ldz)
  else:
    ldx, ldy, ldz = torch.zeros_like(t), torch.zeros_like(t), \
        torch.ones_like(t)
    lox, loy, loz = t * cp, -t * sp, torch.zeros_like(t)
  r = [[f32(x) for x in row] for row in sg[2:11].reshape(3, 3)]
  o = [f32(x) for x in sg[11:14]]
  return (r[0][0] * lox + r[0][1] * loy + r[0][2] * loz + o[0],
          r[1][0] * lox + r[1][1] * loy + r[1][2] * loz + o[1],
          r[2][0] * lox + r[2][1] * loy + r[2][2] * loz + o[2],
          r[0][0] * ldx + r[0][1] * ldy + r[0][2] * ldz,
          r[1][0] * ldx + r[1][1] * ldy + r[1][2] * ldz,
          r[2][0] * ldx + r[2][1] * ldy + r[2][2] * ldz,
          torch.ones_like(t))


@pytest.mark.parametrize('kind', ['radius', 'wavelength', 'placement'])
@pytest.mark.parametrize('strataTile', [0, 256])
def test_split_draw_equals_one_piece_sample(sweeps, kind, strataTile):
  t = sweeps[kind]
  n = 4096
  rng = np.random.default_rng(17)
  u = torch.as_tensor(rng.random((2, n), dtype=np.float32))
  strata = cuda_trace.tileStrata(n, strataTile) if strataTile else None
  local = cuda_trace.sampleLocalPlain(cuda_trace.variantTables(t, 0), u[0],
                                      u[1], strata, strataTile)
  for v in range(t['nVariants']):
    tables = cuda_trace.variantTables(t, v)
    want = _oneStepSample(tables, u[0], u[1], strata, strataTile)
    for got in (cuda_trace.placeRaysPlain(tables, local),
                cuda_trace.sampleRaysPlain(tables, u[0], u[1], strata,
                                           strataTile)):
      for a, b in zip(got, want):
        assert torch.equal(a, b), (kind, v)


@pytest.fixture(scope='module')
def spectroCase():
  '''The spectrometer at three wavelengths: the JAX package's
  single-scene kernel per variant (interpret mode, its uniform seam) and
  the port's sweep tables from the same compiled variants.'''
  scenes = [H.jaxSceneFromPort(benchmarks.buildSpectrometerScene(
      wavelength=w)) for w in WAVELENGTHS]
  refs, us = [], None
  for sc in scenes:
    ref, u = H.runReferenceUniforms(sc, SPECTRO_BOUNDS, 3, n=H.N_RAYS,
                                    tile=H.TILE)
    assert us is None or np.array_equal(u, us)
    refs.append(ref)
    us = u
  hostNp = []
  for sc in scenes:
    host, _info = sc.compile(devicePut=False)
    host['powerTol'] = 1e-6
    hostNp.append(host)
  _d, histNp, spec = H.referenceArrays(scenes[0], SPECTRO_BOUNDS)
  geoms = np.stack([refGeomRow(sc.lightSources()[0]) for sc in scenes])
  tables = convert.sweepFromReference(hostNp, histNp, spec, geomRows=geoms,
                                      device='cpu')
  return dict(refs=refs, us=us, tables=tables)


def test_grouped_plain_spectrometer_against_jax_single_scene(spectroCase,
                                                              monkeypatch):
  t = spectroCase['tables']
  assert t['sharedDraws'] and not t['sameSource'] and t['hasGrating']
  draws = []
  local = cuda_trace.sampleLocalPlain
  monkeypatch.setattr(cuda_trace, 'sampleLocalPlain',
                      lambda *a, **k: draws.append(1) or local(*a, **k))
  V = t['nVariants']
  shape = (V, t['nDet']) + tuple(t['bins'])
  hist = dict(power=torch.zeros(shape), counts=torch.zeros(shape))
  counters = cuda_trace.traceSweep(
      t, hist, H.N_RAYS, 3, H.MAX_RAY_LENGTH, H.DIST_TOL, hitSlots=1,
      uniforms=torch.as_tensor(spectroCase['us']), strataTile=H.TILE)
  assert len(draws) == 1                  # one draw for the whole sweep
  for v, ref in enumerate(spectroCase['refs']):
    port = dict(counts=hist['counts'][v].numpy(),
                power=hist['power'][v].numpy(),
                counters=dict(zip(('segments', 'hits', 'hitOverflow'),
                                  counters[v].tolist())))
    H.assertHistogramsMatch(dict(hist=(ref, port)))
  assert not torch.equal(hist['counts'][0], hist['counts'][2])
