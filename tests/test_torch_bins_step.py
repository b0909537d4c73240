'''The PyTorch port's per-ray-bin step (ops/cuda_trace.traceBins + binRing,
the module that holds the per-ray-bin CUDA kernel; reached through
`makeTraceStep(..., histPrecision='highest')`) against the JAX package's
fused step and against the port's in-kernel-histogram step, on the same
numpy-seeded ray columns. On the CPU the port runs the plain versions.

Tolerances: counters equal; counts equal bin for bin up to the reference
suite's budget of 2 rays crossing a bin edge against the JAX step (float op
order differs by an ulp between XLA fusions and eager torch) and exactly
against the port's own histogram step (same arithmetic); power per bin
within rtol 1e-5 (float32 sums in another order on the JAX side, float64
accumulation rounded to float32 on the port's).
'''

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (both frameworks live in this process)

import torch_port_helpers as H
from optics_design_workbench_tpu_torch import convert
from optics_design_workbench_tpu_torch.ops import cuda_trace
from optics_design_workbench_tpu_torch.tracing import fused as torchFused

torch.set_num_threads(1)

CASES = (('lensMirror', 'auto'), ('absorbing', 'auto'), ('absorbing', 1),
         ('stacked', 'auto'))
POWER_RTOL = 1e-5


@pytest.fixture(scope='module', params=CASES,
                ids=lambda c: f'{c[0]}-{c[1]}')
def binsCase(request):
  name, slots = request.param
  scene, bounds, maxI = H.SCENES_BY_NAME[name](H.jaxNs())
  deviceNp, histNp, spec = H.referenceArrays(scene, bounds)
  tables = convert.sceneFromReference(deviceNp, histNp, samplerSpec=spec,
                                      device='cpu')
  hitSlots = (cuda_trace.autoHitSlots(deviceNp, histNp, maxI)
              if slots == 'auto' else slots)
  rng = np.random.default_rng(20261017)
  u = torch.as_tensor(rng.random((2, H.N_RAYS), dtype=np.float32))
  cols = cuda_trace.sampleRaysPlain(tables, u[0], u[1])
  colsT = torch.stack(list(cols) + [torch.full_like(cols[0], 532.)]) \
      .contiguous()
  colsNp = {k: colsT[i].numpy().copy() for i, k in enumerate(H.COLS)}
  ref = H.runReferenceColumns(scene, colsNp, bounds, maxI, hitSlots=slots,
                              withPallas=False)['fused']
  kw = dict(hitSlots=hitSlots, columns=colsT)
  ring, c = cuda_trace.traceBins(tables, H.N_RAYS, maxI, H.MAX_RAY_LENGTH,
                                 H.DIST_TOL, **kw)
  hist = torchFused.initHistograms(histNp, device='cpu')
  cuda_trace.binRing(hist, ring)
  histK1 = torchFused.initHistograms(histNp, device='cpu')
  c1 = cuda_trace.traceHistogram(tables, histK1, H.N_RAYS, maxI,
                                 H.MAX_RAY_LENGTH, H.DIST_TOL, **kw)
  return dict(name=name, slots=slots, hitSlots=hitSlots, ref=ref, ring=ring,
              counters=c.tolist(), hist=hist, histK1=histK1,
              countersK1=c1.tolist())


def test_bins_counters_equal(binsCase):
  seg, hits, ovf = binsCase['counters']
  assert binsCase['counters'] == binsCase['countersK1']
  assert seg == binsCase['ref']['counters']['segments']
  if binsCase['slots'] == 'auto':
    # the XLA fused step keeps every pass; so does a ring that is deep enough
    assert ovf == 0 and hits == binsCase['ref']['counters']['hits']
  else:
    assert hits + ovf == binsCase['ref']['counters']['hits']


def test_bins_ring_layout(binsCase):
  ring = binsCase['ring']
  assert ring.shape == (3, binsCase['hitSlots'], H.N_RAYS)
  assert ring.dtype == torch.float32
  filled = ring[0] >= 0
  assert int(filled.sum()) == binsCase['counters'][1]
  assert (ring[0][~filled] == -1).all()
  assert (ring[1:, ~filled] == 0).all()
  assert (ring[2][filled] == 1).all()
  assert (ring[0] == torch.floor(ring[0])).all()
  # slots fill in order: a later slot is never filled before an earlier one
  assert (filled[1:] <= filled[:-1]).all()


def test_bins_match_the_histogram_step_exactly(binsCase):
  a, b = binsCase['hist'], binsCase['histK1']
  assert torch.equal(a['counts'], b['counts'])
  torch.testing.assert_close(a['power'], b['power'], rtol=POWER_RTOL,
                             atol=0.)


def test_bins_match_the_jax_fused_step(binsCase):
  if binsCase['slots'] != 'auto':
    # the XLA fused step has no ring to overflow: compare what a one-slot
    # ring must hold instead — exactly one pass per ray that had any
    counts = binsCase['hist']['counts'].numpy()
    assert counts.sum() == binsCase['counters'][1]
    return
  ref, hist = binsCase['ref'], binsCase['hist']
  counts, power = hist['counts'].numpy(), hist['power'].numpy()
  assert H.nearlyEqualCounts(counts, ref['counts'])
  same = (ref['counts'] == counts) & (ref['counts'] > 0)
  assert same.sum() > 10
  np.testing.assert_allclose(power[same], ref['power'][same],
                             rtol=POWER_RTOL)


def test_make_trace_step_hist_precision_routes():
  '''`makeTraceStep(histPrecision=...)`: 'default' and 'highest' give the
  same counters and counts on the same seed, power within POWER_RTOL;
  anything else is refused.'''
  scene, bounds, maxI = H.buildBench(H.torchNs(), 'lensMirror')
  sceneNp, info = scene.compile(device=None)
  histSpec = torchFused.makeHistogramSpec(sceneNp, info, bounds=bounds,
                                          bins=H.BINS)
  src = scene.lightSources()[0]
  out = {}
  for precision in ('default', 'highest'):
    step = cuda_trace.makeTraceStep(
        sceneNp, histSpec, src.deviceColumnsGenerator(device='cpu'),
        raysPerStep=H.N_RAYS, maxIntersections=maxI,
        maxRayLength=H.MAX_RAY_LENGTH, distTol=H.DIST_TOL,
        sampler=src.samplerSpec(), histPrecision=precision, device='cpu')
    hist, c = step(11, torchFused.initHistograms(histSpec, device='cpu'))
    hist, c2 = step(12, hist)
    out[precision] = (hist, {k: int(v) + int(c2[k]) for k, v in c.items()})
  assert out['default'][1] == out['highest'][1]
  assert torch.equal(out['default'][0]['counts'], out['highest'][0]['counts'])
  torch.testing.assert_close(out['default'][0]['power'],
                             out['highest'][0]['power'], rtol=POWER_RTOL,
                             atol=0.)
  with pytest.raises(ValueError, match='histPrecision'):
    cuda_trace.makeTraceStep(
        sceneNp, histSpec, None, raysPerStep=H.N_RAYS, maxIntersections=maxI,
        maxRayLength=H.MAX_RAY_LENGTH, distTol=H.DIST_TOL,
        sampler=src.samplerSpec(), histPrecision='high', device='cpu')


def test_bins_wrapper_refuses_a_histogram_beyond_float32_indices():
  scene, bounds, maxI = H.buildBench(H.torchNs(), 'sourceDetector')
  sceneNp, info = scene.compile(device=None)
  histSpec = torchFused.makeHistogramSpec(sceneNp, info, bounds=bounds,
                                          bins=(4096, 4097))
  tables = cuda_trace.buildTraceTables(
      sceneNp, histSpec, samplerSpec=scene.lightSources()[0].samplerSpec(),
      device='cpu')
  with pytest.raises(ValueError, match='float32'):
    cuda_trace.traceBins(tables, 256, maxI, 1000., 1e-4, seed=1)
