'''The PyTorch port's trace step (ops/cuda_trace, the module that holds the
CUDA kernel) against the JAX package on the same numpy-seeded inputs.

On the CPU the port runs the kernel's plain PyTorch version; the JAX kernel
runs in Mosaic interpret mode exactly as tests/test_pallas_interpret.py runs
it. Mode (c): numpy-made ray columns go into the interpret-mode Pallas
kernel, the XLA fused step and the port. (Mode (b), the in-kernel sampler
fed uniforms, is in test_torch_trace_uniforms.py.)

Tolerances: segment / hit / overflow counters equal; counts equal bin for
bin up to the reference suite's own budget of 2 rays crossing a bin edge
(float op order differs by an ulp between XLA fusions and eager torch);
power per bin within 1 % of the Pallas kernel (its bf16 one-hot binning
costs ~0.5 % per bin) and within rtol 1e-5 of the XLA fused step (float32
on both sides, different summation order).
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

SCENES = ('lensMirror', 'sourceDetector', 'tir', 'absorbing')


def _portRun(tables, histNp, maxIntersections, hitSlots, **inputs):
  hist = torchFused.initHistograms(histNp, device='cpu')
  c = cuda_trace.traceHistogram(
      tables, hist, H.N_RAYS, maxIntersections, H.MAX_RAY_LENGTH, H.DIST_TOL,
      hitSlots=hitSlots, **inputs)
  return dict(counts=hist['counts'].numpy(), power=hist['power'].numpy(),
              counters=dict(segments=int(c[0]), hits=int(c[1]),
                            hitOverflow=int(c[2])))


@pytest.fixture(scope='module', params=SCENES)
def columnsCase(request):
  '''One scene, mode (c): reference results (built once per module) and
  the port's result on the same columns.'''
  name = request.param
  scene, bounds, maxI = H.SCENES_BY_NAME[name](H.jaxNs())
  deviceNp, histNp, spec = H.referenceArrays(scene, bounds)
  tables = convert.sceneFromReference(deviceNp, histNp, samplerSpec=spec,
                                      device='cpu')
  rng = np.random.default_rng(20261016)
  u = torch.as_tensor(rng.random((2, H.N_RAYS), dtype=np.float32))
  cols = cuda_trace.sampleRaysPlain(tables, u[0], u[1])
  colsT = torch.stack(list(cols) + [torch.full_like(cols[0], 532.)])
  colsNp = {k: colsT[i].numpy().copy() for i, k in enumerate(H.COLS)}
  ref = H.runReferenceColumns(scene, colsNp, bounds, maxI)
  hitSlots = cuda_trace.autoHitSlots(deviceNp, histNp, maxI)
  port = _portRun(tables, histNp, maxI, hitSlots, columns=colsT.contiguous())
  return dict(name=name, ref=ref, port=port, hitSlots=hitSlots)


def test_columns_counters_equal_pallas(columnsCase):
  ref, port = columnsCase['ref']['pallas'], columnsCase['port']
  for k in ('segments', 'hits', 'hitOverflow'):
    assert port['counters'][k] == ref['counters'][k], k
  assert port['counters']['hits'] > H.N_RAYS // 4


def test_columns_counters_equal_fused(columnsCase):
  ref, port = columnsCase['ref']['fused'], columnsCase['port']
  assert port['counters']['segments'] == ref['counters']['segments']
  assert port['counters']['hits'] == ref['counters']['hits']


def test_columns_counts_match(columnsCase):
  port = columnsCase['port']
  for side in ('pallas', 'fused'):
    assert H.nearlyEqualCounts(port['counts'],
                               columnsCase['ref'][side]['counts']), side


def test_columns_power_within_bf16_of_pallas(columnsCase):
  ref, port = columnsCase['ref']['pallas'], columnsCase['port']
  same = (ref['counts'] == port['counts']) & (ref['counts'] > 0)
  assert same.sum() > 10
  np.testing.assert_allclose(port['power'][same], ref['power'][same],
                             rtol=1e-2)


def test_columns_power_matches_fused_f32(columnsCase):
  ref, port = columnsCase['ref']['fused'], columnsCase['port']
  same = (ref['counts'] == port['counts']) & (ref['counts'] > 0)
  assert same.sum() > 10
  np.testing.assert_allclose(port['power'][same], ref['power'][same],
                             rtol=1e-5)


def test_scene_branches_are_exercised(columnsCase):
  '''The special scenes do hit the branch they were built for.'''
  name, port = columnsCase['name'], columnsCase['port']
  n, segs = H.N_RAYS, port['counters']['segments']
  if name == 'tir':
    # entry, total reflection at the hypotenuse, exit, detector
    assert segs == 4 * n and port['counters']['hits'] == n
  elif name == 'absorbing':
    assert columnsCase['hitSlots'] == 2
    assert port['counters']['hits'] > 1.5 * n      # two passes per ray
    # Beer-Lambert and the 0.9 mirror: mean recorded power well below 1
    assert port['power'].sum() / port['counts'].sum() < 0.7
  elif name == 'lensMirror':
    assert abs(segs / n - 4.) < 0.1
  else:
    assert segs == n


def test_ring_overflow_overwrites_last_slot():
  '''hitSlots = 1 on the two-pass scene: the second pass overwrites the
  first, one overflow per two-pass ray, and the histogram holds exactly the
  last passes — the full ring's histogram minus its first-slot entries.'''
  scene, bounds, maxI = H.buildAbsorbingScene(H.torchNs())
  sceneNp, info = scene.compile(device=None)
  histSpec = torchFused.makeHistogramSpec(sceneNp, info, bounds=bounds,
                                          bins=H.BINS)
  spec = scene.lightSources()[0].samplerSpec()
  tables = cuda_trace.buildTraceTables(sceneNp, histSpec, samplerSpec=spec,
                                       device='cpu')
  rng = np.random.default_rng(3)
  us = torch.as_tensor(rng.random((2, H.N_RAYS), dtype=np.float32))
  full = _portRun(tables, histSpec, maxI, 2, uniforms=us)
  one = _portRun(tables, histSpec, maxI, 1, uniforms=us)
  assert full['counters']['hitOverflow'] == 0
  assert one['counters']['hitOverflow'] == \
      full['counters']['hits'] - one['counters']['hits']
  assert one['counters']['hits'] <= H.N_RAYS
  assert one['counters']['segments'] == full['counters']['segments']
  # the kept pass is the weaker (later) one
  assert one['power'].sum() < full['power'].sum() / 2
