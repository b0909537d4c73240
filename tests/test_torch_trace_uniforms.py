'''Mode (b) of the PyTorch port's trace step against the JAX package: the
in-kernel point-source sampler of both sides is fed the SAME uniforms — the
ones the JAX step draws for its `uniformProvider='input'` seam — with the
tile strata on (cell = ray index // tile on both sides).

Tolerances as in test_torch_trace.py: counters equal, counts within the
2-ray bin-edge budget, power per bin within 1 % of the Pallas kernel (bf16
one-hot binning).
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

UNIFORM_SCENES = ('lensMirror', 'sourceDetector')


@pytest.fixture(scope='module', params=UNIFORM_SCENES)
def uniformsCase(request):
  '''One scene, mode (b): the JAX kernel's sampler and the port's are fed
  the same uniforms, strata included (cell = ray index // tile).'''
  name = request.param
  scene, bounds, maxI = H.SCENES_BY_NAME[name](H.jaxNs())
  deviceNp, histNp, spec = H.referenceArrays(scene, bounds)
  tables = convert.sceneFromReference(deviceNp, histNp, samplerSpec=spec,
                                      device='cpu')
  ref, us = H.runReferenceUniforms(scene, bounds, maxI)
  hist = torchFused.initHistograms(histNp, device='cpu')
  c = cuda_trace.traceHistogram(
      tables, hist, H.N_RAYS, maxI, H.MAX_RAY_LENGTH, H.DIST_TOL, hitSlots=1,
      uniforms=torch.as_tensor(us), strataTile=H.TILE)
  port = dict(counts=hist['counts'].numpy(), power=hist['power'].numpy(),
              counters=dict(segments=int(c[0]), hits=int(c[1]),
                            hitOverflow=int(c[2])))
  return dict(ref=ref, port=port)


def test_uniforms_counters_equal(uniformsCase):
  ref, port = uniformsCase['ref'], uniformsCase['port']
  for k in ('segments', 'hits', 'hitOverflow'):
    assert port['counters'][k] == ref['counters'][k], k


def test_uniforms_counts_and_power_match(uniformsCase):
  ref, port = uniformsCase['ref'], uniformsCase['port']
  assert H.nearlyEqualCounts(port['counts'], ref['counts'])
  same = (ref['counts'] == port['counts']) & (ref['counts'] > 0)
  np.testing.assert_allclose(port['power'][same], ref['power'][same],
                             rtol=1e-2)


def test_strata_confine_each_cell(uniformsCase):
  '''With strata on, hits stay plentiful: nothing was lost to the remap.'''
  assert uniformsCase['port']['counters']['hits'] > 0.9 * H.N_RAYS
