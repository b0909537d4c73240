'''B11: what the port's two histogram kernels must compute where thousands
of rays pile into a few bins (the kernels group a warp's lanes by bin and
add once a group; `cuda_trace.HIST_MODE`).

A pile-up (`torch_port_helpers.buildPileUpScene`: every ray within 0.12 mm
of the corner where four bins meet) at 64 x 64 and at 128 x 128 bins over
+-40 mm, through the plain versions of K1 (`traceHistogram` on the CPU, at
each of two source placements) and K3 (`traceSweep`, the two placements as
variants) against the JAX package's Pallas kernel in interpret mode, fed
the same uniforms: counters equal, counts EQUAL (no ray lies near a bin
edge but at the corner, 2 mrad cones of power-1 rays), power per bin within
rtol 1e-4 (each ray carries power 1, so the sums are exact integers on both
sides).
'''

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (both frameworks live in this process)

import torch_port_helpers as H
from optics_design_workbench_tpu.jupyter_utils.parameter_sweeper import \
    _sourceGeomRow as refGeomRow
from optics_design_workbench_tpu_torch import convert
from optics_design_workbench_tpu_torch.ops import cuda_trace as C
from optics_design_workbench_tpu_torch.tracing import fused

torch.set_num_threads(1)

N = 1 << 11
OFFSETS = (0., 10.)               # the sweep's two source placements (mm)


# ------------------------------------------------------------------ pile-up

@pytest.fixture(scope='module', params=[(64, 64), (128, 128)],
                ids=['64', '128'])
def pileUp(request):
  '''The pile-up at both placements through the JAX Pallas kernel
  (interpret mode) fed uniforms, at this many bins, and the port's tables of
  each.'''
  bins = request.param
  ns = H.jaxNs()
  scenes = [H.buildPileUpScene(ns, x) for x in OFFSETS]
  bounds, maxI = scenes[0][1], scenes[0][2]
  refs = [H.runReferenceUniforms(sc, bounds, maxI, n=N, bins=bins)
          for sc, _b, _m in scenes]
  arrays = [H.referenceArrays(sc, bounds, bins=bins) for sc, _b, _m in scenes]
  return dict(scenes=[sc for sc, _b, _m in scenes], bounds=bounds,
              maxI=maxI, refs=refs, arrays=arrays, bins=bins)


def _assertPileUp(counters, counts, power, ref):
  for k, v in zip(('segments', 'hits', 'hitOverflow'), counters):
    assert int(v) == ref['counters'][k], k
  assert ref['counters']['hits'] == N
  np.testing.assert_array_equal(counts, ref['counts'])
  assert np.count_nonzero(ref['counts']) <= 4
  filled = ref['counts'] > 0
  np.testing.assert_allclose(power[filled], ref['power'][filled], rtol=1e-4)


@pytest.mark.parametrize('placement', range(len(OFFSETS)))
def test_pile_up_k1_plain_against_reference(pileUp, placement):
  ref, us = pileUp['refs'][placement]
  deviceNp, histNp, spec = pileUp['arrays'][placement]
  assert np.count_nonzero(ref['counts']) == 4      # the four-bin corner
  tables = convert.sceneFromReference(deviceNp, histNp, samplerSpec=spec,
                                      device='cpu')
  hist = fused.initHistograms(histNp, device='cpu')
  c = C.traceHistogram(tables, hist, N, pileUp['maxI'], H.MAX_RAY_LENGTH,
                       H.DIST_TOL, uniforms=torch.as_tensor(us),
                       strataTile=H.TILE)
  _assertPileUp(c.tolist(), hist['counts'].numpy(), hist['power'].numpy(),
                ref)


def test_pile_up_k3_plain_against_reference(pileUp):
  hostScenes = []
  for sc in pileUp['scenes']:
    host, _info = sc.compile(devicePut=False)
    host['powerTol'] = 1e-6
    hostScenes.append(host)
  geoms = np.stack([refGeomRow(sc.lightSources()[0])
                    for sc in pileUp['scenes']])
  _deviceNp, histNp, spec = pileUp['arrays'][0]
  tables = convert.sweepFromReference(hostScenes, histNp, spec,
                                      geomRows=geoms, device='cpu')
  V = len(OFFSETS)
  hist = dict(power=torch.zeros((V, 1) + pileUp['bins']),
              counts=torch.zeros((V, 1) + pileUp['bins']))
  us = pileUp['refs'][0][1]
  for ref, usV in pileUp['refs']:
    np.testing.assert_array_equal(usV, us)          # common random numbers
  c = C.traceSweep(tables, hist, N, pileUp['maxI'], H.MAX_RAY_LENGTH,
                   H.DIST_TOL, uniforms=torch.as_tensor(us),
                   strataTile=H.TILE)
  for v, (ref, _us) in enumerate(pileUp['refs']):
    _assertPileUp(c[v].tolist(), hist['counts'][v].numpy(),
                  hist['power'][v].numpy(), ref)
