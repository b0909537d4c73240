'''Dispersive glass in the PyTorch port (n(wavelength) as a per-element
Horner polynomial in the trace kernels' shared body; on the CPU their plain
versions) against the JAX package, on the lens-and-mirror scene with a
Cauchy lens, `1.5046 + 4200/wavelength^2` (BK7's A and B, wavelength in nm),
and the source at 486 nm:

  * `Scene.compile` builds the same `nLambda`, `nTable`, `hasDispersion` as
    the JAX package, and the kernel table carries the reference's
    polynomial (`_dispersionPolys`: the lowest even degree <= 12 that fits
    the table to 2e-5 in the scaled wavelength);
  * the Pallas kernel (interpret mode) and the port's plain versions, fed
    the same uniforms: counters equal, counts within the 2-ray bin-edge
    budget, power per bin within 1 % (bf16 binning of the reference), raw
    rows ray by ray within atol 1e-4;
  * the XLA fused step interpolates the table linearly where the kernels
    evaluate the polynomial, so it is compared by distribution on the same
    numpy-made ray columns: counters within 0.1 %, count marginals within
    L1 0.01;
  * a row no such polynomial fits is refused by name, as the reference's
    `pallasIneligibleReason` refuses it.
'''

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (both frameworks live in this process)

import torch_port_helpers as H
from optics_design_workbench_tpu.ops import pallas_trace
from optics_design_workbench_tpu_torch import convert
from optics_design_workbench_tpu_torch.ops import cuda_trace
from optics_design_workbench_tpu_torch.tracing import fused as torchFused

torch.set_num_threads(1)

WIGGLY_GLASS = '1.5 + 0.01*sin(wavelength/10)'


@pytest.fixture(scope='module')
def cauchyCase():
  return H.runB4Case('cauchyLensMirror')


def test_dispersive_histograms_match_reference(cauchyCase):
  H.assertHistogramsMatch(cauchyCase)


def test_dispersive_raw_rows_match_reference(cauchyCase):
  H.assertRawRowsMatch(cauchyCase)


def test_compile_builds_the_reference_dispersion_table():
  jaxScene, _, _ = H.buildDispersiveLensMirrorScene(H.jaxNs())
  torchScene, _, _ = H.buildDispersiveLensMirrorScene(H.torchNs())
  ref, _ = jaxScene.compile(devicePut=False)
  own, _ = torchScene.compile(device=None)
  for k in ('nLambda', 'nTable', 'hasDispersion'):
    np.testing.assert_array_equal(own['elements'][k],
                                  np.asarray(ref['elements'][k]), err_msg=k)
  assert own['elements']['hasDispersion'].tolist() == [True, False, False]


def test_kernel_table_carries_the_reference_polynomial():
  '''The dispersion block of the kernel table: mid, 1/half and every
  coefficient of the reference's fit, each rounded to float32 once.'''
  jaxScene, bounds, _ = H.buildDispersiveLensMirrorScene(H.jaxNs())
  deviceNp, histNp, spec = H.referenceArrays(jaxScene, bounds)
  refPolys = pallas_trace._dispersionPolys(deviceNp)
  assert cuda_trace._dispersionPolys(deviceNp) == refPolys
  assert list(refPolys) == [0]
  tables = convert.sceneFromReference(deviceNp, histNp, samplerSpec=spec,
                                      device='cpu')
  off = tables['dispOff']
  assert off == 5 * cuda_trace.SURF_COLS + 3 * cuda_trace.ELEM_COLS
  mid, half, coeffs = refPolys[0]
  row = tables['table'].numpy()[off:off + cuda_trace.DISP_COLS]
  want = np.float32([mid, 1.0 / half, len(coeffs), 0.] + list(coeffs))
  np.testing.assert_array_equal(row[:4 + len(coeffs)], want)
  # n(486 nm) from the packed polynomial, as the kernel evaluates it
  n486 = float(cuda_trace._hornerPlain(row, torch.tensor([486.]))[0])
  assert abs(n486 - (1.5046 + 4200. / 486. ** 2)) < 2e-5


def test_fused_step_agrees_by_distribution():
  '''The XLA fused step (linear interpolation of the table) and the port
  (the polynomial) on the same numpy-made ray columns.'''
  jaxScene, bounds, maxI = H.buildDispersiveLensMirrorScene(H.jaxNs())
  deviceNp, histNp, spec = H.referenceArrays(jaxScene, bounds)
  tables = convert.sceneFromReference(deviceNp, histNp, samplerSpec=spec,
                                      device='cpu')
  rng = np.random.default_rng(486)
  u = torch.as_tensor(rng.random((2, H.N_RAYS), dtype=np.float32))
  cols = cuda_trace.sampleRaysPlain(tables, u[0], u[1])
  colsT = torch.stack(list(cols) + [torch.full_like(cols[0], 486.)])
  colsNp = {k: colsT[i].numpy().copy() for i, k in enumerate(H.COLS)}
  ref = H.runReferenceColumns(jaxScene, colsNp, bounds, maxI,
                              withPallas=False)['fused']
  hist = torchFused.initHistograms(histNp, device='cpu')
  c = cuda_trace.traceHistogram(tables, hist, H.N_RAYS, maxI,
                                H.MAX_RAY_LENGTH, H.DIST_TOL, hitSlots=1,
                                columns=colsT.contiguous())
  for i, k in enumerate(('segments', 'hits')):
    assert abs(int(c[i]) - ref['counters'][k]) <= 1e-3 * ref['counters'][k]
  assert H.marginalsClose(hist['counts'].numpy()[0], ref['counts'][0],
                          tolL1=0.01)


def test_unfitted_dispersion_is_refused_by_name():
  for ns in (H.jaxNs(), H.torchNs()):
    scene, _, _ = H.buildDispersiveLensMirrorScene(ns)
    scene.getObject('Lens').RefractiveIndex = WIGGLY_GLASS
    if ns.Scene.__module__.startswith('optics_design_workbench_tpu_torch'):
      dev, _info = scene.compile(device=None)
      reason = cuda_trace.ineligibleReason(dev)
      assert not cuda_trace.dispersionFitsInKernel(dev)
    else:
      dev, _info = scene.compile(devicePut=False)
      reason = pallas_trace.pallasIneligibleReason(dev)
    assert 'polynomial' in reason
