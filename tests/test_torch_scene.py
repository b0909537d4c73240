'''The PyTorch port's host-side scene compilation against the JAX package:
surface / element / histogram tables and the point-source sampler spec of
both bench scenes are the same arrays (allclose, rtol 1e-6 — both sides run
the same float64 host arithmetic and round to float32 once), and the tables
the port builds from the JAX package's arrays (convert.sceneFromReference)
equal the tables it builds from its own scene model.
'''

import numpy as np
import pytest
import torch

import jax  # noqa: F401

import torch_port_helpers as H
from optics_design_workbench_tpu.tracing import fused as jaxFused
from optics_design_workbench_tpu_torch import convert
from optics_design_workbench_tpu_torch.ops import cuda_trace
from optics_design_workbench_tpu_torch.tracing import fused as torchFused

torch.set_num_threads(1)

BENCH = ('lensMirror', 'sourceDetector')


@pytest.fixture(scope='module', params=BENCH)
def pair(request):
  jScene, bounds, maxI = H.buildBench(H.jaxNs(), request.param)
  tScene, _, _ = H.buildBench(H.torchNs(), request.param)
  jDev, jInfo = jScene.compile(devicePut=False)
  tDev, tInfo = tScene.compile(device=None)
  return dict(name=request.param, jScene=jScene, tScene=tScene, jDev=jDev,
              tDev=tDev, jInfo=jInfo, tInfo=tInfo, bounds=bounds, maxI=maxI)


def test_surface_tables_equal(pair):
  for k in ('packed', 'trim', 'kind', 'params', 'w2lRot', 'w2lOff',
            'l2wRot', 'l2wOff', 'elem', 'orient'):
    a, b = np.asarray(pair['jDev']['surfaces'][k]), pair['tDev']['surfaces'][k]
    assert a.shape == b.shape and a.dtype == b.dtype, k
    np.testing.assert_allclose(b, a, rtol=1e-6, err_msg=k)


def test_element_tables_equal(pair):
  for k in ('packed', 'optType', 'recordHits', 'refrIndex', 'reflectivity',
            'absorptionLength'):
    a, b = np.asarray(pair['jDev']['elements'][k]), pair['tDev']['elements'][k]
    assert a.shape == b.shape and a.dtype == b.dtype, k
    np.testing.assert_allclose(b.astype(float), a.astype(float), rtol=1e-6,
                               err_msg=k)
  assert pair['jInfo']['elementLabels'] == pair['tInfo']['elementLabels']


def test_histogram_spec_equal(pair):
  jSpec = jaxFused.makeHistogramSpec(pair['jDev'], pair['jInfo'],
                                     bounds=pair['bounds'], bins=H.BINS)
  tSpec = torchFused.makeHistogramSpec(pair['tDev'], pair['tInfo'],
                                       bounds=pair['bounds'], bins=H.BINS)
  np.testing.assert_array_equal(np.asarray(jSpec['elemToDet']),
                                tSpec['elemToDet'])
  np.testing.assert_array_equal(np.asarray(jSpec['bounds']), tSpec['bounds'])
  assert tuple(jSpec['bins']) == tSpec['bins']
  assert jSpec['detLabels'] == tSpec['detLabels']
  hist = torchFused.initHistograms(tSpec, device='cpu')
  assert hist['power'].shape == (1,) + H.BINS
  assert hist['counts'].dtype == torch.float32


def test_sampler_spec_equal(pair):
  '''Segments, coefficients, R, off, f of the in-kernel sampler spec.'''
  jSpec = pair['jScene'].lightSources()[0].pallasSamplerSpec()
  tSpec = pair['tScene'].lightSources()[0].samplerSpec()
  assert jSpec is not None and tSpec is not None
  assert set(jSpec) == set(tSpec)
  for k in ('finite', 'f', 'wavelength'):
    assert jSpec[k] == tSpec[k], k
  np.testing.assert_allclose(tSpec['R'], jSpec['R'], rtol=1e-12)
  np.testing.assert_allclose(tSpec['off'], jSpec['off'], rtol=1e-12)
  for k in ('first', 'phi'):
    a, b = jSpec[k], tSpec[k]
    assert a[0] == b[0], k
    if a[0] == 'affine':
      np.testing.assert_allclose(b[1:], a[1:], rtol=1e-6)
      continue
    assert len(a[1]) == len(b[1])
    for segA, segB in zip(a[1], b[1]):
      np.testing.assert_allclose(segB[:4], segA[:4], rtol=1e-9)
      # polyfit coefficients: same data, same LAPACK call
      np.testing.assert_allclose(segB[4], segA[4], rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(b[2:], a[2:], rtol=1e-6)


def test_kernel_tables_same_from_either_package(pair):
  '''convert.sceneFromReference(JAX arrays) == buildTraceTables(own scene).'''
  _dev, histNp, jSpec = H.referenceArrays(pair['jScene'], pair['bounds'])
  fromJax = convert.sceneFromReference(pair['jDev'], histNp,
                                       samplerSpec=jSpec, device='cpu')
  tSpecH = torchFused.makeHistogramSpec(pair['tDev'], pair['tInfo'],
                                        bounds=pair['bounds'], bins=H.BINS)
  own = cuda_trace.buildTraceTables(
      pair['tDev'], tSpecH,
      samplerSpec=pair['tScene'].lightSources()[0].samplerSpec(),
      device='cpu')
  assert fromJax['table'].shape == own['table'].shape
  np.testing.assert_allclose(own['table'].numpy(), fromJax['table'].numpy(),
                             rtol=1e-6, atol=1e-9)
  for k in ('nSurf', 'nElem', 'samplerOff', 'bins', 'nDet', 'anyMedium'):
    assert fromJax[k] == own[k], k
  assert cuda_trace.autoHitSlots(pair['tDev'], tSpecH, pair['maxI']) == 1


def test_eligibility_names_what_is_not_ported():
  ns = H.torchNs()
  scene, _, _ = H.buildBench(ns, 'lensMirror')
  dev, _info = scene.compile(device=None)
  assert cuda_trace.eligible(dev)
  assert cuda_trace.numSurfacesStatic(dev) == 5
  # scatter tables the kernel cannot read (the reference's gather path)
  bad = dict(dev, scatter={})
  assert 'scatter' in cuda_trace.ineligibleReason(bad)
  # the other kinds run (B2), in the kernels' GEOM instance
  cone = dict(dev, surfaces=dict(dev['surfaces'],
                                 kind=np.array([0, 0, 0, 1, 5], np.int32)))
  assert cuda_trace.eligible(cone) and cuda_trace.needsGeom(cone)
  assert not cuda_trace.needsGeom(dev)
  # trims whose data the scene lacks (B3's bitmaps and primitives)
  bitmap = dict(dev, surfaces=dict(dev['surfaces'],
                                   trim=dev['surfaces']['trim'] + 2.))
  assert 'trims' in cuda_trace.ineligibleReason(bitmap)
  prims = dict(dev, surfaces=dict(dev['surfaces'],
                                  trim=dev['surfaces']['trim'] + 3.))
  assert 'trimPrims' in cuda_trace.ineligibleReason(prims)
  with pytest.raises(ValueError, match='not eligible'):
    cuda_trace.buildTraceTables(bitmap, dict(elemToDet=np.array([-1, -1, 0]),
                                             bounds=np.zeros((1, 4)),
                                             bins=(8, 8)), device='cpu')


def test_scene_compile_refuses_unported_features():
  '''Stochastic scatter, per-source ignore lists and sequential mode now
  compile: into `scatter` (tables the kernels take), `surfaceMasks` and
  `seqMask`.'''
  ns = H.torchNs()
  scene2, _, _ = H.buildBench(ns, 'lensMirror')
  scene2.opticalObjects()[1].ReflectedProbabilityDensity = 'exp(-theta^2)'
  dev2, _info = scene2.compile(device=None)
  assert dev2['scatter']['flags'].tolist()[1] == [True, False, False, False]
  assert cuda_trace.eligible(dev2)
  scene, _, _ = H.buildBench(ns, 'lensMirror')
  scene.lightSources()[0].IgnoredOpticalElements = ['Lens']
  dev, info = scene.compile(device=None)
  lens = dev['surfaces']['elem'] == 0
  assert info['surfaceMasks']['Source'].tolist() == (~lens).tolist()
  assert cuda_trace.eligible(dict(dev, surfMask=info['surfaceMasks']['Source']))
  scene3, _, _ = H.buildBench(ns, 'lensMirror')
  scene3.addSimulationSettings(SequentialMode=True,
                               SequentialModeElements=[['Lens']])
  dev3, _info = scene3.compile(device=None)
  assert dev3['seqMask'].tolist() == [lens.tolist()]
  assert cuda_trace.eligible(dev3)
