'''The histogram kernel bins each step into a zeroed delta and adds it to the
run's histograms, as the reference adds its kernel's per-step output
(`makePallasTraceStep`), so a bin goes on counting past 2**24, where float32
`+1` rounds back to the bin (ROADMAP C.1). On the CPU (the kernel's plain
version), on the spectrometer's throughput scene, 16,384 rays, 3
intersections, 128 x 128 bins, every bin pre-filled at 2**24:

  * the port's step adds what the JAX package's Pallas kernel (interpret
    mode, fed the same uniforms) adds onto the same pre-filled histograms,
    bin for bin within the 2-ray bin-edge budget;
  * `makeBenchStep`'s default step adds the step's own fresh delta, rounded
    once per bin, and `histPrecision='highest'` adds the same counts.
'''

import numpy as np
import torch

import jax  # noqa: F401  (both frameworks live in this process)

import torch_port_helpers as H
from optics_design_workbench_tpu_torch import benchmarks, convert
from optics_design_workbench_tpu_torch.ops import cuda_trace
from optics_design_workbench_tpu_torch.tracing import fused

torch.set_num_threads(1)

N = 1 << 14
BINS = (128, 128)
BOUNDS = (-80., 80., -80., 80.)
FULL = float(2 ** 24)


def _spectrometer(ns):
  '''The spectrometer's throughput scene (tools/scene_throughput.
  sceneSpectrometer; the port's `benchmarks.buildSpectrometerScene`) in
  either package.'''
  S, T = ns.S, ns.T
  scene = ns.Scene(label='spectro_tp')
  scene.addOpticalGroup(ns.OpticalGroup(
      OpticalType='Grating', Label='Grating', GratingType='Reflection',
      GratingLinesPerMillimeter=500., GratingDiffractionOrder=1,
      GratingLinesOrientation=(1., 0., 0.),
      surfaces=[S.plane(np.eye(4), elem=0, radius=40., orient=-1)],
      placements=[T.translation(0, 0, 100.)]))
  scene.addOpticalGroup(ns.OpticalGroup(
      OpticalType='Absorber', Label='Detector',
      surfaces=[S.plane(np.eye(4), elem=0, halfExtents=(80., 80.))],
      placements=[T.translation(0, 0, 0)]))
  scene.addSource(ns.PointSource(
      Label='Src', PowerDensity='exp(-theta^2/1e-4)', Wavelength=532.,
      ThetaDomain='0, 0.05', ThetaResolutionNumericMode='2e3'))
  scene.addSimulationSettings(RaysPerIteration=1e6, MaxIntersections=3)
  return scene, BOUNDS, 3


def _prefilled(histSpec):
  hist = fused.initHistograms(histSpec, device='cpu')
  for v in hist.values():
    v.fill_(FULL)
  return hist


def test_step_adds_the_reference_delta_onto_full_bins():
  scene, bounds, maxI = _spectrometer(H.jaxNs())
  deviceNp, histNp, spec = H.referenceArrays(scene, bounds, bins=BINS)
  ref, us = H.runReferenceUniforms(scene, bounds, maxI, n=N, bins=BINS,
                                   prefill=FULL)
  tables = convert.sceneFromReference(deviceNp, histNp, samplerSpec=spec,
                                      device='cpu')
  hist = _prefilled(histNp)
  c = cuda_trace.traceHistogram(tables, hist, N, maxI, H.MAX_RAY_LENGTH,
                                H.DIST_TOL, uniforms=torch.as_tensor(us),
                                strataTile=H.TILE)
  assert int(c[1]) == ref['counters']['hits'] > 0.99 * N
  added = hist['counts'].numpy().astype(np.float64) - FULL
  refAdded = ref['counts'].astype(np.float64) - FULL
  # without the delta the port added nothing: float32 2**24 + 1 == 2**24
  assert refAdded.sum() > 0.99 * N
  assert H.nearlyEqualCounts(added, refAdded)
  same = added == refAdded
  np.testing.assert_allclose(hist['power'].numpy()[same],
                             ref['power'][same], rtol=1e-2)


def test_bench_step_bins_into_a_fresh_delta():
  step, hist, meta = benchmarks.makeBenchStep(
      scene=benchmarks.buildSpectrometerScene(), raysPerStep=N,
      maxIntersections=3, bins=BINS, histBounds=BOUNDS, device='cpu')
  _, c = step(7, hist)                          # the step's own delta
  delta = {k: v.clone() for k, v in hist.items()}
  full = _prefilled(meta['histSpec'])
  _, cFull = step(7, full)
  assert int(cFull['hits']) == int(c['hits']) > 0.99 * N
  for k in ('counts', 'power'):
    want = (torch.full_like(delta[k], FULL) + delta[k]) - FULL
    got = full[k] - FULL
    assert torch.equal(got, want), k
  assert float((full['counts'] - FULL).sum()) > 0.99 * N
  # the float64 binning outside the kernel adds the same counts
  highest, _h, _m = benchmarks.makeBenchStep(
      scene=benchmarks.buildSpectrometerScene(), raysPerStep=N,
      maxIntersections=3, bins=BINS, histBounds=BOUNDS,
      histPrecision='highest', device='cpu')
  fullH = _prefilled(meta['histSpec'])
  _, cH = highest(7, fullH)
  assert cH['hits'] == cFull['hits']
  assert torch.equal(fullH['counts'], full['counts'])
  torch.testing.assert_close(fullH['power'], full['power'], rtol=1e-6,
                             atol=0.)
