'''The grating spectrometer (examples/4) on the PyTorch port, the slice as a
whole, on the CPU (the kernels' plain versions):

  * `runSimulation` on `examples/torch_4_spectrometer.buildScene` with one
    source each at 450, 550 and 650 nm, 20,000 rays per source: each line's
    mean radial position from the stored hits lies within 0.15 mm of the
    grating equation (the JAX suite's own bound, tests/test_spectrometer.py)
    and within 0.02 mm of the JAX package's run of the same scene (both
    trace the reference's grating), and the positions increase with
    wavelength;
  * the fused step through `benchmarks.makeBenchStep` on
    `benchmarks.buildSpectrometerScene` (the reference's throughput scene):
    every ray meets the grating and the detector, the line's centroid within
    one bin of the grating equation;
  * the sweep chain on a wavelength sweep: the sweep kernel's plain version
    equal, counters, counts and power, to the single-scene plain version
    per variant on the same uniforms;
  * `evaluateBatched` over wavelengths rides one sweep (geometry mode: the
    source's wavelength is the swept parameter), and the line's centroid
    follows the grating equation within one bin width.
'''

import importlib.util
import os

import numpy as np
import torch

import jax  # noqa: F401  (both frameworks live in this process)

from optics_design_workbench_tpu import simulation as refSim
from optics_design_workbench_tpu.jupyter_utils import RawFolder as RefRawFolder
from optics_design_workbench_tpu_torch import benchmarks, simulation
from optics_design_workbench_tpu_torch.jupyter_utils import (ParameterSweeper,
                                                             RawFolder)
from optics_design_workbench_tpu_torch.ops import cuda_trace
from optics_design_workbench_tpu_torch.tracing import fused

torch.set_num_threads(1)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _example(name):
  spec = importlib.util.spec_from_file_location(
      name, os.path.join(_ROOT, 'examples', f'{name}.py'))
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  return module


example4 = _example('torch_4_spectrometer')
refExample4 = _example('4_spectrometer')

WAVELENGTHS = (450, 550, 650)
BOUNDS = (-80., 80., -80., 80.)
BINS = (128, 128)
BIN_MM = 160. / 128


def _linePositions(raw):
  out = {}
  for wl in WAVELENGTHS:
    hits = raw.loadHits('Detector', source=f'Source{wl}')
    assert len(hits) > 10000
    pts = hits.points()
    out[wl] = float(np.hypot(pts[:, 0], pts[:, 1]).mean())
  return out


def test_spectral_lines_match_grating_equation(tmp_path):
  scene = example4.buildScene(path=str(tmp_path / 'spectro'),
                              wavelengths=WAVELENGTHS)
  runPath = simulation.runSimulation(scene, 'singletrue', seed=4,
                                     device='cpu')
  positions = _linePositions(RawFolder(runPath))
  refScene = refExample4.buildScene(path=str(tmp_path / 'reference'),
                                    wavelengths=WAVELENGTHS)
  refPositions = _linePositions(RefRawFolder(
      refSim.runSimulation(refScene, 'singletrue', seed=4)))
  for wl in WAVELENGTHS:
    expected = example4.expectedPosition(wl)
    assert expected == refExample4.expectedPosition(wl)
    assert abs(positions[wl] - expected) < 0.15, (wl, positions[wl])
    assert abs(positions[wl] - refPositions[wl]) < 0.02, \
        (wl, positions[wl], refPositions[wl])
  assert positions[450] < positions[550] < positions[650]


def _centroidMm(counts):
  '''Radial distance (mm) of a detector's count centroid from the axis.'''
  H = counts[0]
  n = H.sum()
  ys, xs = np.indices(H.shape)
  x = BOUNDS[0] + ((H * xs).sum() / n + 0.5) * BIN_MM
  y = BOUNDS[2] + ((H * ys).sum() / n + 0.5) * BIN_MM
  return float(np.hypot(x, y))


def test_bench_step_on_the_spectrometer():
  n = 4096
  step, hist, meta = benchmarks.makeBenchStep(
      scene=benchmarks.buildSpectrometerScene(), raysPerStep=n,
      maxIntersections=3, bins=BINS, histBounds=BOUNDS, device='cpu')
  assert step.tables['hasGrating']
  hist, counters = step(2, hist)
  assert int(counters['segments']) == 2 * n     # grating, then detector
  assert int(counters['hits']) == n
  assert abs(_centroidMm(hist['counts'].numpy())
             - example4.expectedPosition(532.)) < BIN_MM


def test_wavelength_sweep_equals_single_steps():
  scenes = [benchmarks.buildSpectrometerScene(wavelength=w)
            for w in WAVELENGTHS]
  host = [sc.compile(device=None) for sc in scenes]
  histSpec = fused.makeHistogramSpec(*host[0], bounds=BOUNDS, bins=(32, 32))
  specs = [sc.lightSources()[0].samplerSpec() for sc in scenes]
  sweep = cuda_trace.buildSweepTables([h for h, _i in host], histSpec, specs,
                                      device='cpu')
  assert not sweep['sameSource'] and sweep['hasGrating']
  n, V = 2048, len(scenes)
  rng = np.random.default_rng(532)
  us = torch.as_tensor(rng.random((2, n), dtype=np.float32))
  kw = dict(maxIntersections=3, maxRayLength=1000., distTol=1e-4,
            hitSlots=1, uniforms=us, strataTile=256)
  shape = (V, 1, 32, 32)
  hist = dict(power=torch.zeros(shape), counts=torch.zeros(shape))
  counters = cuda_trace.traceSweep(sweep, hist, n, **kw)
  for v in range(V):
    tables = cuda_trace.buildTraceTables(host[v][0], histSpec, specs[v],
                                         device='cpu')
    single = fused.initHistograms(histSpec, device='cpu')
    c = cuda_trace.traceHistogram(tables, single, n, **kw)
    assert c.tolist() == counters[v].tolist()
    assert torch.equal(single['counts'], hist['counts'][v])
    assert torch.equal(single['power'], hist['power'][v])
  assert not torch.equal(hist['counts'][0], hist['counts'][2])


def test_wavelength_calibration_through_evaluate_batched():
  scene = benchmarks.buildSpectrometerScene()
  sweeper = ParameterSweeper(
      lambda sc: dict(wl=(sc.lightSources()[0], 'Wavelength')),
      scene=scene, device='cpu')
  wavelengths = np.linspace(400., 700., 7)
  centroids = sweeper.evaluateBatched(
      [dict(wl=float(w)) for w in wavelengths],
      lambda power, counts: _centroidMm(counts), raysPerScene=2048,
      maxIntersections=3, bins=BINS, histBounds=BOUNDS)
  assert sweeper.lastBatchedRoute == 'sweep'
  expected = np.array([example4.expectedPosition(w) for w in wavelengths])
  assert np.abs(centroids - expected).max() < BIN_MM
  assert np.all(np.diff(centroids) > 0)
