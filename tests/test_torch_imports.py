'''The PyTorch port stands alone: importing and running it pulls in neither
jax nor the JAX package, and the kernel's wrapper refuses what the kernel
does not take.'''

import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_port_helpers as H
from optics_design_workbench_tpu_torch import resolveDevice
from optics_design_workbench_tpu_torch.ops import cuda_trace
from optics_design_workbench_tpu_torch.tracing import fused

torch.set_num_threads(1)

_PROBE = '''
import sys
import torch
torch.set_num_threads(1)
import optics_design_workbench_tpu_torch as port
from optics_design_workbench_tpu_torch import (benchmarks, convert, _build,
                                               distributions, geometry,
                                               jupyter_utils, models, ops,
                                               simulation, tracing, utils)
from optics_design_workbench_tpu_torch.jupyter_utils import (
    document, histogram, hits, parameter_sweeper, progress, retries,
    transforms)
from optics_design_workbench_tpu_torch.geometry import brep, mesh
from optics_design_workbench_tpu_torch.models import (fcstd_ingest,
                                                      replay_source,
                                                      surface_source)
import optics_design_workbench_tpu_torch.__main__ as cli
from optics_design_workbench_tpu_torch.simulation import (lifecycle,
                                                          results_store,
                                                          runner)
from optics_design_workbench_tpu_torch.utils import io, native_store, timing
from optics_design_workbench_tpu_torch.tracing import diff, fused
step, hist, meta = benchmarks.makeBenchStep(device='cpu', raysPerStep=4096)
hist, counters = step(0, hist)
assert int(counters['hits']) > 3600, counters
step, hist, meta = benchmarks.makeBenchStep(
    scene=benchmarks.buildSurfaceSourceScene(), device='cpu',
    raysPerStep=4096, maxIntersections=4, histBounds=(-120., 120., -120., 120.))
hist, counters = step(0, hist)
assert step.tables['samplerKind'] == 1 and int(counters['hits']) > 2500
step, hist, meta = benchmarks.makeBenchStep(
    scene=benchmarks.buildMeshDishScene(), device='cpu', raysPerStep=1024,
    maxIntersections=3, histBounds=(-200., 200., -200., 200.))
hist, counters = step(0, hist)
assert step.tables['nTri'] == 200 and int(counters['hits']) > 1000
# the fused step's twin, and a differentiable spot loss over its bounce
step, hist, meta = benchmarks.makeBenchStep(device='cpu', raysPerStep=1024,
                                            useKernel=False)
hist, counters = step(0, hist)
assert meta['backend'] == 'tracer' and int(counters['hits']) > 900
host = meta['device']
gen = torch.Generator()
gen.manual_seed(0)
cols = meta['scene'].lightSources()[0].deviceColumnsGenerator('cpu')(gen, 256)
batch = dict(origins=torch.stack([cols['ox'], cols['oy'], cols['oz']], -1),
             directions=torch.stack([cols['dx'], cols['dy'], cols['dz']], -1),
             powers=cols['pw'], wavelengths=cols['wl'])
value, grad = diff.makeSpotLoss(host, [('translateGroup', 0, (0., 0., 1.))],
                                batch, detectorElem=2, maxIntersections=6)(
                                    torch.zeros(1))
assert torch.isfinite(value) and torch.isfinite(grad).all(), (value, grad)
import tempfile
with tempfile.TemporaryDirectory() as tmp:
  scene = benchmarks.buildSourceDetectorScene(tmpdir=tmp)
  settings = scene.activeSimulationSettings()
  settings.RaysPerIteration, settings.EndAfterIterations = 1024, 2
  progress = []
  for recording in ('raw', 'histogram'):
    simulation.runSimulation(scene, 'true', seed=1, device='cpu',
                             recording=recording,
                             progressCallback=progress.append)
    assert progress[-1]['totalRecordedHits'] > 1800, progress[-1]
  raw = jupyter_utils.latestRawFolder(scene.resultsFolderPath())
  assert len(raw.loadHits('Detector')) > 0
  sweeper = jupyter_utils.ParameterSweeper(
      lambda sc: dict(wl=(sc.getObject('Source'), 'Wavelength')),
      scene=scene, device='cpu')
  metrics = sweeper.evaluateBatched(
      [dict(wl=500.), dict(wl=600.)], lambda power, counts: counts.sum(),
      raysPerScene=512, maxIntersections=2)
  assert sweeper.lastBatchedRoute == 'sweep' and metrics.min() > 400, metrics
bad = sorted(m for m in sys.modules
             if m == 'jax' or m.startswith('jax.') or m == 'jaxlib'
             or m == 'optics_design_workbench_tpu'
             or m.startswith('optics_design_workbench_tpu.'))
print('LEAKED', bad)
print('DIGEST', port.kernelSourceDigest(), port.versionInfo()['torch'])
'''


def test_port_imports_neither_jax_nor_the_jax_package():
  out = subprocess.run([sys.executable, '-c', _PROBE], capture_output=True,
                       text=True, timeout=120)
  assert out.returncode == 0, out.stderr[-2000:]
  assert 'LEAKED []' in out.stdout, out.stdout
  assert 'DIGEST' in out.stdout


@pytest.fixture(scope='module')
def setup():
  scene, bounds, maxI = H.buildBench(H.torchNs(), 'sourceDetector')
  sceneNp, info = scene.compile(device=None)
  histSpec = fused.makeHistogramSpec(sceneNp, info, bounds=bounds,
                                     bins=(8, 128))
  tables = cuda_trace.buildTraceTables(
      sceneNp, histSpec, samplerSpec=scene.lightSources()[0].samplerSpec(),
      device='cpu')
  return tables, histSpec


def _call(tables, histSpec, n=256, hist=None, **inputs):
  hist = hist or fused.initHistograms(histSpec, device='cpu')
  return cuda_trace.traceHistogram(tables, hist, n, 2, 1000., 1e-4,
                                   **inputs)


def test_wrapper_refuses_float64_and_non_contiguous_inputs(setup):
  tables, histSpec = setup
  good = torch.rand((2, 256), dtype=torch.float32)
  assert _call(tables, histSpec, uniforms=good).shape == (3,)
  with pytest.raises(TypeError, match='float32'):
    _call(tables, histSpec, uniforms=good.double())
  with pytest.raises(ValueError, match='contiguous'):
    _call(tables, histSpec, uniforms=torch.rand((256, 2)).t())
  with pytest.raises(ValueError, match='shape'):
    _call(tables, histSpec, uniforms=torch.rand((2, 255)))
  with pytest.raises(ValueError, match='shape'):
    _call(tables, histSpec, columns=torch.rand((7, 256)))
  with pytest.raises(TypeError, match='float32'):
    hist = fused.initHistograms(histSpec, dtype=torch.float64, device='cpu')
    _call(tables, histSpec, hist=hist, uniforms=good)
  with pytest.raises(ValueError, match='exactly one'):
    _call(tables, histSpec, uniforms=good, seed=1)
  with pytest.raises(ValueError, match='hitSlots'):
    _call(tables, histSpec, uniforms=good, hitSlots=7)


def test_kernel_launch_path_refuses_cpu_tensors(setup):
  '''The CUDA launch itself never takes a CPU tensor: the wrapper routes
  CPU tables to the plain version, the launch refuses them outright, and
  tensors on another device than the tables are refused before anything
  runs.'''
  tables, histSpec = setup
  before = dict(cuda_trace.launchCounts)
  _call(tables, histSpec, seed=3)
  assert cuda_trace.launchCounts == before    # plain version: no launch
  hist = fused.initHistograms(histSpec, device='cpu')
  ring = torch.empty((9, 1, 256))
  for name, outs in (('traceHistogram', (hist['power'], hist['counts'])),
                     ('traceBins', (ring[:3],)), ('traceRaw', (ring,)),
                     ('traceSweep', (hist['power'], hist['counts']))):
    with pytest.raises(ValueError, match='CUDA tensors only'):
      cuda_trace._launchKernel(name, tables, outs, 256, cuda_trace.MODE_SEED,
                               None, 3, None, 0, 2, 1000., 1e-4, 1e-6, 1)
  assert cuda_trace.launchCounts == before
  with pytest.raises(ValueError, match='lies on'):
    _call(tables, histSpec, uniforms=torch.rand((2, 256), device='meta'))
  assert resolveDevice('cpu') == torch.device('cpu')


def test_table_capacities_are_enforced(setup):
  tables, histSpec = setup
  spec = dict(tables['samplerSpec'])
  segs = tuple((i / 20., (i + 1) / 20., (i + .5) / 20., .025, (0., 1.))
               for i in range(cuda_trace.MAX_PWPOLY_SEGMENTS + 1))
  spec['first'] = ('pwpoly', segs, 0., 1.)
  dummy = dict(
      surfaces=dict(packed=np.zeros((1, 24), np.float32),
                    trim=np.zeros((1, 6), np.float32),
                    kind=np.zeros(1, np.int32)),
      elements=dict(packed=np.zeros((1, 11), np.float32),
                    optType=np.array([3], np.int32),
                    recordHits=np.array([True])))
  with pytest.raises(ValueError, match='segments'):
    cuda_trace.buildTraceTables(dummy, histSpec, samplerSpec=spec,
                                device='cpu')
  # more than 256 surfaces that stay surface rows (hole-primitive trims;
  # plain discs would ride the surface table)
  n = cuda_trace.MAX_SURFACES + 1
  trim = np.zeros((n, 6), np.float32)
  trim[:, 0] = 3.
  many = dict(dummy, surfaces=dict(
      packed=np.zeros((n, 24), np.float32), trim=trim,
      kind=np.zeros(n, np.int32), trimPrims=np.zeros((n, 4, 7), np.float32)))
  with pytest.raises(ValueError, match='surfaces'):
    cuda_trace.buildTraceTables(many, histSpec, device='cpu')
