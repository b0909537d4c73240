'''The first slice of the PyTorch port as a whole: its own
`benchmarks.makeBenchStep` (scene model -> compile -> in-kernel sampling ->
bounce loop -> detector histogram) on the CPU, where the step runs the
kernel's plain PyTorch version with its own torch.Generator draws, against
the JAX package's fused step with jax.random draws. The two use independent
random numbers, so histograms are compared by their marginals (L1 budget as
in tests/test_pallas_interpret.py) and counters by what the physics fixes.
'''

import numpy as np
import pytest
import torch

import jax

import torch_port_helpers as H
from optics_design_workbench_tpu import benchmarks as jaxBench
from optics_design_workbench_tpu.tracing import fused as jaxFused
from optics_design_workbench_tpu_torch import benchmarks as torchBench

torch.set_num_threads(1)

N = 4096
STEPS = 3


@pytest.fixture(scope='module')
def portRun():
  step, hist, meta = torchBench.makeBenchStep(device='cpu', raysPerStep=N,
                                              bins=H.BINS)
  perStep = []
  for s in range(STEPS):
    hist, counters = step(100 + s, hist)
    perStep.append({k: int(v) for k, v in counters.items()})
  return dict(step=step, hist=hist, meta=meta, perStep=perStep)


@pytest.fixture(scope='module')
def jaxCounts():
  scene = jaxBench.buildLensMirrorScene()
  device, info = scene.compile()
  histSpec = jaxFused.makeHistogramSpec(device, info,
                                        bounds=(-60., 60., -60., 60.),
                                        bins=H.BINS)
  step = jaxFused.makeFusedStep(
      device, scene.lightSources()[0].deviceGenerator(), histSpec,
      raysPerStep=N, maxIntersections=6, maxRayLength=1000., distTol=1e-4)
  hist = jaxFused.initHistograms(histSpec)
  for s in range(STEPS):
    hist, _c = step(jax.random.PRNGKey(500 + s), hist)
  return np.asarray(hist['counts'])[0]


def test_marginals_match_jax_fused_step(portRun, jaxCounts):
  assert H.marginalsClose(portRun['hist']['counts'][0].numpy(), jaxCounts)


def test_counters_consistent(portRun):
  for c in portRun['perStep']:
    assert 0.9 * N < c['hits'] <= N
    assert abs(c['segments'] / N - 4.) < 0.1
    assert c['hitOverflow'] == 0
  assert portRun['meta']['backend'] == 'plain'
  assert portRun['step'].hitSlots == 1
  assert portRun['step'].strataTile == 256


def test_histogram_accumulates_in_place(portRun):
  hist = portRun['hist']
  total = sum(c['hits'] for c in portRun['perStep'])
  assert int(hist['counts'].sum()) == total
  # every detected ray passed the 0.98 fold mirror exactly once
  np.testing.assert_allclose(float(hist['power'].sum()), 0.98 * total,
                             rtol=1e-5)
  before = hist['counts']
  out, c = portRun['step'](7, hist)
  assert out['counts'] is before                 # same tensors, added into
  assert int(before.sum()) == total + int(c['hits'])


def test_seed_reproduces_and_generator_is_accepted():
  step, hist, _ = torchBench.makeBenchStep(device='cpu', raysPerStep=1024,
                                           bins=(8, 128))
  a, _ = step(5, {k: torch.zeros_like(v) for k, v in hist.items()})
  b, _ = step(5, {k: torch.zeros_like(v) for k, v in hist.items()})
  assert torch.equal(a['counts'], b['counts'])
  gen = torch.Generator(device='cpu')
  gen.manual_seed(1)
  c, counters = step(gen, {k: torch.zeros_like(v) for k, v in hist.items()})
  assert int(counters['hits']) == int(c['counts'].sum()) > 900


def test_stratified_step_uses_ray_columns():
  '''stratified=True: latin-hypercube quantiles from the generator, handed
  to the trace as ray columns (mode (c)); the hit share stays the same.'''
  step, hist, _ = torchBench.makeBenchStep(device='cpu', raysPerStep=2048,
                                           bins=(8, 128), stratified=True)
  assert step.tables['samplerOff'] < 0
  hist, counters = step(3, hist)
  assert 0.9 * 2048 < int(counters['hits']) <= 2048


def test_collimated_scene_runs_end_to_end():
  '''The f = inf branch through the whole step: every ray of the collimated
  beam is folded by the mirror (power 0.95) into the detector.'''
  from optics_design_workbench_tpu_torch.ops import cuda_trace
  from optics_design_workbench_tpu_torch.tracing import fused
  scene, bounds, maxI = H.buildCollimatedScene(H.torchNs())
  sceneNp, info = scene.compile(device=None)
  histSpec = fused.makeHistogramSpec(sceneNp, info, bounds=bounds,
                                     bins=H.BINS)
  src = scene.lightSources()[0]
  spec = src.samplerSpec()
  assert spec is not None and not spec['finite']
  step = cuda_trace.makeTraceStep(
      sceneNp, histSpec, None, raysPerStep=2048, maxIntersections=maxI,
      maxRayLength=1000., distTol=1e-4, sampler=spec, device='cpu')
  hist, c = step(9, fused.initHistograms(histSpec, device='cpu'))
  assert int(c['hits']) == 2048 and int(c['segments']) == 2 * 2048
  np.testing.assert_allclose(float(hist['power'].sum()), 0.95 * 2048,
                             rtol=1e-5)


def test_cuda_without_a_card_raises():
  if torch.cuda.is_available():
    pytest.skip('a CUDA device is present')
  with pytest.raises(RuntimeError, match='no CUDA device'):
    torchBench.makeBenchStep(raysPerStep=1024)
