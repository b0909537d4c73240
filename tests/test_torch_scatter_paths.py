'''Scatter scenes through the port's paths on the CPU: the sweep (one
launch's plain version against the single-scene one; variants whose
densities differ leave the sweep), the recording run, the fused step's
statistics against the JAX package's (the constants chip_smoke.py holds
the card to), the input rules of a scatter scene, and the fault of the
reference's sweep that the port does not repeat (ROADMAP C).'''

import numpy as np
import pytest
import torch

import torch_port_helpers as H

torch.set_num_threads(1)

N = 4096
BOUNDS = H.SCATTER_BOUNDS
KW = dict(maxIntersections=4, maxRayLength=1000., distTol=1e-4,
          powerTol=1e-6, hitSlots=1)


def _diffuser(z=50., density=None):
  from optics_design_workbench_tpu_torch import benchmarks
  scene = benchmarks.buildDiffuseScatterScene(diffuserZ=z)
  if density is not None:
    scene.opticalObjects()[0].ReflectedProbabilityDensity = density
  return scene


def _sweepTables(scenes):
  from optics_design_workbench_tpu_torch.ops import cuda_trace
  from optics_design_workbench_tpu_torch.tracing import fused
  host = [sc.compile(device=None) for sc in scenes]
  histSpec = fused.makeHistogramSpec(*host[0], bounds=BOUNDS, bins=(32, 32))
  specs = [sc.lightSources()[0].samplerSpec() for sc in scenes]
  return cuda_trace.buildSweepTables([h for h, _i in host], histSpec, specs,
                                     device='cpu'), histSpec


def test_sweep_plain_equals_single_scene_plain():
  '''A 3-variant sweep of the diffuser's height: `traceSweepPlain` on one
  set of uniforms (the sampler's rows, then every bounce's scatter rows)
  equals three `traceHistogramPlain` calls on those uniforms.'''
  from optics_design_workbench_tpu_torch.ops import cuda_trace
  tables, histSpec = _sweepTables([_diffuser(z) for z in (45., 50., 55.)])
  assert tables['scatter'] and tables['scatterRows'] == 2
  rows = cuda_trace.uniformRows(tables, KW['maxIntersections'])
  assert rows == 2 + 2 * 4
  us = torch.rand((rows, N), generator=torch.Generator().manual_seed(3))
  shape = (3, 1, 32, 32)
  hist = dict(power=torch.zeros(shape), counts=torch.zeros(shape))
  c = cuda_trace.traceSweep(tables, hist, N, uniforms=us, **KW)
  spots = []
  for v in range(3):
    single = cuda_trace.variantTables(tables, v)
    h = dict(power=torch.zeros(shape[1:]), counts=torch.zeros(shape[1:]))
    cv = cuda_trace.traceHistogram(single, h, N, uniforms=us, **KW)
    assert cv.tolist() == c[v].tolist()
    assert torch.equal(h['counts'], hist['counts'][v])
    assert torch.equal(h['power'], hist['power'][v])
    spots.append(float((h['counts'][0] > 0).sum()))
  # the higher the diffuser, the wider its spot on the detector
  assert spots[0] < spots[2]


def test_sweep_refuses_variants_whose_scatter_differs():
  from optics_design_workbench_tpu_torch.ops import cuda_trace
  with pytest.raises(cuda_trace.SweepUnavailable, match='scatter'):
    _sweepTables([_diffuser(50.), _diffuser(50., 'exp(-theta^2/0.2)')])


def test_reference_sweep_bakes_variant_zero_scatter(monkeypatch):
  '''ROADMAP C, "Faults of the reference": the JAX package's sweep step
  builds ONE kernel with variant 0's scatter constants
  (pallas_trace.makePallasSweepStep), so a variant whose density differs
  is traced with variant 0's lobe. Input: the diffuser at z = 50 and 55
  with exp(-theta^2/0.02) and exp(-theta^2/0.2). Reference: the kernel's
  constants are variant 0's for both. Port: the sweep refuses
  (SweepUnavailable) and `evaluateBatched` traces the variants one by one,
  each with its own constants: the wider lobe gives the wider spot.'''
  from optics_design_workbench_tpu.ops import pallas_trace
  from optics_design_workbench_tpu.tracing.batch_tracer import \
      scatterConstants
  ns = H.jaxNs()
  scenes = []
  for z, density in ((50., None), (55., 'exp(-theta^2/0.2)')):
    scene, _b, _m = H.buildScatterScene(ns, 'diffuse', diffuserZ=z)
    if density:
      scene.opticalObjects()[0].ReflectedProbabilityDensity = density
    scenes.append(scene.compile(devicePut=False))
  built = []
  original = pallas_trace._makeKernel

  def spy(*args, **kwargs):
    built.append(kwargs.get('scatterConsts'))
    return original(*args, **kwargs)

  monkeypatch.setattr(pallas_trace, '_makeKernel', spy)
  spec = H.buildScatterScene(ns, 'diffuse')[0].lightSources()[0] \
      .pallasSamplerSpec()
  pallas_trace.makePallasSweepStep(scenes, BOUNDS, (8, 128), spec, 1024, 4,
                                   1000., 1e-4, interpret=True, tile=1024)
  c0, c1 = (scatterConstants(s) for s, _i in scenes)
  assert c0 != c1 and built == [c0]
  # the port: one scene at a time, each with its own lobe
  from optics_design_workbench_tpu_torch.jupyter_utils import (
      Parameter, ParameterSweeper)
  holder = dict(k=0, scene=_diffuser(50.))

  def setK(k):
    holder['k'] = int(k)
    holder['scene'] = (_diffuser(50.) if k == 0 else
                       _diffuser(55., 'exp(-theta^2/0.2)'))

  sweeper = ParameterSweeper(
      lambda sc: dict(k=Parameter(getter=lambda: holder['k'], setter=setK,
                                  bounds=(0, 1))),
      scene=holder['scene'], device='cpu')
  spot = sweeper.evaluateBatched(
      [dict(k=0), dict(k=1)], lambda p, c: float((c[0] > 0).sum()),
      sceneFactory=lambda: holder['scene'], raysPerScene=N,
      maxIntersections=4, bins=(32, 32), histBounds=BOUNDS)
  assert sweeper.lastBatchedRoute == 'perVariant'
  assert spot[1] > 2 * spot[0]


def test_inputs_of_a_scatter_scene():
  '''A scene with scatter: the uniform mode takes the sampler's rows and
  the scatter rows of every bounce; ray columns come with a seed, which
  keys the scatter draws (and a step drawing columns supplies one).'''
  from optics_design_workbench_tpu_torch import benchmarks
  from optics_design_workbench_tpu_torch.ops import cuda_trace
  step, hist, _meta = benchmarks.makeBenchStep(
      scene=_diffuser(), raysPerStep=N, maxIntersections=4,
      histBounds=BOUNDS, device='cpu')
  tables = step.tables
  with pytest.raises(ValueError, match='shape'):
    cuda_trace.traceHistogram(tables, hist, N, uniforms=torch.rand((2, N)),
                              **KW)
  cols = torch.rand((8, N))
  with pytest.raises(ValueError, match='needs a seed'):
    cuda_trace.traceRaw(tables, N, columns=cols, **KW)
  with pytest.raises(ValueError, match='exactly one'):
    cuda_trace.traceRaw(tables, N, seed=1, uniforms=torch.rand((10, N)),
                        **KW)
  # the stratified step draws columns on the host and a scatter seed
  stepS, histS, _m = benchmarks.makeBenchStep(
      scene=_diffuser(), raysPerStep=N, maxIntersections=4,
      histBounds=BOUNDS, stratified=True, device='cpu')
  histS, c = stepS(5, histS)
  assert int(c['hits']) == N and float(histS['counts'].sum()) == N
  # seed mode: the same seed, the same rays and draws
  h1 = {k: torch.zeros_like(v) for k, v in hist.items()}
  h2 = {k: torch.zeros_like(v) for k, v in hist.items()}
  step(9, h1)
  step(9, h2)
  assert torch.equal(h1['counts'], h2['counts'])


def test_run_simulation_scatter_raw_and_histogram(tmp_path):
  '''runSimulation on the diffuse scatter scene: raw rows == the run's
  recorded hits; histogram snapshot counts == the run's recorded hits.'''
  from optics_design_workbench_tpu_torch import benchmarks, simulation
  from optics_design_workbench_tpu_torch.jupyter_utils import RawFolder
  from optics_design_workbench_tpu_torch.simulation import results_store
  scene = benchmarks.buildDiffuseScatterScene(tmpdir=str(tmp_path))
  settings = scene.activeSimulationSettings()
  settings.RaysPerIteration, settings.EndAfterIterations = N, 2
  progress = []
  run = simulation.runSimulation(scene, 'true', seed=3, device='cpu',
                                 progressCallback=progress.append)
  hits = RawFolder(run).loadHits('Det')
  assert len(hits['points']) == progress[-1]['totalRecordedHits'] == 2 * N
  assert np.abs(hits['points'][:, 2]).max() < 1e-3
  progress.clear()
  run = simulation.runSimulation(scene, 'true', seed=4, device='cpu',
                                 recording='histogram', histBounds=BOUNDS,
                                 histBins=(64, 64),
                                 progressCallback=progress.append)
  counts = results_store.loadHistogramSnapshots(run)['Src']['Det']['counts']
  assert counts.sum() == progress[-1]['totalRecordedHits'] == 2 * N


# The JAX package's fused step on the diffuse scatter scene at 65,536 rays
# (seed 0): what chip_smoke.py's REF_SCATTER['diffuse'] holds the card's
# runs to (share binned over +-100 mm, mean binned power, moments of r^2
# over 128 x 128 bin centres)
REF_RAYS = 1 << 16
REF_DIFFUSE = dict(share=1.0, power=1.0, r2=36.43222153186798,
                   r4=34684.1870850767)


def test_bench_step_statistics_agree_with_reference():
  from optics_design_workbench_tpu_torch import benchmarks
  ref = H.scatterStatsOfReference('diffuse', REF_RAYS)
  for k, v in REF_DIFFUSE.items():
    assert ref[k] == pytest.approx(v, abs=1e-9), k
  step, hist, _meta = benchmarks.makeBenchStep(
      scene=benchmarks.buildDiffuseScatterScene(), raysPerStep=REF_RAYS,
      maxIntersections=4, histBounds=BOUNDS, device='cpu')
  hist, c = step(5, hist)
  H.assertScatterStatsAgree(H.scatterStats(hist, int(c['hits']), REF_RAYS),
                            ref, REF_RAYS, REF_RAYS)
