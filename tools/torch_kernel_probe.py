#!/usr/bin/env python3
'''Where the CUDA trace kernels' time goes, on one NVIDIA GPU:

    python3 tools/torch_kernel_probe.py [sweep [ROOT] | spectrometer
                                         | k1 [ROOT] | mesh [ROOT]
                                         | table [ROOT [--check]]
                                         | hist [ROOT]
                                         | cull [ROOT]]

(`sweep` runs the sweep breakdown alone, `sweep ROOT` times K3 of the
package in the checkout at ROOT on the sweeps of the examples/3 lens (64
radii, 64 x the focused and the defocused radius at 1 << 20 rays each, 11
radii at 200,000, 4 and 8 radii at 100,000), the spectrometer's 64 wavelengths at 1 << 20, 11
detector heights x 1 << 20 under the 1800-triangle dish and the
522-surface wall and 11 heights of the torus mirror and of the diffuser
(`sweep ROOT LABEL ...` runs only those cases), each with its launch
record, and where the package
groups variants (`cuda_trace.sweepVariantGroup`) again with the group
forced to 1, 2, 4, 8 and 16 (`--series=LABEL,...`: only on those cases),
each form held against the plain version on
11 variants x 65,536 rays; then the registers of the sweep instances (run
the parent's unpacked `_parent/` and the change in turns;
`--tables=DIR` keeps each case's packed tables in DIR, so that the runs
after the first build none), `spectrometer` the spectrometer's
alone; `k1 ROOT` times the main-path step of the package in the checkout at
ROOT — another commit's, unpacked — three series of 20 steps by CUDA events,
and prints the registers of its histogram kernel's instances, so that two
commits run in one call can be compared in turns; `mesh ROOT` likewise
times K1, K2 and K4 at 1 << 22 rays on the reference's dishes of 200, 1800,
5000 and 12800 triangles, with and without ray-index strata, beside the
main-path step; `table ROOT` times K1, K2 and K4 of the package at ROOT at
1 << 22 rays on those dishes and on the reference's walls of 522 and 5,071
analytic surfaces (the triangle and the surface table), with and without
strata, beside the main-path step, K3 on 11 detector heights under the
1800-triangle dish and the 522-surface wall, and prints each launch's
record, the tables' leaf boxes and the registers of every instance (run
the parent's unpacked `_parent/` and the change in turns; `table ROOT
--check` first holds K2 and K4 against their plain versions, bit for bit,
on those scenes and the two tie scenes at 1 << 18 rays); `hist ROOT`
times the two
histogram kernels of the package at ROOT on the scenes whose binning B11
redesigned — K1 on the lens-and-mirror main path, the spectrometer, the
diffuse scatter scene, the mesh fold, the 1800-triangle dish, the
522-surface wall, a pile-up of every ray in one bin, the surface source,
the torus mirror, the kinds scene and the emitter of those kinds, K3 on the
examples/3
radius sweep and the spectrometer's wavelength sweep at 64 x 1 << 20 rays —
each with its launch record and held against its plain version; `cull
ROOT [SCENE ...]` times K1, K2 and K4 of the package at ROOT through its
step factories on the port's timed scenes (or the SCENEs of CULL_SCENES
named), which the per-bounce culls (B12) do not prune, and on the decoy
scene of those culls with and without them, and prints the registers of
every instance) times
the port's
main-path step
(lens-and-mirror scene, 1 << 22 rays, 128 x 128 bins) in variants, each by CUDA events over 20 launches after a
warm-up, interleaved A B B A so that clock drift cancels:

  * bounce budget 1, 2, 3, 4, 6 — the cost of sampling plus each bounce;
  * ray-index strata on (256 rays per cell) and off;
  * input mode (a) seed, (b) uniforms, (c) ray columns;
  * output mode: in-kernel histogram, per-ray bins, raw records — on the
    main-path scene (one ring slot), and on the stacked-detector scene
    (two pass-through detectors and a mirror, four passes per ray) with
    1, 2 and 4 ring slots, which is what the ring's stores cost;
  * the record compaction + fetch behind the raw-record kernel, split into
    its device part (nonzero, split by element, gathers) and its
    device-to-host copies, beside what a split on the host and copies into
    pinned memory would cost (host clock around synchronised work);
  * the build with float contraction on (nvcc's default) against the
    shipped -fmad=false build, with the number of rays whose fate or bin
    then differs from the plain PyTorch version;
  * the parameter sweep on the examples/3 lens scene: the sweep kernel
    against the number of variants (2, 11, 64 radii from 45 to 95 mm; one
    variant is the histogram kernel) at 1 << 24 rays in all, each beside a
    loop of histogram-kernel launches over the same variants; 64 variants
    all at one radius, focused (60 mm: every ray in a few bins) and
    defocused (95 mm), which is what the histogram atomics cost; and a call
    of `ParameterSweeper.evaluateBatched` split into building and compiling
    the variants, packing the stacked table, upload + launch + fetch, and
    the metric; and one evaluation of `optimize` (`runSimulation` with raw
    recording, then `RawFolder.loadHits`) with a new source object and with
    the same one (host clock around synchronised work);
  * the grating spectrometer (`benchmarks.buildSpectrometerScene`, 1 << 22
    rays, 128 x 128 bins over +-80 mm), beside the lens-and-mirror main
    path at 6 bounces: the histogram kernel at a bounce budget of 1, 2 and
    3; the grating against a mirror in its place (the grating's share of a
    step); and the focused line's atomics: the histogram kernel on the
    throughput scene's line (theta <= 0.05) and on examples/4's narrower
    one (theta <= 0.01, most rays in a few bins), each beside the same step
    with histogram bounds that miss the line (no atomics), and the
    per-ray-bin and raw-record kernels, which write per ray instead.

Prints one JSON object per measurement. Needs a CUDA device.
'''

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, 'tests'))
if sys.argv[1:2] in (['k1'], ['mesh'], ['table'], ['hist'], ['cull'],
                     ['sweep']) and len(sys.argv) > 2:
  sys.path.insert(0, os.path.abspath(sys.argv[2]))   # the package measured

import torch_port_helpers as helpers          # the check scenes (imports no jax)

from optics_design_workbench_tpu_torch import (_build, benchmarks,
                                               simulation)
from optics_design_workbench_tpu_torch.jupyter_utils import RawFolder
from optics_design_workbench_tpu_torch.ops import cuda_trace
from optics_design_workbench_tpu_torch.tracing import fused

N = 1 << 22
BINS = (128, 128)
REPS = 20


def cudaMs(fn, reps=REPS):
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  fn()
  torch.cuda.synchronize()
  start.record()
  for _ in range(reps):
    fn()
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / reps


def busyStreamMs(fn, reps=REPS, spinCycles=2_000_000):
  """fn's device time in ms (mean of `reps` calls, each between two CUDA
  events), with the stream held busy by a spin kernel of `spinCycles`
  (about 1 ms) while the host enqueues the events and fn's launches, so
  that the host's time between them does not count: for launches shorter
  than the host's work to make them."""
  fn()
  torch.cuda.synchronize()
  pairs = []
  for _ in range(reps):
    torch.cuda._sleep(spinCycles)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    pairs.append((start, end))
  torch.cuda.synchronize()
  return sum(a.elapsed_time(b) for a, b in pairs) / reps


SWEEP_TOTAL_RAYS = 1 << 24
SWEEP_BINS = (64, 64)
SWEEP_BOUNDS = (-40., 40., -40., 40.)


def sweepBreakdown(dev):
  seeds = iter(range(10 ** 9))
  kw = dict(maxIntersections=6, maxRayLength=1000., distTol=1e-4, hitSlots=1)

  def kernels(label, radii, rep):
    '''The sweep kernel and the loop of histogram-kernel launches over the
    same variants, SWEEP_TOTAL_RAYS rays in all.'''
    V = len(radii)
    n = SWEEP_TOTAL_RAYS // V
    scenes = [benchmarks.buildSweepLensScene(float(r)) for r in radii]
    host = [sc.compile(device=None) for sc in scenes]
    spec = scenes[0].lightSources()[0].samplerSpec()
    histSpec = fused.makeHistogramSpec(*host[0], bounds=SWEEP_BOUNDS,
                                       bins=SWEEP_BINS)
    tile = cuda_trace.DEFAULT_STRATA_TILE \
        if cuda_trace.tileStrata(n, cuda_trace.DEFAULT_STRATA_TILE) else 0
    singles = [cuda_trace.buildTraceTables(h, histSpec, spec, device=dev)
               for h, _i in host]
    hists = [fused.initHistograms(histSpec, device=dev) for _ in singles]

    def loop():
      seed = next(seeds)
      for t, h in zip(singles, hists):
        c = cuda_trace.traceHistogram(t, h, n, seed=seed, strataTile=tile,
                                      **kw)
      return c

    row = dict(variant=f'sweep-{label}/rep{rep}', variants=V,
               raysPerVariant=n, strataTile=tile, loopMs=cudaMs(loop, 5))
    if V > 1:
      tables = cuda_trace.buildSweepTables([h for h, _i in host], histSpec,
                                           [spec] * V, device=dev)
      shape = (V, 1) + SWEEP_BINS
      hist = dict(power=torch.zeros(shape, device=dev),
                  counts=torch.zeros(shape, device=dev))
      sweep = lambda: cuda_trace.traceSweep(tables, hist, n, seed=next(seeds),
                                            strataTile=tile, **kw)
      row['sweepMs'] = cudaMs(sweep, 5)
      row['segments'] = int(sweep()[:, 0].sum())
      row['gSegmentsPerSec'] = row['segments'] / row['sweepMs'] / 1e6
    print(json.dumps(row), flush=True)

  for rep in range(2):
    for V in (1, 2, 11, 64):
      kernels(f'{V}radii', np.linspace(45., 95., V) if V > 1 else [60.], rep)
    kernels('64xfocused', [60.] * 64, rep)
    kernels('64xdefocused', [95.] * 64, rep)

  # one evaluateBatched call, piece by piece (the pieces of
  # ParameterSweeper.evaluateBatched, asked for one at a time)
  sweeper, holder = benchmarks.makeSweepLensSweeper(device=dev)

  def metric(power, counts):
    return helpers.spotMetric(power, counts)

  for V, n in ((11, 200_000), (64, 1 << 20)):
    for k in range(3):
      sets = [dict(R=float(r + 0.3 * k)) for r in np.linspace(45., 95., V)]
      torch.cuda.synchronize()
      t0 = time.perf_counter()
      variants = sweeper._compileVariants(sets, lambda: holder['scene'])
      t1 = time.perf_counter()
      step, table = sweeper._sweepRoute(variants, n, 6, 1000., 1e-4,
                                        SWEEP_BINS, SWEEP_BOUNDS)
      t2 = time.perf_counter()
      step(k, table)
      torch.cuda.synchronize()
      t3 = time.perf_counter()
      both = step.histograms.cpu().numpy()
      t4 = time.perf_counter()
      m = [metric(p, c) for p, c in zip(both[0], both[1])]
      t5 = time.perf_counter()
      whole = sweeper.evaluateBatched(
          sets, metric, sceneFactory=lambda: holder['scene'], raysPerScene=n,
          maxIntersections=6, bins=SWEEP_BINS, histBounds=SWEEP_BOUNDS,
          seed=k)
      t6 = time.perf_counter()
      assert list(whole) == m
      print(json.dumps(dict(
          variant=f'evaluateBatched/{V}x{n}/call{k}',
          buildAndCompileVariantsMs=(t1 - t0) * 1e3,
          signaturesSpecAndPackMs=(t2 - t1) * 1e3,
          uploadLaunchWaitMs=(t3 - t2) * 1e3, fetchMs=(t4 - t3) * 1e3,
          metricMs=(t5 - t4) * 1e3, wholeCallMs=(t6 - t5) * 1e3)), flush=True)

  # one evaluation of `optimize` (runSimulation with raw recording, 20,000
  # rays, then RawFolder.loadHits), with a NEW source object, as the
  # examples/3 setter makes one per evaluation, and again on the same scene,
  # whose source keeps its compiled sampling tables
  tmp = tempfile.mkdtemp(prefix='odw_probe_')
  try:
    for k in range(3):
      row = dict(variant=f'optimizeEvaluation/call{k}')
      t0 = time.perf_counter()
      scene = benchmarks.buildSweepLensScene(60. + k,
                                             path=os.path.join(tmp, 'e3'))
      row['buildSceneMs'] = (time.perf_counter() - t0) * 1e3
      for label in ('newSource', 'sameSource'):
        t0 = time.perf_counter()
        runPath = simulation.runSimulation(scene, 'true', seed=k, device=dev)
        t1 = time.perf_counter()
        rows = len(RawFolder(runPath).loadHits('Detector'))
        row[f'{label}RunMs'] = (t1 - t0) * 1e3
        row[f'{label}LoadHitsMs'] = (time.perf_counter() - t1) * 1e3
      row['hitRows'] = rows
      print(json.dumps(row), flush=True)
  finally:
    shutil.rmtree(tmp, ignore_errors=True)


SPECTRO_BOUNDS = (-80., 80., -80., 80.)


def spectrometerBreakdown(dev):
  seeds = iter(range(10 ** 9))
  tile = cuda_trace.DEFAULT_STRATA_TILE

  def tablesOf(scene, bounds):
    sceneNp, info = scene.compile(device=None)
    histSpec = fused.makeHistogramSpec(sceneNp, info, bounds=bounds,
                                       bins=BINS)
    return (cuda_trace.buildTraceTables(
        sceneNp, histSpec, samplerSpec=scene.lightSources()[0].samplerSpec(),
        device=dev), fused.initHistograms(histSpec, device=dev))

  def k1(label, tables, hist, maxI, out='hist'):
    kw = dict(hitSlots=1, strataTile=tile)
    if out == 'hist':
      fn = lambda: cuda_trace.traceHistogram(tables, hist, N, maxI, 1000.,
                                             1e-4, seed=next(seeds), **kw)
    else:
      wrapper = cuda_trace.traceBins if out == 'bins' else cuda_trace.traceRaw
      fn = lambda: wrapper(tables, N, maxI, 1000., 1e-4, seed=next(seeds),
                           **kw)[1]
    ms = cudaMs(fn)
    c = fn().tolist()
    print(json.dumps(dict(variant=label, output=out, ms=ms, bounces=maxI,
                          segments=c[0], hits=c[1],
                          gSegmentsPerSec=c[0] / ms / 1e6,
                          peakBinShare=float(hist['counts'].max()
                                             / max(float(hist['counts'].sum()),
                                                   1.)))), flush=True)

  lens = tablesOf(benchmarks.buildLensMirrorScene(), (-60., 60., -60., 60.))
  spectro = tablesOf(benchmarks.buildSpectrometerScene(), SPECTRO_BOUNDS)
  mirrorScene = benchmarks.buildSpectrometerScene()
  mirrorScene.getObject('Grating').OpticalType = 'Mirror'
  mirror = tablesOf(mirrorScene, SPECTRO_BOUNDS)
  narrowScene = benchmarks.buildSpectrometerScene()
  src = narrowScene.lightSources()[0]
  src.PowerDensity, src.ThetaDomain = 'exp(-theta^2/1e-6)', '0, 0.01'
  narrow = tablesOf(narrowScene, SPECTRO_BOUNDS)
  # the same steps with histogram bounds away from the line: every hit fails
  # the bounds gate, so no atomic is issued
  quiet = {label: tablesOf(scene, (60., 80., 60., 80.))
           for label, scene in (('wide', benchmarks.buildSpectrometerScene()),
                                ('narrow', narrowScene))}
  for rep in range(2):
    k1(f'lensMirror-bounces6/rep{rep}', *lens, 6)
    for maxI in (1, 2, 3):
      k1(f'spectrometer-bounces{maxI}/rep{rep}', *spectro, maxI)
    for label, t in (('grating', spectro), ('mirror', mirror),
                     ('mirror', mirror), ('grating', spectro)):
      k1(f'spectrometer-{label}/rep{rep}', *t, 3)
    for label, t in (('wide', spectro), ('narrow', narrow)):
      for out in ('hist', 'bins', 'raw'):
        k1(f'line-{label}/rep{rep}', *t, 3, out=out)
      k1(f'line-{label}-outOfBounds/rep{rep}', *quiet[label], 3)


def k1Series():
  '''The main-path step (`makeBenchStep`: lens-and-mirror, 1 << 22 rays,
  6 bounces, 128 x 128 bins) of the package on the path: three series of
  20 steps by CUDA events, and the registers of its histogram kernel.'''
  import optics_design_workbench_tpu_torch as port
  step, hist, _meta = benchmarks.makeBenchStep(raysPerStep=N,
                                               maxIntersections=6, bins=BINS)
  seeds = iter(range(10 ** 9))
  series = [cudaMs(lambda: step(next(seeds), hist)) for _ in range(3)]
  _libs, info = _build.buildKernels()
  regs = [l.split('Used ')[1].split(' registers')[0]
          for l in info['log'].splitlines()
          if 'Used' in l and 'registers' in l]
  print(json.dumps(dict(variant='k1-main-path', package=port.__file__,
                        digest=port.kernelSourceDigest(), msSeries=series,
                        registersInBuildOrder=regs)), flush=True)


def meshSeries():
  '''K1, K2 and K4 (ms by CUDA events, 1 << 22 rays, 3 intersections) on
  the dishes of 200 to 12800 triangles of the package on the path: with the
  samplers' ray-index strata (one (theta, phi) cell a block, as the steps
  run) and without (every warp's rays spread over the source), beside the
  main-path step.'''
  import optics_design_workbench_tpu_torch as port
  seeds = iter(range(10, 10 ** 9))
  step, hist, _meta = benchmarks.makeBenchStep(raysPerStep=N, bins=BINS)
  out = dict(variant='mesh', package=port.__file__,
             digest=port.kernelSourceDigest(),
             lensK1=cudaMs(lambda: step(next(seeds), hist)))
  bounds = (-200., 200., -200., 200.)
  for nQ in (10, 30, 50, 80):
    step, hist, _meta = benchmarks.makeBenchStep(
        scene=benchmarks.buildMeshDishScene(nQ), raysPerStep=N,
        maxIntersections=3, histBounds=bounds, bins=BINS)
    t = step.tables
    for strata in (step.strataTile, 0):
      kw = dict(maxIntersections=3, maxRayLength=1000., distTol=1e-4,
                hitSlots=step.hitSlots, strataTile=strata)
      k1 = cudaMs(lambda: cuda_trace.traceHistogram(
          t, hist, N, seed=next(seeds), **kw), 10)
      k2 = cudaMs(lambda: cuda_trace.traceBins(t, N, seed=next(seeds), **kw),
                  10)
      k4 = cudaMs(lambda: cuda_trace.traceRaw(t, N, seed=next(seeds), **kw),
                  10)
      out[f'dish{2 * nQ * nQ}/strata{strata}'] = [k1, k2, k4]
  print(json.dumps(out), flush=True)


# the scenes of the table sweeps (B7, B8): name -> (benchmarks function,
# its arguments, histogram bounds); 3 intersections each
TABLE_SCENES = {
    'dish200': ('buildMeshDishScene', (10,), (-200., 200., -200., 200.)),
    'dish1800': ('buildMeshDishScene', (30,), (-200., 200., -200., 200.)),
    'dish5000': ('buildMeshDishScene', (50,), (-200., 200., -200., 200.)),
    'dish12800': ('buildMeshDishScene', (80,), (-200., 200., -200., 200.)),
    'wall522': ('buildSurfWallScene', (), (-300., 300., -300., 300.)),
    'wall5071': ('buildSurfWall5kScene', (), (-300., 300., -300., 300.)),
}


TABLE_CHECK_RAYS = 1 << 18


def tableCheck(tables, hitSlots):
  """K2 and K4 of the package on the path against their plain versions on
  the same TABLE_CHECK_RAYS uniforms (mode (b), strata as the steps run, 3
  intersections): whether ring and counters are equal, bit for bit."""
  n, tile = TABLE_CHECK_RAYS, cuda_trace.DEFAULT_STRATA_TILE
  gen = torch.Generator(device='cuda')
  gen.manual_seed(77)
  us = torch.rand((2, n), generator=gen, device='cuda')
  cols = cuda_trace.samplerColumnsPlain(
      tables, us, cuda_trace.tileStrata(n, tile), tile)
  kw = dict(maxIntersections=3, maxRayLength=1000., distTol=1e-4,
            powerTol=1e-6, hitSlots=hitSlots)
  out = {}
  for name, plain in (('traceBins', cuda_trace.traceBinsPlain),
                      ('traceRaw', cuda_trace.traceRawPlain)):
    ringK, cK = getattr(cuda_trace, name)(tables, n, uniforms=us,
                                          strataTile=tile, **kw)
    ringP, cP = plain(tables, cols, **kw)
    out[name] = dict(equal=bool(torch.equal(ringK, ringP))
                     and cK.tolist() == cP.tolist(), counters=cK.tolist())
  return out


def tableSeries(check):
  """K1, K2 and K4 (ms by CUDA events, 1 << 22 rays, 3 intersections, 10
  launches each) of the package on the path on the reference's dishes of
  200 to 12800 triangles and its walls of 522 and 5,071 analytic surfaces
  (the triangle and the surface table), with the samplers' ray-index
  strata (one (theta, phi) cell a block, as the steps run) and without
  (every warp's rays spread over the source), beside the main-path step,
  with each launch's record (`cuda_trace.lastLaunch`) and the tables' leaf
  boxes (none before the sweep's third level); K3 on 11 detector heights x
  1 << 20 rays under the 1800-triangle dish and the 522-surface wall; then
  the registers of every instance. With `check`, first K2 and K4 against
  their plain versions on those scenes and the two tie scenes
  (`tableCheck`)."""
  import optics_design_workbench_tpu_torch as port
  seeds = iter(range(10, 10 ** 9))
  step, hist, _meta = benchmarks.makeBenchStep(raysPerStep=N, bins=BINS)
  out = dict(variant='table', package=port.__file__,
             digest=port.kernelSourceDigest(),
             lensK1=cudaMs(lambda: step(next(seeds), hist)))
  if check:
    ns = helpers.torchNs()
    for name, (scene, bounds, _maxI) in (
        ('tieMesh', helpers.buildTieMeshScene(ns)),
        ('tieTable', helpers.SURFACE_TABLE_SCENES['tie'](ns))):
      step, _h, _m = benchmarks.makeBenchStep(
          scene=scene, raysPerStep=N, maxIntersections=3, histBounds=bounds,
          bins=BINS)
      out[f'{name}/check'] = tableCheck(step.tables, step.hitSlots)
  for name, (make, args, bounds) in TABLE_SCENES.items():
    step, hist, _meta = benchmarks.makeBenchStep(
        scene=getattr(benchmarks, make)(*args), raysPerStep=N,
        maxIntersections=3, histBounds=bounds, bins=BINS)
    t = step.tables
    if check:
      out[f'{name}/check'] = tableCheck(t, step.hitSlots)
    out[f'{name}/leaves'] = dict(triLeaves=t.get('nTriLeaves'),
                                 surfLeaves=t.get('nSurfLeaves'))
    for strata in (step.strataTile, 0):
      kw = dict(maxIntersections=3, maxRayLength=1000., distTol=1e-4,
                hitSlots=step.hitSlots, strataTile=strata)
      out[f'{name}/strata{strata}'] = [
          cudaMs(lambda: cuda_trace.traceHistogram(
              t, hist, N, seed=next(seeds), **kw), 10),
          cudaMs(lambda: cuda_trace.traceBins(t, N, seed=next(seeds), **kw),
                 10),
          cudaMs(lambda: cuda_trace.traceRaw(t, N, seed=next(seeds), **kw),
                 10)]
      out[f'{name}/strata{strata}/lastLaunch'] = \
          cuda_trace.lastLaunch['traceHistogram']
  for name, make, bounds in (
      ('dish1800', lambda z: benchmarks.buildMeshDishScene(30, detectorZ=z),
       TABLE_SCENES['dish1800'][2]),
      ('wall522', lambda z: benchmarks.buildSurfWallScene(detectorZ=z),
       TABLE_SCENES['wall522'][2])):
    scenes = [make(float(z)) for z in np.linspace(-20., 0., 11)]
    host = [sc.compile(device=None) for sc in scenes]
    histSpec = fused.makeHistogramSpec(*host[0], bounds=bounds, bins=BINS)
    tables = cuda_trace.buildSweepTables(
        [h for h, _i in host], histSpec,
        [scenes[0].lightSources()[0].samplerSpec()] * len(scenes))
    power = torch.zeros((len(scenes), tables['nDet']) + BINS,
                        device='cuda')
    counts = torch.zeros_like(power)
    out[f'{name}/k3'] = cudaMs(lambda: cuda_trace.traceSweep(
        tables, dict(power=power, counts=counts), 1 << 20, 3, 1000., 1e-4,
        hitSlots=cuda_trace.autoHitSlots(host[0][0], histSpec, 3),
        seed=next(seeds), strataTile=256), 5)
  out['registers'], out['buildSeconds'] = instanceRegisters()
  print(json.dumps(out), flush=True)


def instanceRegisters():
  '''({instance: [registers, spill store bytes]}, build seconds) of the
  package on the path, from ptxas's output; an instance is its output mode
  and template flags (sweep, B4, surface sampler, scatter, GEOM, TRI,
  STAB and, since the sweep's variant groups, GROUPED), as digits.'''
  import re
  _libs, info = _build.buildKernels()
  regs, current = {}, None
  for line in info['log'].splitlines():
    m = re.search(r'traceKernelILi(\d)E((?:Lb[01]E)+)', line)
    if 'Compiling entry function' in line and m:
      current = m.group(1) + ''.join(re.findall(r'Lb([01])E', m.group(2)))
      regs[current] = [None, 0]
    m = re.search(r'(\d+) bytes spill stores', line)
    if m and current:
      regs[current][1] = int(m.group(1))
    m = re.search(r'Used (\d+) registers', line)
    if m and current:
      regs[current][0] = int(m.group(1))
      current = None
  return regs, info['seconds']


# the port's timed scenes: name -> (benchmarks function, intersections,
# histogram bounds)
CULL_SCENES = {
    'lens': ('buildLensMirrorScene', 6, (-60., 60., -60., 60.)),
    'spectrometer': ('buildSpectrometerScene', 3, (-80., 80., -80., 80.)),
    'surface': ('buildSurfaceSourceScene', 4, (-120., 120., -120., 120.)),
    'diffuse': ('buildDiffuseScatterScene', 4, (-100., 100., -100., 100.)),
    'torus': ('buildTorusMirrorScene', 3, (-200., 200., -200., 200.)),
    'kinds': ('buildKindsScene', 8, (-300., 300., -300., 300.)),
    'emitter': ('buildEmitterKindsScene', 4, (-200., 200., -200., 200.)),
    'meshFold': ('buildMeshFoldScene', 3, (-300., 300., -300., 300.)),
    'dish1800': ('buildMeshDishScene', 3, (-200., 200., -200., 200.)),
    'wall522': ('buildSurfWallScene', 3, (-300., 300., -300., 300.)),
    'decoy': ('buildCullDecoyScene', 4, (-300., 300., -300., 300.)),
}


def cullSeries():
  '''B12: K1 (the step, with its delta's memset and add), K2 (1 << 22 rays)
  and K4 (1 << 20) by CUDA events, 10 calls each, through the step
  factories of the package on the path (`makeBenchStep`, which gives a
  package with the culls the source's emission bound) on every scene of
  CULL_SCENES it has; where the tables carry a cull block, the same
  kernels on tables without it beside them; then the registers of every
  instance.'''
  import optics_design_workbench_tpu_torch as port
  seeds = iter(range(10, 10 ** 9))
  out = dict(variant='cull', package=port.__file__,
             digest=port.kernelSourceDigest())
  only = sys.argv[3:]                  # scene names, all by default
  for name, (make, maxI, bounds) in CULL_SCENES.items():
    if not hasattr(benchmarks, make) or (only and name not in only):
      continue
    scene = getattr(benchmarks, make)(*((30,) if name == 'dish1800' else ()))
    step, hist, meta = benchmarks.makeBenchStep(
        scene=scene, raysPerStep=N, maxIntersections=maxI, histBounds=bounds,
        bins=BINS)
    kw = dict(maxIntersections=maxI, maxRayLength=1000., distTol=1e-4,
              hitSlots=step.hitSlots, strataTile=step.strataTile)
    variants = [('', step.tables)]
    if step.tables.get('cullOff', -1) >= 0:
      variants.append(('/unculled', cuda_trace.buildTraceTables(
          meta['device'], meta['histSpec'],
          samplerSpec=scene.lightSources()[0].samplerSpec(), device='cuda')))
    for suffix, t in variants:
      out[name + suffix] = [
          cudaMs(lambda: cuda_trace.traceHistogram(
              t, hist, N, seed=next(seeds), **kw), 10),
          cudaMs(lambda: cuda_trace.traceBins(t, N, seed=next(seeds), **kw),
                 10),
          cudaMs(lambda: cuda_trace.traceRaw(t, N >> 2, seed=next(seeds),
                                             **kw), 10)]
  out['registers'], out['buildSeconds'] = instanceRegisters()
  print(json.dumps(out), flush=True)


HIST_CHECK_RAYS = 1 << 20


def histSeries(dev):
  '''B11: K1's step (1 << 22 rays, 128 x 128 bins) and K3 (64 variants x
  1 << 20 rays) by CUDA events on the scenes whose binning the redesign
  touches, with each launch's record (`cuda_trace.lastLaunch`, where the
  package keeps one), each held against its plain version on the same
  uniforms (HIST_CHECK_RAYS rays, K3 at 8 variants): counters equal, rays
  that changed bins, worst relative power error on the bins both agree
  on.'''
  import optics_design_workbench_tpu_torch as port
  seeds = iter(range(100, 10 ** 9))
  regs, buildSeconds = instanceRegisters()
  print(json.dumps(dict(variant='hist', package=port.__file__,
                        digest=port.kernelSourceDigest(),
                        buildSeconds=buildSeconds, registers=regs)),
        flush=True)

  def record(wrapper):
    return getattr(cuda_trace, 'lastLaunch', {}).get(wrapper)

  def compare(hK, hP, cK, cP):
    moved = float((hK['counts'] - hP['counts']).abs().sum()) / 2
    same = (hK['counts'] == hP['counts']) & (hP['counts'] > 0)
    pK, pP = hK['power'][same], hP['power'][same]
    rel = float(((pK - pP).abs() / pP).max()) if pP.numel() else 0.
    return dict(countersEqual=cK.tolist() == cP.tolist(), movedRays=moved,
                maxRelErrPower=rel)

  k1Scenes = (
      ('lensMirror', benchmarks.buildLensMirrorScene, 6, (-60., 60., -60., 60.)),
      ('spectrometer', benchmarks.buildSpectrometerScene, 3, SPECTRO_BOUNDS),
      ('diffuse', benchmarks.buildDiffuseScatterScene, 4,
       (-100., 100., -100., 100.)),
      ('meshFold', benchmarks.buildMeshFoldScene, 3,
       (-300., 300., -300., 300.)),
      ('dish1800', lambda: benchmarks.buildMeshDishScene(30), 3,
       (-200., 200., -200., 200.)),
      ('wall522', benchmarks.buildSurfWallScene, 3,
       (-300., 300., -300., 300.)),
      ('pileUp', lambda: helpers.buildPileUpScene(
          helpers.torchNs(), 80. / BINS[0] / 2)[0], 2, helpers.PILEUP_BOUNDS),
      ('surface', benchmarks.buildSurfaceSourceScene, 4,
       (-120., 120., -120., 120.)),
      ('torus', benchmarks.buildTorusMirrorScene, 3,
       (-200., 200., -200., 200.)),
      ('kinds', benchmarks.buildKindsScene, 8, (-300., 300., -300., 300.)),
      ('emitter', benchmarks.buildEmitterKindsScene, 4,
       (-200., 200., -200., 200.)))
  for label, make, maxI, bounds in k1Scenes:
    step, hist, meta = benchmarks.makeBenchStep(
        scene=make(), raysPerStep=N, maxIntersections=maxI,
        histBounds=bounds, bins=BINS)
    row = dict(variant=f'k1-{label}', rays=N,
               ms=cudaMs(lambda: step(next(seeds), hist)),
               launch=record('traceHistogram'))
    t, n = step.tables, HIST_CHECK_RAYS
    kw = dict(maxIntersections=maxI, maxRayLength=1000., distTol=1e-4,
              powerTol=1e-6, hitSlots=step.hitSlots)
    us = torch.rand((cuda_trace.uniformRows(t, maxI), n), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(5))
    tile = cuda_trace.DEFAULT_STRATA_TILE
    cols = cuda_trace.samplerColumnsPlain(t, us, cuda_trace.tileStrata(
        n, tile), tile)
    hP = fused.initHistograms(meta['histSpec'], device=dev)
    cP = cuda_trace.traceHistogramPlain(
        t, hP, cols, **kw,
        scatterUniforms=us[cuda_trace.samplerUniforms(t):]
        if t['scatter'] else None)
    hK = fused.initHistograms(meta['histSpec'], device=dev)
    cK = cuda_trace.traceHistogram(t, hK, n, uniforms=us, strataTile=tile,
                                   **kw)
    row['vsPlain'] = compare(hK, hP, cK, cP)
    print(json.dumps(row), flush=True)

  # K3: the examples/3 radius sweep (64 x 64 bins) and the spectrometer's
  # wavelength sweep (128 x 128 bins)
  V, n = 64, 1 << 20
  k3Cases = (
      ('examples3', [benchmarks.buildSweepLensScene(float(r))
                     for r in np.linspace(45., 95., V)], 6, SWEEP_BOUNDS,
       SWEEP_BINS),
      ('spectrometer', [benchmarks.buildSpectrometerScene(wavelength=float(w))
                        for w in np.linspace(400., 700., V)], 3,
       SPECTRO_BOUNDS, BINS))
  for label, scenes, maxI, bounds, bins in k3Cases:
    host = [sc.compile(device=None) for sc in scenes]
    histSpec = fused.makeHistogramSpec(*host[0], bounds=bounds, bins=bins)
    specs = [sc.lightSources()[0].samplerSpec() for sc in scenes]
    tables = cuda_trace.buildSweepTables([h for h, _i in host], histSpec,
                                         specs, device=dev)
    shape = (V, 1) + bins
    hist = dict(power=torch.zeros(shape, device=dev),
                counts=torch.zeros(shape, device=dev))
    tile = cuda_trace.DEFAULT_STRATA_TILE
    kw = dict(maxIntersections=maxI, maxRayLength=1000., distTol=1e-4,
              powerTol=1e-6, hitSlots=1)
    sweep = lambda: cuda_trace.traceSweep(tables, hist, n, seed=next(seeds),
                                          strataTile=tile, **kw)
    row = dict(variant=f'k3-{label}', variants=V, raysPerVariant=n,
               ms=cudaMs(sweep, 5), launch=record('traceSweep'))
    nC, vC = HIST_CHECK_RAYS, 8
    few = cuda_trace.buildSweepTables(
        [h for h, _i in host[::V // vC]], histSpec, specs[::V // vC],
        device=dev)
    us = torch.rand((2, nC), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(6))
    fewShape = (vC, 1) + bins
    hP = dict(power=torch.zeros(fewShape, device=dev),
              counts=torch.zeros(fewShape, device=dev))
    cP = cuda_trace.traceSweepPlain(
        few, hP, nC, uniforms=us, strata=cuda_trace.tileStrata(nC, tile),
        strataTile=tile, **kw)
    hK = dict(power=torch.zeros(fewShape, device=dev),
              counts=torch.zeros(fewShape, device=dev))
    cK = cuda_trace.traceSweep(few, hK, nC, uniforms=us, strataTile=tile,
                               **kw)
    row['vsPlain'] = compare(hK, hP, cK, cP)
    print(json.dumps(row), flush=True)


# the forced variant groups of `sweepSeries`
SWEEP_GROUPS = (1, 2, 4, 8, 16)
SWEEP_CHECK = (11, 1 << 16)        # variants, rays of a check against plain


def sweepSeries(dev):
  """K3 of the package on the path (ms by CUDA events, 5 launches after a
  warm-up; where one takes under 2 ms, 100 launches each between two
  events behind a spin kernel, `busyStreamMs`; seed mode with the steps'
  strata) on the sweeps of the examples/3
  lens, the spectrometer, the 1800-triangle dish and the 522-surface wall,
  with each launch's record; where the package picks a variant group
  (`cuda_trace.sweepVariantGroup`), the same with the group forced to each
  of SWEEP_GROUPS. Each form is held against the plain version on the first
  SWEEP_CHECK variants and rays (uniforms, strata): counters equal, rays
  that changed bins, worst relative power error. Then the registers of
  the sweep instances."""
  import optics_design_workbench_tpu_torch as port
  seeds = iter(range(300, 10 ** 9))
  grouped = hasattr(cuda_trace, 'sweepVariantGroup')
  rule = getattr(cuda_trace, 'sweepVariantGroup', None)
  print(json.dumps(dict(variant='sweep', package=port.__file__,
                        digest=port.kernelSourceDigest(), grouped=grouped)),
        flush=True)
  lens = lambda radii: [benchmarks.buildSweepLensScene(float(r))
                        for r in radii]
  heights = np.linspace(-20., 0., 11)
  cases = (
      ('examples3-64radii', lambda: lens(np.linspace(45., 95., 64)), 1 << 20,
       6, SWEEP_BOUNDS, SWEEP_BINS),
      ('examples3-64xfocused', lambda: lens([60.] * 64), 1 << 20, 6,
       SWEEP_BOUNDS, SWEEP_BINS),
      ('examples3-64xdefocused', lambda: lens([95.] * 64), 1 << 20, 6,
       SWEEP_BOUNDS, SWEEP_BINS),
      ('examples3-11radii', lambda: lens(np.linspace(45., 95., 11)), 200_000,
       6, SWEEP_BOUNDS, SWEEP_BINS),
      # evaluateBatched's default 100,000 rays a variant
      ('examples3-4x100k', lambda: lens(np.linspace(45., 95., 4)), 100_000,
       6, SWEEP_BOUNDS, SWEEP_BINS),
      ('examples3-8x100k', lambda: lens(np.linspace(45., 95., 8)), 100_000,
       6, SWEEP_BOUNDS, SWEEP_BINS),
      ('spectrometer-64', lambda: [
          benchmarks.buildSpectrometerScene(wavelength=float(w))
          for w in np.linspace(400., 700., 64)], 1 << 20, 3, SPECTRO_BOUNDS,
       BINS),
      ('dish1800-11heights', lambda: [
          benchmarks.buildMeshDishScene(30, detectorZ=float(z))
          for z in heights], 1 << 20, 3, (-200., 200., -200., 200.), BINS),
      ('wall522-11heights', lambda: [
          benchmarks.buildSurfWallScene(detectorZ=float(z))
          for z in heights], 1 << 20, 3, (-300., 300., -300., 300.), BINS),
      ('torus-11heights', lambda: [
          benchmarks.buildTorusMirrorScene(height=float(z))
          for z in np.linspace(70., 90., 11)], 1 << 20, 3,
       (-200., 200., -200., 200.), BINS),
      ('diffuse-11heights', lambda: [
          benchmarks.buildDiffuseScatterScene(diffuserZ=float(z))
          for z in np.linspace(40., 60., 11)], 1 << 20, 4,
       (-100., 100., -100., 100.), BINS))
  args = sys.argv[3:]
  opts = dict(a[2:].split('=', 1) for a in args if a.startswith('--'))
  only = [a for a in args if not a.startswith('--')]   # all by default
  series = opts['series'].split(',') if 'series' in opts else None
  tablesDir = opts.get('tables')

  def packed(label, make, bounds, bins, maxI):
    """The case's tables and its first variants' (SWEEP_CHECK), packed on
    the host, and its hit slots; kept in `tablesDir` where given."""
    path = tablesDir and os.path.join(tablesDir, f'{label}.pt')
    if path and os.path.exists(path):
      return torch.load(path, weights_only=False)
    scenes = make()
    host = [sc.compile(device=None) for sc in scenes]
    histSpec = fused.makeHistogramSpec(*host[0], bounds=bounds, bins=bins)
    specs = [sc.lightSources()[0].samplerSpec() for sc in scenes]
    vC = min(len(scenes), SWEEP_CHECK[0])
    out = dict(
        tables=cuda_trace.buildSweepTables([h for h, _i in host], histSpec,
                                           specs, device='cpu'),
        few=cuda_trace.buildSweepTables([h for h, _i in host[:vC]],
                                        histSpec, specs[:vC], device='cpu'),
        hitSlots=cuda_trace.autoHitSlots(host[0][0], histSpec, maxI))
    if path:
      os.makedirs(tablesDir, exist_ok=True)
      torch.save(out, path)
    return out

  def onDevice(tables):
    """The packed tables on the card, with this package's `sharedDraws`
    where it has them (tables packed by another checkout may lack it)."""
    out = {k: v.to(dev) if isinstance(v, torch.Tensor) else v
           for k, v in tables.items()}
    if hasattr(cuda_trace, 'sharedDrawsOf'):
      out['sharedDraws'] = cuda_trace.sharedDrawsOf(
          tables['table'].numpy(), tables['samplerOff'])
    return out

  for label, make, n, maxI, bounds, bins in cases:
    if only and label not in only:
      continue
    pack = packed(label, make, bounds, bins, maxI)
    tables, few = onDevice(pack['tables']), onDevice(pack['few'])
    V = tables['nVariants']
    shape = (V, tables['nDet']) + bins
    hist = dict(power=torch.zeros(shape, device=dev),
                counts=torch.zeros(shape, device=dev))
    tile = cuda_trace.DEFAULT_STRATA_TILE
    kw = dict(maxIntersections=maxI, maxRayLength=1000., distTol=1e-4,
              powerTol=1e-6, hitSlots=pack['hitSlots'])
    vC, nC = few['nVariants'], SWEEP_CHECK[1]
    us = torch.rand((cuda_trace.uniformRows(few, maxI), nC), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(6))
    fewShape = (vC, few['nDet']) + bins
    hP = dict(power=torch.zeros(fewShape, device=dev),
              counts=torch.zeros(fewShape, device=dev))
    cP = cuda_trace.traceSweepPlain(
        few, hP, nC, uniforms=us, strata=cuda_trace.tileStrata(nC, tile),
        strataTile=tile, **kw)

    def check():
      hK = dict(power=torch.zeros(fewShape, device=dev),
                counts=torch.zeros(fewShape, device=dev))
      cK = cuda_trace.traceSweep(few, hK, nC, uniforms=us, strataTile=tile,
                                 **kw)
      moved = (hK['counts'] - hP['counts']).abs().sum(dim=(1, 2, 3)) / 2
      same = (hK['counts'] == hP['counts']) & (hP['counts'] > 0)
      pK, pP = hK['power'][same], hP['power'][same]
      return dict(countersEqual=cK.tolist() == cP.tolist(),
                  movedRaysMax=float(moved.max()),
                  maxRelErrPower=float(((pK - pP).abs() / pP).max()),
                  launch=cuda_trace.lastLaunch['traceSweep'])

    sweep = lambda: cuda_trace.traceSweep(tables, hist, n, seed=next(seeds),
                                          strataTile=tile, **kw)
    # 5 launches, or 100 where one takes under 2 ms
    timed = lambda: (lambda ms: ms if ms >= 2. else busyStreamMs(sweep, 100))(
        cudaMs(sweep, 5))
    row = dict(variant=f'k3-{label}', variants=V, raysPerVariant=n,
               sharedDraws=tables.get('sharedDraws'), ms=timed(),
               launch=cuda_trace.lastLaunch['traceSweep'], vsPlain=check())
    if grouped and (series is None or label in series):
      row['msByGroup'], row['vsPlainByGroup'] = {}, {}
      try:
        for vb in SWEEP_GROUPS:
          cuda_trace.sweepVariantGroup = lambda *a, vb=vb, **k: vb
          row['msByGroup'][vb] = timed()
          row['vsPlainByGroup'][vb] = check()
      finally:
        cuda_trace.sweepVariantGroup = rule
    print(json.dumps(row), flush=True)
  regs, buildSeconds = instanceRegisters()
  print(json.dumps(dict(variant='sweep-registers', buildSeconds=buildSeconds,
                        registers={k: v for k, v in regs.items()
                                   if k[1] == '1'})), flush=True)


def main():
  if not torch.cuda.is_available():
    sys.exit('needs a CUDA device')
  dev = torch.device('cuda')
  smi = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, check=True).stdout.strip()
  print(json.dumps(dict(card=smi, torch=torch.__version__, rays=N,
                        bins=BINS)), flush=True)
  if sys.argv[1:] == ['sweep']:
    return sweepBreakdown(dev)
  if sys.argv[1:2] == ['sweep']:
    return sweepSeries(dev)
  if sys.argv[1:] == ['spectrometer']:
    return spectrometerBreakdown(dev)
  if sys.argv[1:2] == ['k1']:
    return k1Series()
  if sys.argv[1:2] == ['mesh']:
    return meshSeries()
  if sys.argv[1:2] == ['table']:
    return tableSeries('--check' in sys.argv[3:])
  if sys.argv[1:2] == ['hist']:
    return histSeries(dev)
  if sys.argv[1:2] == ['cull']:
    return cullSeries()

  scene = benchmarks.buildLensMirrorScene()
  sceneNp, info = scene.compile(device=None)
  histSpec = fused.makeHistogramSpec(sceneNp, info,
                                     bounds=(-60., 60., -60., 60.), bins=BINS)
  tables = cuda_trace.buildTraceTables(
      sceneNp, histSpec, samplerSpec=scene.lightSources()[0].samplerSpec(),
      device=dev)
  hist = fused.initHistograms(histSpec, device=dev)
  gen = torch.Generator(device=dev)
  gen.manual_seed(11)
  us = torch.rand((2, N), generator=gen, device=dev)
  tile = cuda_trace.DEFAULT_STRATA_TILE
  cols = cuda_trace.sampleRaysPlain(tables, us[0], us[1],
                                    cuda_trace.tileStrata(N, tile), tile)
  colsT = torch.stack(list(cols) + [torch.full_like(cols[0], 532.)]) \
      .contiguous()
  seeds = iter(range(10 ** 9))

  def run(maxI=6, strataTile=tile, mode='a'):
    inputs = (dict(seed=next(seeds), strataTile=strataTile) if mode == 'a'
              else dict(uniforms=us, strataTile=strataTile) if mode == 'b'
              else dict(columns=colsT))
    return cuda_trace.traceHistogram(tables, hist, N, maxI, 1000., 1e-4,
                                     hitSlots=1, **inputs)

  def record(name, **kw):
    ms = cudaMs(lambda: run(**kw))
    c = run(**kw).tolist()
    print(json.dumps(dict(variant=name, ms=ms, segments=c[0], hits=c[1],
                          **kw)), flush=True)

  for rep in range(2):
    for maxI in (1, 2, 3, 4, 6):
      record(f'bounces{maxI}/rep{rep}', maxI=maxI)
  for order in (('on', 'off'), ('off', 'on')):
    for s in order:
      record(f'strata-{s}', strataTile=tile if s == 'on' else 0)
  for rep in range(2):
    for mode in 'abc':
      record(f'mode-{mode}/rep{rep}', mode=mode)

  # output modes on the main-path scene, A B C C B A
  def runOut(out, tab, n, maxI, slots):
    kwOut = dict(hitSlots=slots, seed=next(seeds), strataTile=tile)
    if out == 'hist':
      return cuda_trace.traceHistogram(tab, runOut.hist, n, maxI, 1000., 1e-4,
                                       **kwOut)
    fn = cuda_trace.traceBins if out == 'bins' else cuda_trace.traceRaw
    return fn(tab, n, maxI, 1000., 1e-4, **kwOut)[1]

  runOut.hist = hist
  for out in ('hist', 'bins', 'raw', 'raw', 'bins', 'hist'):
    ms = cudaMs(lambda: runOut(out, tables, N, 6, 1))
    c = runOut(out, tables, N, 6, 1).tolist()
    print(json.dumps(dict(variant=f'output-{out}', scene='lensMirror', ms=ms,
                          hitSlots=1, segments=c[0], hits=c[1],
                          overflow=c[2])), flush=True)

  # ring depth on the stacked-detector scene (four passes per ray)
  stacked, sBounds, sMaxI = helpers.buildStackedDetectorScene(
      helpers.torchNs())
  stackedNp, sInfo = stacked.compile(device=None)
  sSpec = fused.makeHistogramSpec(stackedNp, sInfo, bounds=sBounds, bins=BINS)
  sTables = cuda_trace.buildTraceTables(
      stackedNp, sSpec, samplerSpec=stacked.lightSources()[0].samplerSpec(),
      device=dev)
  runOut.hist = fused.initHistograms(sSpec, device=dev)
  for rep in range(2):
    for slots in (1, 2, 4):
      for out in ('hist', 'bins', 'raw'):
        ms = cudaMs(lambda: runOut(out, sTables, N, sMaxI, slots))
        c = runOut(out, sTables, N, sMaxI, slots).tolist()
        print(json.dumps(dict(variant=f'stacked-{out}-{slots}slots/rep{rep}',
                              scene='stacked', ms=ms, hitSlots=slots,
                              segments=c[0], hits=c[1], overflow=c[2])),
              flush=True)
  runOut.hist = hist

  # record compaction + fetch of one full-width raw step, piece by piece
  # (the pieces of simulation.runner.compactRecordsToHits, and what its
  # split by element would cost with numpy on the host instead)
  ring, c = cuda_trace.traceRaw(tables, N, 6, 1000., 1e-4, hitSlots=1,
                                seed=next(seeds), strataTile=tile)
  keys = ('point', 'direction', 'power', 'isEntering')
  for rep in range(2):
    records = cuda_trace.recordsFromRing(ring)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    records = cuda_trace.recordsFromRing(ring)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    idx = torch.nonzero(records['recordHit'].reshape(-1)).reshape(-1)
    elem = records['hitElem'].reshape(-1).index_select(0, idx)
    present = torch.unique(elem).tolist()
    sel = idx[elem == present[0]]
    taken = {k: records[k].reshape((N,) + tuple(records[k].shape[2:]))
             .index_select(0, sel) for k in keys}
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    host = {k: v.cpu().numpy() for k, v in taken.items()}
    t3 = time.perf_counter()
    m = elem.cpu().numpy() == present[0]
    split = {k: v[m] for k, v in host.items()}
    t4 = time.perf_counter()
    pinned = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
              for k, v in taken.items()}
    torch.cuda.synchronize()
    t5 = time.perf_counter()
    for k, v in taken.items():
      pinned[k].copy_(v, non_blocking=True)
    torch.cuda.synchronize()
    t6 = time.perf_counter()
    print(json.dumps(dict(
        variant=f'compaction/rep{rep}', rows=int(sel.numel()),
        elements=present, bytes=sum(v.nbytes for v in host.values()),
        recordsFromRingMs=(t1 - t0) * 1e3, deviceSplitGatherMs=(t2 - t1) * 1e3,
        copyToPageableMs=(t3 - t2) * 1e3,
        hostSplitInsteadMs=(t4 - t3) * 1e3,
        pinnedAllocMs=(t5 - t4) * 1e3, copyToPinnedMs=(t6 - t5) * 1e3,
        kept=int(len(split['power'])))), flush=True)

  # contraction on against the shipped build, and both against the plain
  # version on the same uniforms
  kw = dict(maxIntersections=6, maxRayLength=1000., distTol=1e-4,
            powerTol=1e-6, hitSlots=1)
  hP = fused.initHistograms(histSpec, device=dev)
  cP = cuda_trace.traceHistogramPlain(tables, hP, cols, **kw)
  shipped = _build.NVCC_FLAGS
  contracted = tuple(f for f in shipped if f != '-fmad=false')
  for flags, label in ((shipped, 'fmad-off'), (contracted, 'fmad-on'),
                       (contracted, 'fmad-on'), (shipped, 'fmad-off')):
    _build.NVCC_FLAGS = flags
    try:
      ms = cudaMs(lambda: run(mode='b'))
      hK = fused.initHistograms(histSpec, device=dev)
      cK = cuda_trace.traceHistogram(tables, hK, N, uniforms=us,
                                     strataTile=tile, **kw)
      row = dict(variant=label, ms=ms, counters=cK.tolist(),
                 plainCounters=cP.tolist(),
                 movedRays=float((hK['counts'] - hP['counts']).abs().sum())
                 / 2)
    finally:
      _build.NVCC_FLAGS = shipped
    print(json.dumps(row), flush=True)

  sweepBreakdown(dev)
  spectrometerBreakdown(dev)


if __name__ == '__main__':
  main()
