#!/usr/bin/env python3
'''Smoke run of the PyTorch / CUDA port on one NVIDIA GPU:

    python3 chip_smoke.py

builds the CUDA kernels from the sources in this checkout (one nvcc per
source, in parallel) and holds each against its plain PyTorch version on the
card: the in-kernel-histogram kernel in all three input modes, the
per-ray-bin and raw-record kernels in modes (b) and (c) on scenes with one,
two and four live ring slots and with a ring that overflows, the sweep
kernel on a surface sweep and a source-placement sweep and, in seed mode,
against one launch of the histogram kernel per variant. It then drives the
port's paths at full width:

  * the fused step (`benchmarks.makeBenchStep()`: 1 << 22 rays, 6 bounces,
    128 x 128 bins) for a few timed steps, with in-kernel binning and with
    histPrecision='highest' (per-ray-bin kernel + float64 binning outside);
  * the recording run: `makeRawStep` at 1 << 22 rays with its compaction
    and fetch, `simulation.runSimulation(scene, 'true')` with raw recording
    (4 iterations of 1 << 20 rays, hits written and read back) and with
    histogram-first recording (32 iterations of 1 << 22 rays);
  * the parameter sweep on the examples/3 lens scene:
    `ParameterSweeper.evaluateBatched` at 11 radii x 200,000 rays and at
    64 radii x 1 << 20 rays (one launch of the sweep kernel per call, beside
    the same work as one histogram-kernel launch per variant), and
    `optimize` through `runSimulation` and `RawFolder.loadHits`;

(the first three on the lens-and-mirror scene) and checks the physics of
what comes out. Every failing phase raises, so the exit code is non-zero and no result line is printed. Needs one CUDA device;
exits non-zero without one. Prints one JSON object per phase; the last line
is `{"ok": true, "device": {...}}`.
'''

import glob
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, 'tests'))

import torch_port_helpers as helpers          # the check scenes (imports no jax)
from optics_design_workbench_tpu_torch import _build, benchmarks, simulation
from optics_design_workbench_tpu_torch.jupyter_utils import (
    RawFolder, parameter_sweeper)
from optics_design_workbench_tpu_torch.ops import cuda_trace
from optics_design_workbench_tpu_torch.simulation import results_store, runner
from optics_design_workbench_tpu_torch.tracing import fused

DEV = torch.device('cuda')
N_MAIN = 1 << 22
N_SMALL = 1 << 18
N_RAW_ITERATION = 1 << 20   # rays per iteration of the raw recording run
RAW_ITERATIONS = 4
HIST_ITERATIONS = 32
BINS = (128, 128)
WARM_STEPS, TIMED_STEPS = 3, 20
COUNT_BUDGET = 2          # rays allowed to cross a bin edge (ulp-level)
POWER_RTOL = 1e-4         # float32 atomics add in a run-to-run order
MARGINAL_L1 = 0.02        # mode (a): independent draws, 4M rays
RAW_ATOL = 1e-4           # mm / unit power: the reference's own raw-row test
# the parameter sweep: the reference's own configuration of it (11 lens
# radii x 200,000 rays) and the size of a design study on this card
SWEEPS = ((11, 200_000), (64, 1 << 20))
SWEEP_BINS = (64, 64)
SWEEP_BOUNDS = (-40., 40., -40., 40.)
SWEEP_MAX_INTERSECTIONS = 6

# Peak rates of one H100 SXM (NVIDIA data sheet): float32 outside the
# tensor cores, device memory.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# float32 operations per call of the kernel's pieces, counted from
# csrc/trace_kernel.cu (a multiply, add, compare, select, sqrt, divide or
# rsqrt counts as one): ray into the surface frame 33, then per kind the
# root / trim tests; 6 for the two argmin trackers.
FLOPS_INTERSECT = {0: 33 + 12 + 6, 1: 33 + 42 + 6, 2: 33 + 35 + 6}
FLOPS_WINNER = 52         # hit point, local point, normal, world normal
FLOPS_PHYSICS = 80        # Beer-Lambert, mirror, Snell / TIR, record, update
FLOPS_SAMPLER = 160       # Philox rounds, two marginals, sin / cos, placement


def emit(obj):
  print(json.dumps(obj), flush=True)


def cudaMs(fn, reps):
  '''Mean milliseconds of fn() over `reps` calls, by CUDA events.'''
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  torch.cuda.synchronize()
  start.record()
  for _ in range(reps):
    fn()
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / reps


def buildTables(scene, bounds, bins, tent=False):
  '''Kernel tables of a scene; tent=True swaps the sampler's first marginal
  for the source's 257-knot tent table (the kernel's third marginal kind,
  which no source's own spec selects).'''
  sceneNp, info = scene.compile(device=None)
  histSpec = fused.makeHistogramSpec(sceneNp, info, bounds=bounds, bins=bins)
  src = scene.lightSources()[0]
  spec = src.samplerSpec()
  assert spec is not None, 'scene source has no in-kernel sampler spec'
  if tent:
    drawTables = src._getDeviceTables()
    knots = drawTables['tables'][drawTables['order'][0]]['invCdfSmall']
    spec = dict(spec, first=('table', tuple(float(v) for v in knots)))
  tables = cuda_trace.buildTraceTables(sceneNp, histSpec, samplerSpec=spec,
                                       device=DEV)
  return sceneNp, histSpec, tables


def compareWithPlain(label, scene, bounds, maxI, n, bins, hitSlots=None,
                     tent=False):
  '''Kernel vs plain version on the card, modes (b) and (c), same inputs:
  counters equal, count bins within COUNT_BUDGET rays, power POWER_RTOL.'''
  sceneNp, histSpec, tables = buildTables(scene, bounds, bins, tent=tent)
  if hitSlots is None:
    hitSlots = cuda_trace.autoHitSlots(sceneNp, histSpec, maxI)
  settings = scene.activeSimulationSettings()
  kw = dict(maxIntersections=maxI, maxRayLength=settings.maxRayLength(),
            distTol=1e-4, powerTol=1e-6, hitSlots=hitSlots)
  gen = torch.Generator(device=DEV)
  gen.manual_seed(1234)
  us = torch.rand((2, n), generator=gen, device=DEV, dtype=torch.float32)
  strataTile = cuda_trace.DEFAULT_STRATA_TILE
  strata = cuda_trace.tileStrata(n, strataTile)
  cols = cuda_trace.sampleRaysPlain(tables, us[0], us[1], strata, strataTile)
  colsT = torch.stack(list(cols) + [torch.full_like(cols[0], 532.)]) \
      .contiguous()
  worst = 0.
  for mode, inputs in (('b', dict(uniforms=us, strataTile=strataTile)),
                       ('c', dict(columns=colsT))):
    hK = fused.initHistograms(histSpec, device=DEV)
    cK = cuda_trace.traceHistogram(tables, hK, n, **inputs, **kw)
    torch.cuda.synchronize()
    hP = fused.initHistograms(histSpec, device=DEV)
    cP = cuda_trace.traceHistogramPlain(tables, hP, cols, **kw)
    torch.cuda.synchronize()
    if cK.tolist() != cP.tolist():
      raise AssertionError(f'{label} mode ({mode}): counters differ: kernel '
                           f'{cK.tolist()} plain {cP.tolist()}')
    moved = float((hK['counts'] - hP['counts']).abs().sum())
    if moved > 2 * COUNT_BUDGET:
      raise AssertionError(f'{label} mode ({mode}): {moved / 2} rays changed '
                           f'bins (budget {COUNT_BUDGET})')
    same = (hK['counts'] == hP['counts']) & (hP['counts'] > 0)
    pK, pP = hK['power'][same], hP['power'][same]
    if not torch.allclose(pK, pP, rtol=POWER_RTOL, atol=0.):
      raise AssertionError(f'{label} mode ({mode}): power differs beyond '
                           f'rtol {POWER_RTOL}: '
                           f'{float(((pK - pP).abs() / pP).max())}')
    if int(cK[1]) <= 0:
      raise AssertionError(f'{label} mode ({mode}): no hits recorded')
    err = float((pK - pP).abs().max())
    worst = max(worst, err)
    emit(dict(phase='kernel-vs-plain', scene=label, mode=mode, rays=n,
              counters=cK.tolist(), movedRays=moved / 2, maxAbsErrPower=err,
              hitSlots=hitSlots))
  return worst


def compareRingsWithPlain(label, scene, bounds, maxI, n, bins, hitSlots=None):
  '''The per-ray kernels vs their plain versions on the card, modes (b) and
  (c), same inputs. traceRaw: counters, element, isEntering (hence
  recordHit) equal element for element; power, point, direction within
  RAW_ATOL. traceBins: counters equal, at most COUNT_BUDGET rays in another
  bin, power and count equal where the bin is. Then traceBins + float64
  binning against traceHistogram on the same uniforms: counts equal bin for
  bin, power POWER_RTOL. Returns the worst absolute error per kernel.'''
  sceneNp, histSpec, tables = buildTables(scene, bounds, bins)
  if hitSlots is None:
    hitSlots = cuda_trace.autoHitSlots(sceneNp, histSpec, maxI)
  settings = scene.activeSimulationSettings()
  kw = dict(maxIntersections=maxI, maxRayLength=settings.maxRayLength(),
            distTol=1e-4, powerTol=1e-6, hitSlots=hitSlots)
  gen = torch.Generator(device=DEV)
  gen.manual_seed(4321)
  us = torch.rand((2, n), generator=gen, device=DEV, dtype=torch.float32)
  strataTile = cuda_trace.DEFAULT_STRATA_TILE
  strata = cuda_trace.tileStrata(n, strataTile)
  cols = cuda_trace.sampleRaysPlain(tables, us[0], us[1], strata, strataTile)
  colsT = torch.stack(list(cols) + [torch.full_like(cols[0], 532.)]) \
      .contiguous()
  rawP, cRawP = cuda_trace.traceRawPlain(tables, cols, **kw)
  binsP, cBinsP = cuda_trace.traceBinsPlain(tables, cols, **kw)
  worst = dict(traceRaw=0., traceBins=0.)
  for mode, inputs in (('b', dict(uniforms=us, strataTile=strataTile)),
                       ('c', dict(columns=colsT))):
    rawK, cRawK = cuda_trace.traceRaw(tables, n, **inputs, **kw)
    binsK, cBinsK = cuda_trace.traceBins(tables, n, **inputs, **kw)
    torch.cuda.synchronize()
    for name, cK, cP in (('traceRaw', cRawK, cRawP),
                         ('traceBins', cBinsK, cBinsP)):
      if cK.tolist() != cP.tolist():
        raise AssertionError(f'{label} {name} mode ({mode}): counters '
                             f'differ: kernel {cK.tolist()} plain '
                             f'{cP.tolist()}')
    if int(cRawK[1]) <= 0 or int(cBinsK[1]) <= 0:
      raise AssertionError(f'{label} mode ({mode}): no hits recorded')
    for row, what in ((0, 'element'), (2, 'isEntering')):
      if not torch.equal(rawK[row], rawP[row]):
        raise AssertionError(f'{label} traceRaw mode ({mode}): {what} '
                             f'differs from the plain version')
    errRaw = float((rawK - rawP).abs().max())
    if not errRaw <= RAW_ATOL:
      raise AssertionError(f'{label} traceRaw mode ({mode}): records differ '
                           f'by {errRaw} (atol {RAW_ATOL})')
    sameBin = binsK[0] == binsP[0]
    moved = int((~sameBin).sum())
    if moved > COUNT_BUDGET:
      raise AssertionError(f'{label} traceBins mode ({mode}): {moved} rays '
                           f'in another bin (budget {COUNT_BUDGET})')
    errBins = float(((binsK[1:] - binsP[1:]).abs() * sameBin).max())
    if errBins != 0.:
      raise AssertionError(f'{label} traceBins mode ({mode}): power / count '
                           f'differ by {errBins} in equal bins')
    worst['traceRaw'] = max(worst['traceRaw'], errRaw)
    worst['traceBins'] = max(worst['traceBins'], errBins)
    emit(dict(phase='ring-kernels-vs-plain', scene=label, mode=mode, rays=n,
              hitSlots=hitSlots, rawCounters=cRawK.tolist(),
              binsCounters=cBinsK.tolist(), maxAbsErrRaw=errRaw,
              movedRays=moved, maxAbsErrBins=errBins))

  # per-ray bins + float64 binning outside against the in-kernel histogram
  h1 = fused.initHistograms(histSpec, device=DEV)
  c1 = cuda_trace.traceHistogram(tables, h1, n, uniforms=us,
                                 strataTile=strataTile, **kw)
  h2 = fused.initHistograms(histSpec, device=DEV)
  ring, c2 = cuda_trace.traceBins(tables, n, uniforms=us,
                                  strataTile=strataTile, **kw)
  cuda_trace.binRing(h2, ring)
  torch.cuda.synchronize()
  if c1.tolist() != c2.tolist() or not torch.equal(h1['counts'],
                                                   h2['counts']):
    raise AssertionError(f'{label}: traceBins + binRing counts differ from '
                         f'traceHistogram ({c1.tolist()} / {c2.tolist()})')
  if not torch.allclose(h1['power'], h2['power'], rtol=POWER_RTOL, atol=0.):
    raise AssertionError(f'{label}: traceBins + binRing power differs from '
                         f'traceHistogram beyond rtol {POWER_RTOL}')
  emit(dict(phase='bins-vs-histogram', scene=label, rays=n,
            counters=c2.tolist(),
            maxAbsErrPower=float((h1['power'] - h2['power']).abs().max())))
  return worst


def compareSeedMode(scene, bounds, maxI, n, bins):
  '''Mode (a): the kernel's own Philox draws vs the plain version fed torch
  uniforms — independent numbers, so compared by histogram marginals.'''
  sceneNp, histSpec, tables = buildTables(scene, bounds, bins)
  settings = scene.activeSimulationSettings()
  kw = dict(maxIntersections=maxI, maxRayLength=settings.maxRayLength(),
            distTol=1e-4, powerTol=1e-6, hitSlots=1)
  strataTile = cuda_trace.DEFAULT_STRATA_TILE
  hK = fused.initHistograms(histSpec, device=DEV)
  cK = cuda_trace.traceHistogram(tables, hK, n, seed=20261016,
                                 strataTile=strataTile, **kw)
  gen = torch.Generator(device=DEV)
  gen.manual_seed(99)
  us = torch.rand((2, n), generator=gen, device=DEV, dtype=torch.float32)
  cols = cuda_trace.sampleRaysPlain(tables, us[0], us[1],
                                    cuda_trace.tileStrata(n, strataTile),
                                    strataTile)
  hP = fused.initHistograms(histSpec, device=DEV)
  cP = cuda_trace.traceHistogramPlain(tables, hP, cols, **kw)
  torch.cuda.synchronize()
  a, b = hK['counts'][0].cpu().numpy(), hP['counts'][0].cpu().numpy()
  dists = []
  for axis in (0, 1):
    ma, mb = a.sum(axis=axis), b.sum(axis=axis)
    dists.append(float(np.abs(ma / ma.sum() - mb / mb.sum()).sum()))
  relHits = abs(int(cK[1]) - int(cP[1])) / max(int(cP[1]), 1)
  relSegs = abs(int(cK[0]) - int(cP[0])) / max(int(cP[0]), 1)
  emit(dict(phase='kernel-vs-plain', scene='lensMirror', mode='a', rays=n,
            counters=cK.tolist(), plainCounters=cP.tolist(),
            marginalL1=dists))
  if max(dists) > MARGINAL_L1 or relHits > 5e-3 or relSegs > 5e-3:
    raise AssertionError(f'mode (a): marginals {dists}, hits {relHits}, '
                         f'segments {relSegs} off the plain version')


def resetLaunchCounts():
  for name in cuda_trace.launchCounts:
    cuda_trace.launchCounts[name] = 0


def onlyLaunches(**counts):
  '''The launch counts of a run that launched these kernels and no other.'''
  return {**{name: 0 for name in cuda_trace.launchCounts}, **counts}


def boundMs(tables, segmentsPerStep, nRays, outputBytes):
  '''Least time the card could take for one step: (ms by operations, ms by
  bytes), from this run's segment count and the bytes the kernel must move
  (table and counters in, `outputBytes` out).'''
  rows = tables['surfRows']
  if 'nVariants' in tables:            # a sweep: every variant, one structure
    rows = rows[0]
  kinds = [r['kind'] for r in rows]
  flopsPerSegment = (sum(FLOPS_INTERSECT[k] for k in kinds) + FLOPS_WINNER
                     + FLOPS_PHYSICS)
  flops = segmentsPerStep * flopsPerSegment + nRays * FLOPS_SAMPLER
  nbytes = outputBytes + tables['table'].numel() * 4 + 3 * 8
  return (flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3,
          dict(flopsPerSegment=flopsPerSegment, flopsPerStep=flops,
               bytesPerStep=nbytes))


def kernelEntry(name, source, replaces, launches, err, ms, plainMs, bounds):
  boundOps, boundBytes, _ = bounds
  return dict(name=name, route='cuda',
              source=f'optics_design_workbench_tpu_torch/csrc/{source}',
              replaces=f'optics_design_workbench_tpu/ops/pallas_trace.py:'
                       f'{replaces}',
              launches=launches, max_abs_err=err, ms=ms, plain_ms=plainMs,
              bound_ms=max(boundOps, boundBytes),
              bound_by='operations' if boundOps >= boundBytes else 'bytes',
              library_ms=None)


def fusedStepPhase(histPrecision):
  '''The fused step through `benchmarks.makeBenchStep` at full width: a few
  warm steps, TIMED_STEPS timed ones with the launch counts read around
  them, the kernel alone by CUDA events, the plain version at the same
  size, and the physics of the accumulated histogram.'''
  wrapper = 'traceHistogram' if histPrecision == 'default' else 'traceBins'
  step, hist, meta = benchmarks.makeBenchStep(histPrecision=histPrecision)
  assert meta['backend'] == 'cuda'
  for s in range(WARM_STEPS):
    hist, counters = step(s, hist)
  torch.cuda.synchronize()
  hist['power'].zero_()
  hist['counts'].zero_()
  resetLaunchCounts()
  t0 = time.perf_counter()
  allCounters = []
  for s in range(TIMED_STEPS):
    hist, counters = step(1000 + s, hist)
    allCounters.append(counters)
  torch.cuda.synchronize()
  stepMs = (time.perf_counter() - t0) * 1e3 / TIMED_STEPS
  launches = dict(cuda_trace.launchCounts)
  segments = sum(int(c['segments']) for c in allCounters)
  hits = sum(int(c['hits']) for c in allCounters)
  overflow = sum(int(c['hitOverflow']) for c in allCounters)
  if launches != onlyLaunches(**{wrapper: TIMED_STEPS}):
    raise AssertionError(f'{launches} kernel launches for {TIMED_STEPS} '
                         f'steps of histPrecision={histPrecision!r}')

  # the kernel alone (events), and the plain version at the same size
  tables = step.tables
  kw = dict(maxIntersections=6,
            maxRayLength=meta['scene'].activeSimulationSettings()
            .maxRayLength(), distTol=1e-4, powerTol=1e-6, hitSlots=1)
  seeds = iter(range(5000, 5000 + 10 ** 6))
  scratch = fused.initHistograms(meta['histSpec'], device=DEV)
  if histPrecision == 'default':
    kernelMs = cudaMs(lambda: step(next(seeds), scratch), TIMED_STEPS)
  else:
    kernelMs = cudaMs(lambda: cuda_trace.traceBins(
        tables, N_MAIN, seed=next(seeds), strataTile=step.strataTile, **kw),
        TIMED_STEPS)
  gen = torch.Generator(device=DEV)
  gen.manual_seed(7)
  strata = cuda_trace.tileStrata(N_MAIN, step.strataTile)

  def plainStep():
    us = torch.rand((2, N_MAIN), generator=gen, device=DEV,
                    dtype=torch.float32)
    cols = cuda_trace.sampleRaysPlain(tables, us[0], us[1], strata,
                                      step.strataTile)
    if histPrecision == 'default':
      cuda_trace.traceHistogramPlain(tables, scratch, cols, **kw)
    else:
      cuda_trace.traceBinsPlain(tables, cols, **kw)

  plainStep()
  plainMs = cudaMs(plainStep, 2)

  segsPerStep = segments / TIMED_STEPS
  outBytes = (2 * hist['power'].numel() * 4 * 2 if histPrecision == 'default'
              else 3 * step.hitSlots * N_MAIN * 4)
  bounds = boundMs(tables, segsPerStep, N_MAIN, outBytes)
  emit(dict(phase='main-path', histPrecision=histPrecision, rays=N_MAIN,
            maxIntersections=6, bins=BINS, steps=TIMED_STEPS, stepMs=stepMs,
            kernelMs=kernelMs, plainMs=plainMs,
            raySegmentsPerSec=segsPerStep / (stepMs * 1e-3),
            segmentsPerRay=segsPerStep / N_MAIN, hits=hits,
            hitOverflow=overflow, launches=launches[wrapper],
            boundMs=max(bounds[:2]), strataTile=step.strataTile,
            **bounds[2]))

  # physics of the result
  nRays = N_MAIN * TIMED_STEPS
  totalPower = float(hist['power'].double().sum())
  totalCounts = float(hist['counts'].double().sum())
  hitShare = hits / nRays
  segsPerRay = segments / nRays
  meanPower = totalPower / max(totalCounts, 1.)
  emit(dict(phase='physics', histPrecision=histPrecision, hitShare=hitShare,
            segmentsPerRay=segsPerRay, meanDetectedPower=meanPower,
            histCounts=totalCounts))
  if not torch.isfinite(hist['power']).all():
    raise AssertionError('non-finite histogram power')
  if tuple(hist['power'].shape) != (1,) + BINS:
    raise AssertionError(f'histogram shape {tuple(hist["power"].shape)}')
  if totalCounts != hits:
    raise AssertionError(f'histogram counts {totalCounts} != hits {hits}')
  if hitShare < 0.9 or abs(segsPerRay - 4.) > 0.1 or overflow != 0:
    raise AssertionError(f'hit share {hitShare}, segments/ray {segsPerRay}, '
                         f'overflow {overflow}')
  if abs(meanPower - 0.98) > 1e-3:
    raise AssertionError(f'mean detected power {meanPower}, expected the '
                         f"fold mirror's reflectivity 0.98")
  return dict(launches=launches[wrapper], kernelMs=kernelMs, plainMs=plainMs,
              bounds=bounds)


def timedRun(scene, **kwargs):
  '''runSimulation with the host clock read at start, at every progress
  callback and at the end. Returns (runPath, progress dicts, seconds of
  set-up + first pass, of the later passes, of the clean-up).'''
  progress, stamps = [], []

  def onProgress(p):
    torch.cuda.synchronize()
    progress.append(p)
    stamps.append(time.perf_counter())

  t0 = time.perf_counter()
  runPath = simulation.runSimulation(scene, 'true', seed=20261016,
                                     progressCallback=onProgress, **kwargs)
  t1 = time.perf_counter()
  return runPath, progress, (stamps[0] - t0, stamps[-1] - stamps[0],
                             t1 - stamps[-1])


def recordingRunPhases(tmp):
  '''The recording run at full width on the lens-and-mirror scene.'''
  # ---- (i) the raw step alone: kernel, then kernel + compaction + fetch
  scene = benchmarks.buildLensMirrorScene(tmpdir=tmp)
  settings = scene.activeSimulationSettings()
  sceneNp, info = scene.compile(device=None)
  sceneNp['powerTol'] = 1e-6
  histSpec = fused.makeHistogramSpec(sceneNp, info)
  src = scene.lightSources()[0]
  out = {}
  for n in (N_MAIN, N_RAW_ITERATION):
    step = cuda_trace.makeRawStep(
        sceneNp, histSpec, src.deviceColumnsGenerator(device=DEV),
        raysPerStep=n, maxIntersections=6,
        maxRayLength=settings.maxRayLength(), distTol=1e-4,
        sampler=src.samplerSpec())
    seeds = iter(range(10 ** 6))
    records, counters = step(next(seeds))
    kernelMs = cudaMs(lambda: cuda_trace.traceRaw(
        step.tables, n, 6, settings.maxRayLength(), 1e-4,
        hitSlots=step.hitSlots, seed=next(seeds),
        strataTile=step.strataTile), TIMED_STEPS)
    stepOnlyMs = cudaMs(lambda: step(next(seeds)), TIMED_STEPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
      records, counters = step(next(seeds))
      hits = runner.compactRecordsToHits(records, {}, info['elementLabels'])
    wholeMs = (time.perf_counter() - t0) * 1e3 / 3
    rows = sum(len(c['points']) for c in hits.values())
    if rows != int(counters['hits']) or list(hits) != ['Detector']:
      raise AssertionError(f'compaction kept {rows} rows of '
                           f'{int(counters["hits"])} hits in {list(hits)}')
    out[n] = dict(kernelMs=kernelMs, segments=int(counters['segments']),
                  hitSlots=step.hitSlots, tables=step.tables)
    emit(dict(phase='raw-step', rays=n, hitSlots=step.hitSlots,
              kernelMs=kernelMs, stepWithRecordsMs=stepOnlyMs,
              kernelCompactFetchMs=wholeMs,
              compactFetchMs=wholeMs - stepOnlyMs, hitRows=rows,
              bytesFetched=rows * 36))

  # ---- (ii) runSimulation with raw recording, hits written and read back
  settings.RaysPerIteration = N_RAW_ITERATION
  settings.EndAfterIterations = RAW_ITERATIONS
  settings.EndAfterRays = 'inf'
  resetLaunchCounts()
  runPath, progress, (first, later, cleanup) = timedRun(scene,
                                                        recording='raw')
  launches = dict(cuda_trace.launchCounts)
  last = progress[-1]
  hits = RawFolder(runPath).loadHits('Detector')
  rows = len(hits['points'])
  traced = last['totalTracedRays']
  meanPower = float(hits['powers'].astype(np.float64).mean())
  fileBytes = sum(os.path.getsize(f) for f in glob.glob(
      os.path.join(runPath, 'source-*', 'object-*', '*')))
  lc = simulation.Lifecycle(scene.resultsFolderPath())
  perIterationMs = later / (RAW_ITERATIONS - 1) * 1e3
  emit(dict(phase='run-raw', raysPerIteration=N_RAW_ITERATION,
            iterations=last['totalIterations'], tracedRays=traced,
            storedHits=rows, meanPower=meanPower, launches=launches,
            setupAndFirstIterationS=first, laterIterationsS=later,
            cleanupFlushS=cleanup, perIterationMs=perIterationMs,
            traceMsPerIteration=out[N_RAW_ITERATION]['kernelMs'],
            raysPerSecStoredLoop=N_RAW_ITERATION / (perIterationMs * 1e-3),
            raysPerSecStoredWithFlush=traced / (first + later + cleanup),
            fileBytes=fileBytes))
  if launches != onlyLaunches(traceRaw=RAW_ITERATIONS):
    raise AssertionError(f'raw run launched {launches}')
  if traced != N_RAW_ITERATION * RAW_ITERATIONS \
      or rows != last['totalRecordedHits'] or rows < 0.9 * traced:
    raise AssertionError(f'{rows} rows stored, {last}')
  if set(hits) - {'source', 'obj'} != {'points', 'directions', 'powers',
                                       'isEntering'}:
    raise AssertionError(f'stored columns {sorted(hits)}')
  if not np.isfinite(hits['points']).all() \
      or np.abs(hits['points'][:, 0] + 100.).max() > 1e-3:
    raise AssertionError('stored points off the detector plane x = -100')
  if abs(meanPower - 0.98) > 1e-3:
    raise AssertionError(f'mean stored power {meanPower}')
  if lc.isRunning() or lc.isCanceled() or not lc.isFinished():
    raise AssertionError('lifecycle flags not cleared after the raw run')
  rawLaunches = launches['traceRaw']

  # ---- (iii) runSimulation with histogram-first recording
  settings.RaysPerIteration = N_MAIN
  settings.EndAfterIterations = HIST_ITERATIONS
  resetLaunchCounts()
  runPath, progress, (first, later, cleanup) = timedRun(
      scene, recording='histogram', histBins=BINS,
      histBounds=(-60., 60., -60., 60.))
  launches = dict(cuda_trace.launchCounts)
  last = progress[-1]
  snap = results_store.loadHistogramSnapshots(runPath)['Source']['Detector']
  counts = float(snap['counts'].astype(np.float64).sum())
  sample = RawFolder(runPath).loadHits('Detector')
  sampleSteps = sum(1 for p in range(1, len(progress) + 1) if p % 8 == 1)
  emit(dict(phase='run-histogram', raysPerIteration=N_MAIN,
            iterations=last['totalIterations'], passes=len(progress),
            tracedRays=last['totalTracedRays'], histCounts=counts,
            recordedHits=last['totalRecordedHits'],
            rawSampleRows=len(sample['points']), launches=launches,
            setupAndFirstPassS=first, laterPassesS=later,
            cleanupFlushS=cleanup,
            raysPerSec=last['totalTracedRays'] / (first + later + cleanup)))
  if last['totalIterations'] != HIST_ITERATIONS \
      or last['totalTracedRays'] != HIST_ITERATIONS * N_MAIN:
    raise AssertionError(f'histogram run ended at {last}')
  if counts != last['totalRecordedHits'] or counts < 0.9 * HIST_ITERATIONS \
      * N_MAIN:
    raise AssertionError(f'snapshot counts {counts}, run counted '
                         f'{last["totalRecordedHits"]}')
  if not 0 < len(sample['points']) <= 8192 * sampleSteps:
    raise AssertionError(f'raw sample holds {len(sample["points"])} rows')
  if launches != onlyLaunches(traceHistogram=HIST_ITERATIONS,
                              traceRaw=sampleSteps):
    raise AssertionError(f'histogram run launched {launches}, expected '
                         f'{HIST_ITERATIONS} steps + {sampleSteps} samples')
  return rawLaunches, out[N_MAIN]


def compareSweepWithPlain(label, scenes, bounds, maxI, n, columnsToo):
  '''The sweep kernel vs its plain version on the card, same uniforms (and,
  where the source is the same in every variant, the same ray columns):
  per-variant counters equal, at most COUNT_BUDGET rays per variant in
  another bin, power POWER_RTOL. Returns the worst absolute power error.'''
  host = [sc.compile(device=None) for sc in scenes]
  histSpec = fused.makeHistogramSpec(*host[0], bounds=bounds, bins=SWEEP_BINS)
  specs = [sc.lightSources()[0].samplerSpec() for sc in scenes]
  tables = cuda_trace.buildSweepTables([h for h, _i in host], histSpec, specs,
                                       device=DEV)
  hitSlots = cuda_trace.autoHitSlots(host[0][0], histSpec, maxI)
  kw = dict(maxIntersections=maxI, maxRayLength=1000., distTol=1e-4,
            powerTol=1e-6, hitSlots=hitSlots)
  gen = torch.Generator(device=DEV)
  gen.manual_seed(2468)
  us = torch.rand((2, n), generator=gen, device=DEV, dtype=torch.float32)
  strataTile = cuda_trace.DEFAULT_STRATA_TILE
  strata = cuda_trace.tileStrata(n, strataTile)
  modes = [('b', dict(uniforms=us, strataTile=strataTile),
            dict(uniforms=us, strata=strata, strataTile=strataTile))]
  if columnsToo:
    cols = cuda_trace.sampleRaysPlain(cuda_trace.variantTables(tables, 0),
                                      us[0], us[1], strata, strataTile)
    colsT = torch.stack(list(cols) + [torch.full_like(cols[0], 532.)]) \
        .contiguous()
    modes.append(('c', dict(columns=colsT), dict(columns=colsT)))
  return max(holdSweepAgainstPlain(label, mode, tables, n, inputs,
                                   plainInputs, kw)[0]
             for mode, inputs, plainInputs in modes)


def holdSweepAgainstPlain(label, mode, tables, n, inputs, plainInputs, kw):
  '''One launch of the sweep kernel and one run of its plain version on the
  same inputs, each into fresh histograms; raises where they disagree.
  Returns (worst absolute power error, the plain version's ms).'''
  V = tables['nVariants']
  shape = (V, tables['nDet']) + tuple(tables['bins'])
  hK = dict(power=torch.zeros(shape, device=DEV),
            counts=torch.zeros(shape, device=DEV))
  hP = dict(power=torch.zeros(shape, device=DEV),
            counts=torch.zeros(shape, device=DEV))
  cK = cuda_trace.traceSweep(tables, hK, n, **inputs, **kw)
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  cP = cuda_trace.traceSweepPlain(tables, hP, n, **plainInputs, **kw)
  torch.cuda.synchronize()
  plainMs = (time.perf_counter() - t0) * 1e3
  if cK.tolist() != cP.tolist():
    raise AssertionError(f'{label} sweep mode ({mode}): counters differ: '
                         f'kernel {cK.tolist()} plain {cP.tolist()}')
  moved = (hK['counts'] - hP['counts']).abs().sum(dim=(1, 2, 3)) / 2
  if float(moved.max()) > COUNT_BUDGET:
    raise AssertionError(f'{label} sweep mode ({mode}): {moved.tolist()} '
                         f'rays per variant changed bins (budget '
                         f'{COUNT_BUDGET})')
  same = (hK['counts'] == hP['counts']) & (hP['counts'] > 0)
  pK, pP = hK['power'][same], hP['power'][same]
  if not torch.allclose(pK, pP, rtol=POWER_RTOL, atol=0.):
    raise AssertionError(f'{label} sweep mode ({mode}): power differs '
                         f'beyond rtol {POWER_RTOL}')
  if int(cK[:, 1].min()) <= 0:
    raise AssertionError(f'{label} sweep mode ({mode}): a variant recorded '
                         f'no hits')
  if torch.equal(hK['counts'][0], hK['counts'][1]):
    raise AssertionError(f'{label} sweep mode ({mode}): variants 0 and 1 '
                         f'gave the same histogram')
  err = float((pK - pP).abs().max())
  emit(dict(phase='sweep-vs-plain', sweep=label, mode=mode, variants=V,
            raysPerVariant=n, counterTotals=cK.sum(dim=0).tolist(),
            movedRaysMax=float(moved.max()), maxAbsErrPower=err,
            plainMs=plainMs))
  return err, plainMs


def sweepScenes(radii):
  return [benchmarks.buildSweepLensScene(float(r)) for r in radii]


def sweepStepFor(radii, n):
  '''(step, table, host scenes, sampler spec) of the lens-radius sweep.'''
  scenes = sweepScenes(radii)
  host = [sc.compile(device=None) for sc in scenes]
  spec = scenes[0].lightSources()[0].samplerSpec()
  step, pack = cuda_trace.makeSweepStep(
      host, SWEEP_BOUNDS, SWEEP_BINS, spec, n, SWEEP_MAX_INTERSECTIONS,
      1000., 1e-4, device=DEV)
  return step, pack(host), host, spec


def compareSweepWithSingle(V, n, seed=31):
  '''The sweep kernel in seed mode against V launches of the histogram
  kernel with the same seed and each variant's own table: the same rays, so
  counts equal bin for bin, counters equal, power POWER_RTOL (the atomics
  land in another order).'''
  step, table, host, spec = sweepStepFor(np.linspace(45., 95., V), n)
  power, counts, segments = step(seed, table)
  torch.cuda.synchronize()
  counters = step.counters.tolist()
  worst = 0.
  for v in range(V):
    tables = cuda_trace.buildTraceTables(host[v][0], step.histSpec, spec,
                                         device=DEV)
    hist = fused.initHistograms(step.histSpec, device=DEV)
    c = cuda_trace.traceHistogram(
        tables, hist, n, SWEEP_MAX_INTERSECTIONS, 1000., 1e-4,
        hitSlots=step.hitSlots, seed=seed, strataTile=step.strataTile)
    torch.cuda.synchronize()
    if c.tolist() != counters[v]:
      raise AssertionError(f'sweep variant {v}: counters {counters[v]}, the '
                           f'single-scene kernel {c.tolist()}')
    if not torch.equal(hist['counts'], counts[v]):
      raise AssertionError(f'sweep variant {v}: counts differ from the '
                           f'single-scene kernel')
    if not torch.allclose(hist['power'], power[v], rtol=POWER_RTOL, atol=0.):
      raise AssertionError(f'sweep variant {v}: power differs from the '
                           f'single-scene kernel beyond rtol {POWER_RTOL}')
    worst = max(worst, float((hist['power'] - power[v]).abs().max()))
  if int(segments) != sum(c[0] for c in counters):
    raise AssertionError('the step\'s segment total is not the counters\'')
  emit(dict(phase='sweep-vs-single', variants=V, raysPerVariant=n, seed=seed,
            strataTile=step.strataTile, segments=int(segments),
            hits=sum(c[1] for c in counters), maxAbsErrPower=worst))


def sweepPathPhase(V, n):
  '''`evaluateBatched` on the lens-radius sweep, three calls with shifted
  radii (nothing can be cached by value): wall time cold and steady, the
  sweep kernel alone by CUDA events, and the same work as one launch of the
  histogram kernel per variant, timed the same way.'''
  sweeper, holder = benchmarks.makeSweepLensSweeper()
  radii = np.linspace(45., 95., V)
  totals = []

  def metric(power, counts):
    totals.append(float(counts.sum()))
    return helpers.spotMetric(power, counts)

  def call(k, route):
    sets = [dict(R=float(r + 0.3 * k)) for r in radii]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # 'loop' is the sweeper's per-variant route: the same host work with V
    # launches, V table uploads and V fetches
    hists = sweeper._batchedHistograms(
        sets, lambda: holder['scene'], n, SWEEP_MAX_INTERSECTIONS,
        SWEEP_BINS, SWEEP_BOUNDS, k, sweepKernel=(route == 'sweep'))
    m = np.array([metric(p, c) for p, c in hists])
    torch.cuda.synchronize()
    return m, time.perf_counter() - t0

  resetLaunchCounts()
  metrics, coldS = call(0, 'sweep')
  steady = [call(k, 'sweep')[1] for k in (1, 2)]
  launches = dict(cuda_trace.launchCounts)
  if sweeper.lastBatchedRoute != 'sweep' \
      or launches != onlyLaunches(traceSweep=3):
    raise AssertionError(f'{launches} launches for 3 evaluateBatched calls '
                         f'(route {sweeper.lastBatchedRoute})')
  best = float(radii[int(np.argmin(metrics))])
  gridStep = 50. / 10                      # of the 11-radius sweep
  if abs(best - 60.) > gridStep + 1e-9:
    raise AssertionError(f'argmin radius {best}, paraxial optimum 60 mm')
  if min(totals) <= 0.9 * n or not np.all(np.isfinite(metrics)):
    raise AssertionError(f'a variant counted {min(totals)} of {n} rays')
  loopMetrics, _ = call(0, 'loop')
  loop = [call(k, 'loop')[1] for k in (1, 2)]
  if sweeper.lastBatchedRoute != 'perVariant' \
      or dict(cuda_trace.launchCounts) != onlyLaunches(traceSweep=3,
                                                       traceHistogram=3 * V):
    raise AssertionError(f'{dict(cuda_trace.launchCounts)} launches after '
                         f'3 per-variant calls')
  if not np.array_equal(loopMetrics, metrics):
    raise AssertionError('one launch per variant gave other metrics than '
                         'the sweep kernel on the same seed')

  # the kernels alone, by events, on prebuilt tables
  step, table, host, spec = sweepStepFor(radii, n)
  tables = dict(step.facts, table=torch.as_tensor(table, device=DEV))
  shape = (V,) + step.histShape
  hist = dict(power=torch.zeros(shape, device=DEV),
              counts=torch.zeros(shape, device=DEV))
  kw = dict(maxIntersections=SWEEP_MAX_INTERSECTIONS, maxRayLength=1000.,
            distTol=1e-4, powerTol=1e-6, hitSlots=step.hitSlots,
            strataTile=step.strataTile)
  seeds = iter(range(7000, 10 ** 6))
  counters = cuda_trace.traceSweep(tables, hist, n, seed=next(seeds), **kw)
  segments = int(counters[:, 0].sum())
  reps = 20 if V * n < 1 << 24 else 5
  sweepMs = cudaMs(lambda: cuda_trace.traceSweep(
      tables, hist, n, seed=next(seeds), **kw), reps)
  singles = [cuda_trace.buildTraceTables(h, step.histSpec, spec, device=DEV)
             for h, _i in host]
  hists1 = [fused.initHistograms(step.histSpec, device=DEV) for _ in singles]

  def k1Loop():
    seed = next(seeds)
    for t, h in zip(singles, hists1):
      cuda_trace.traceHistogram(t, h, n, seed=seed, **kw)

  k1Loop()
  loopMs = cudaMs(k1Loop, reps)
  sweepMs2 = cudaMs(lambda: cuda_trace.traceSweep(
      tables, hist, n, seed=next(seeds), **kw), reps)
  steadyS, loopS = min(steady), min(loop)
  emit(dict(phase='sweep-path', variants=V, raysPerVariant=n,
            coldS=coldS, steadyS=steadyS, steadyCalls=steady,
            raysPerSec=V * n / steadyS, sweepKernelMs=sweepMs,
            sweepKernelMsAgain=sweepMs2,
            hostShare=1. - sweepMs * 1e-3 / steadyS,
            launchesPerCall=launches['traceSweep'] / 3,
            segmentsPerCall=segments,
            raySegmentsPerSecKernel=segments / (sweepMs * 1e-3),
            bestRadius=best, minCountShare=min(totals) / n,
            perVariantLoopSteadyS=loopS, perVariantLoopCalls=loop,
            perVariantLoopKernelsMs=loopMs,
            sweepOverLoopKernels=sweepMs / loopMs,
            sweepOverLoopWall=steadyS / loopS))

  # the kernel against its plain version at this shape, same uniforms
  gen = torch.Generator(device=DEV)
  gen.manual_seed(9)
  us = torch.rand((2, n), generator=gen, device=DEV, dtype=torch.float32)
  inputs = dict(uniforms=us, strataTile=step.strataTile)
  err, plainMs = holdSweepAgainstPlain(
      f'path-{V}x{n}', 'b', tables, n, inputs,
      dict(inputs, strata=cuda_trace.tileStrata(n, step.strataTile)),
      {k: v for k, v in kw.items() if k != 'strataTile'})
  return dict(launches=launches['traceSweep'], ms=sweepMs, plainMs=plainMs,
              maxAbsErr=err, tables=tables, segments=segments,
              histBytes=2 * hist['power'].numel() * 4)


def sweepOptimizePhase(tmp):
  '''The reference-style loop on the card: `optimize` -> `runSimulation`
  (raw recording, 20,000 rays) -> `RawFolder.loadHits` -> penalty.'''
  sweeper, holder = benchmarks.makeSweepLensSweeper(
      path=os.path.join(tmp, 'example3'))
  runs = []

  def spotSize(raw):
    runs.append(raw)
    return helpers.spotSize(raw)

  resetLaunchCounts()
  t0 = time.perf_counter()
  result = sweeper.optimize(spotSize, ['R'], method='Nelder-Mead',
                            maxIterations=10, seed=1)
  seconds = time.perf_counter() - t0
  launches = dict(cuda_trace.launchCounts)
  history = sweeper.history
  rows = [len(raw.loadHits('Detector')) for raw in runs]
  emit(dict(phase='sweep-optimize', evaluations=len(history),
            seconds=seconds, msPerEvaluation=seconds * 1e3 / len(history),
            firstPenalty=history[0]['penalty'],
            bestPenalty=result.bestPenalty, bestRadius=result.bestParams['R'],
            launches=launches, rowsPerRun=[min(rows), max(rows)]))
  if len(history) < 5 or len(runs) != len(history):
    raise AssertionError(f'{len(history)} evaluations, {len(runs)} runs')
  if any(h['penalty'] >= parameter_sweeper.PENALTY for h in history):
    raise AssertionError('an evaluation failed and was scored as a penalty')
  if not result.bestPenalty <= history[0]['penalty'] \
      or result.bestPenalty >= 1e98:
    raise AssertionError(f'best penalty {result.bestPenalty}, first '
                         f'{history[0]["penalty"]}')
  if min(rows) < 0.9 * 20000 or not all(raw.uid() for raw in runs):
    raise AssertionError(f'run folders hold {rows} rows')
  if launches != onlyLaunches(traceRaw=len(history)):
    raise AssertionError(f'optimize launched {launches}')


def main():
  if not torch.cuda.is_available():
    sys.exit('chip_smoke.py needs a CUDA device: torch.cuda.is_available() '
             'is False')
  smi = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, check=True).stdout.strip() \
      .splitlines()[0]

  # ---- phase 1: the card and the build ----
  _libs, info = _build.buildKernels()
  emit(dict(phase='card', nvidiaSmi=smi, torch=torch.__version__,
            cuda=torch.version.cuda, buildSeconds=info['seconds'],
            buildCached=info['cached'],
            ptxas=[l for l in info['log'].splitlines()
                   if 'registers' in l or 'spill' in l]))

  # ---- phase 2: each kernel against its plain version on the card ----
  ns = helpers.torchNs()
  lens, lensBounds, lensMaxI = helpers.buildBench(ns, 'lensMirror')
  worst = compareWithPlain('lensMirror', lens, lensBounds, lensMaxI, N_MAIN,
                           BINS)
  for name in ('tir', 'absorbing', 'collimated'):
    scene, bounds, maxI = helpers.SCENES_BY_NAME[name](ns)
    worst = max(worst, compareWithPlain(name, scene, bounds, maxI, N_SMALL,
                                        BINS))
  # the ring's overflow rule: one slot where two passes happen
  scene, bounds, maxI = helpers.buildAbsorbingScene(ns)
  worst = max(worst, compareWithPlain('absorbing-1slot', scene, bounds, maxI,
                                      N_SMALL, BINS, hitSlots=1))
  # the tent-table marginal of the sampler
  scene, bounds, maxI = helpers.buildBench(ns, 'sourceDetector')
  worst = max(worst, compareWithPlain('sourceDetector-tent', scene, bounds,
                                      maxI, N_SMALL, BINS, tent=True))
  compareSeedMode(lens, lensBounds, lensMaxI, N_MAIN, BINS)

  # the per-ray kernels: one slot at full width, then two slots, one slot
  # that overflows, and four live slots
  worstRing = compareRingsWithPlain('lensMirror', lens, lensBounds, lensMaxI,
                                    N_MAIN, BINS)
  for label, name, slots in (('absorbing', 'absorbing', None),
                             ('absorbing-1slot', 'absorbing', 1),
                             ('stacked', 'stacked', None)):
    scene, bounds, maxI = helpers.SCENES_BY_NAME[name](ns)
    w = compareRingsWithPlain(label, scene, bounds, maxI, N_SMALL, BINS,
                              hitSlots=slots)
    worstRing = {k: max(v, w[k]) for k, v in worstRing.items()}

  # the sweep kernel: a surface sweep and a source-placement sweep against
  # the plain version, then seed mode against the histogram kernel
  scenes, bounds, maxI = helpers.sweepVariants(ns, 'radius')
  worstSweep = compareSweepWithPlain('radius', scenes, bounds, maxI, N_SMALL,
                                     columnsToo=True)
  scenes, bounds, maxI = helpers.sweepVariants(ns, 'placement')
  worstSweep = max(worstSweep, compareSweepWithPlain(
      'placement', scenes, bounds, maxI, N_SMALL, columnsToo=False))
  compareSweepWithSingle(*SWEEPS[0])

  # ---- phase 3: the fused step, binned in the kernel and outside it ----
  k1 = fusedStepPhase('default')
  k2 = fusedStepPhase('highest')

  # ---- phase 4: the recording run ----
  tmp = tempfile.mkdtemp(prefix='odw_chip_smoke_')
  try:
    rawLaunches, raw = recordingRunPhases(tmp)
    # ---- phase 5: the parameter sweep ----
    for V, n in SWEEPS:
      sweep = sweepPathPhase(V, n)
      worstSweep = max(worstSweep, sweep['maxAbsErr'])
    sweepOptimizePhase(tmp)
  finally:
    shutil.rmtree(tmp, ignore_errors=True)

  # the sweep kernel's bound at the design-study size
  V, n = SWEEPS[-1]
  plainSweepMs = sweep['plainMs']
  sweepBounds = boundMs(sweep['tables'], sweep['segments'], V * n,
                        2 * sweep['histBytes'])
  emit(dict(phase='sweep-kernel-bound', variants=V, raysPerVariant=n,
            kernelMs=sweep['ms'], plainMs=plainSweepMs,
            boundOpsMs=sweepBounds[0], boundBytesMs=sweepBounds[1],
            **sweepBounds[2]))

  # the raw kernel's plain version and bound at the full-width step
  tables = raw['tables']
  gen = torch.Generator(device=DEV)
  gen.manual_seed(8)
  strataTile = cuda_trace.DEFAULT_STRATA_TILE
  strata = cuda_trace.tileStrata(N_MAIN, strataTile)
  kw = dict(maxIntersections=6, maxRayLength=1000., distTol=1e-4,
            powerTol=1e-6, hitSlots=raw['hitSlots'])

  def plainRaw():
    us = torch.rand((2, N_MAIN), generator=gen, device=DEV,
                    dtype=torch.float32)
    cols = cuda_trace.sampleRaysPlain(tables, us[0], us[1], strata,
                                      strataTile)
    cuda_trace.traceRawPlain(tables, cols, **kw)

  plainRaw()
  plainRawMs = cudaMs(plainRaw, 2)
  rawBounds = boundMs(tables, raw['segments'], N_MAIN,
                      9 * raw['hitSlots'] * N_MAIN * 4)
  emit(dict(phase='raw-kernel-bound', rays=N_MAIN, kernelMs=raw['kernelMs'],
            plainMs=plainRawMs, boundOpsMs=rawBounds[0],
            boundBytesMs=rawBounds[1], **rawBounds[2]))

  emit(dict(kernels=[
      kernelEntry('traceHistogram', 'trace_kernel.cu', 2776, k1['launches'],
                  worst, k1['kernelMs'], k1['plainMs'], k1['bounds']),
      kernelEntry('traceRaw', 'trace_raw_kernel.cu', 3226, rawLaunches,
                  worstRing['traceRaw'], raw['kernelMs'], plainRawMs,
                  rawBounds),
      kernelEntry('traceBins', 'trace_bins_kernel.cu', 2789, k2['launches'],
                  worstRing['traceBins'], k2['kernelMs'], k2['plainMs'],
                  k2['bounds']),
      kernelEntry('traceSweep', 'trace_sweep_kernel.cu', 3067,
                  sweep['launches'], worstSweep, sweep['ms'], plainSweepMs,
                  sweepBounds)]))
  print(smi, flush=True)
  print(json.dumps(dict(ok=True, device=dict(
      platform='gpu', kind=torch.cuda.get_device_name(0),
      count=torch.cuda.device_count()))), flush=True)


if __name__ == '__main__':
  main()
