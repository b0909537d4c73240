#!/usr/bin/env python3
'''Smoke run of the PyTorch / CUDA port on one NVIDIA GPU:

    python3 chip_smoke.py

builds the CUDA kernel from the sources in this checkout, holds it against
its plain PyTorch version on the card in all three input modes, drives the
port's main path (`benchmarks.makeBenchStep()` on the lens-and-mirror scene:
1 << 22 rays, 6 bounces, 128 x 128 bins) for a few timed steps, and checks
the physics of what comes out. Every failing phase raises, so the exit code
is non-zero and no result line is printed. Needs one CUDA device; exits
non-zero without one. Prints one JSON object per phase; the last line is
`{"ok": true, "device": {...}}`.
'''

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, 'tests'))

import torch_port_helpers as helpers          # the check scenes (imports no jax)
from optics_design_workbench_tpu_torch import _build, benchmarks
from optics_design_workbench_tpu_torch.ops import cuda_trace
from optics_design_workbench_tpu_torch.tracing import fused

DEV = torch.device('cuda')
N_MAIN = 1 << 22
N_SMALL = 1 << 18
BINS = (128, 128)
WARM_STEPS, TIMED_STEPS = 3, 20
COUNT_BUDGET = 2          # rays allowed to cross a bin edge (ulp-level)
POWER_RTOL = 1e-4         # float32 atomics add in a run-to-run order
MARGINAL_L1 = 0.02        # mode (a): independent draws, 4M rays

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


def main():
  if not torch.cuda.is_available():
    sys.exit('chip_smoke.py needs a CUDA device: torch.cuda.is_available() '
             'is False')
  smi = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, check=True).stdout.strip() \
      .splitlines()[0]

  # ---- phase 1: the card and the build ----
  lib, info = _build.buildKernels()
  emit(dict(phase='card', nvidiaSmi=smi, torch=torch.__version__,
            cuda=torch.version.cuda, buildSeconds=info['seconds'],
            buildCached=info['cached'],
            ptxas=[l for l in info['log'].splitlines()
                   if 'registers' in l or 'spill' in l]))

  # ---- phase 2: kernel against its plain version on the card ----
  ns = helpers.torchNs()
  lens, lensBounds, lensMaxI = helpers.buildBench(ns, 'lensMirror')
  worst = compareWithPlain('lensMirror', lens, lensBounds, lensMaxI, N_MAIN,
                           BINS)
  for name in ('tir', 'absorbing', 'collimated'):
    scene, bounds, maxI = helpers.SCENE_BUILDERS[name](ns)
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

  # ---- phase 3: the main path ----
  step, hist, meta = benchmarks.makeBenchStep()
  assert meta['backend'] == 'cuda'
  for s in range(WARM_STEPS):
    hist, counters = step(s, hist)
  torch.cuda.synchronize()
  hist['power'].zero_()
  hist['counts'].zero_()
  cuda_trace.launchCount = 0
  t0 = time.perf_counter()
  allCounters = []
  for s in range(TIMED_STEPS):
    hist, counters = step(1000 + s, hist)
    allCounters.append(counters)
  torch.cuda.synchronize()
  stepMs = (time.perf_counter() - t0) * 1e3 / TIMED_STEPS
  launches = cuda_trace.launchCount
  segments = sum(int(c['segments']) for c in allCounters)
  hits = sum(int(c['hits']) for c in allCounters)
  overflow = sum(int(c['hitOverflow']) for c in allCounters)
  if launches != TIMED_STEPS:
    raise AssertionError(f'{launches} kernel launches for {TIMED_STEPS} steps')

  # the kernel alone (events), and the plain version at the same size
  seeds = iter(range(5000, 5000 + 10 ** 6))
  scratch = fused.initHistograms(meta['histSpec'], device=DEV)
  kernelMs = cudaMs(lambda: step(next(seeds), scratch), TIMED_STEPS)
  tables = step.tables
  kw = dict(maxIntersections=6,
            maxRayLength=meta['scene'].activeSimulationSettings()
            .maxRayLength(), distTol=1e-4, powerTol=1e-6, hitSlots=1)
  gen = torch.Generator(device=DEV)
  gen.manual_seed(7)
  strata = cuda_trace.tileStrata(N_MAIN, step.strataTile)

  def plainStep():
    us = torch.rand((2, N_MAIN), generator=gen, device=DEV,
                    dtype=torch.float32)
    cols = cuda_trace.sampleRaysPlain(tables, us[0], us[1], strata,
                                      step.strataTile)
    cuda_trace.traceHistogramPlain(tables, scratch, cols, **kw)

  plainStep()
  plainMs = cudaMs(plainStep, 2)

  # least time the card could take for this run's work
  kinds = [r['kind'] for r in tables['surfRows']]
  flopsPerSegment = (sum(FLOPS_INTERSECT[k] for k in kinds) + FLOPS_WINNER
                     + FLOPS_PHYSICS)
  segsPerStep = segments / TIMED_STEPS
  flops = segsPerStep * flopsPerSegment + N_MAIN * FLOPS_SAMPLER
  histBytes = hist['power'].numel() * 4 * 2
  nbytes = 2 * histBytes + tables['table'].numel() * 4 + 3 * 8
  boundOps, boundBytes = flops / PEAK_F32_FLOPS * 1e3, \
      nbytes / PEAK_BYTES * 1e3
  boundMs = max(boundOps, boundBytes)
  emit(dict(phase='main-path', rays=N_MAIN, maxIntersections=6, bins=BINS,
            steps=TIMED_STEPS, stepMs=stepMs, kernelMs=kernelMs,
            plainMs=plainMs, raySegmentsPerSec=segsPerStep / (stepMs * 1e-3),
            segmentsPerRay=segsPerStep / N_MAIN, hits=hits,
            hitOverflow=overflow, launches=launches,
            flopsPerSegment=flopsPerSegment, flopsPerStep=flops,
            bytesPerStep=nbytes, boundMs=boundMs,
            strataTile=step.strataTile))

  # ---- phase 4: physics of the result ----
  nRays = N_MAIN * TIMED_STEPS
  totalPower = float(hist['power'].double().sum())
  totalCounts = float(hist['counts'].double().sum())
  hitShare = hits / nRays
  segsPerRay = segments / nRays
  meanPower = totalPower / max(totalCounts, 1.)
  emit(dict(phase='physics', hitShare=hitShare, segmentsPerRay=segsPerRay,
            meanDetectedPower=meanPower, histCounts=totalCounts))
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

  emit(dict(kernels=[dict(
      name='traceHistogram', route='cuda',
      source='optics_design_workbench_tpu_torch/csrc/trace_kernel.cu',
      replaces='optics_design_workbench_tpu/ops/pallas_trace.py:2776',
      launches=launches, max_abs_err=worst, ms=kernelMs, plain_ms=plainMs,
      bound_ms=boundMs,
      bound_by='operations' if boundOps >= boundBytes else 'bytes',
      library_ms=None)]))
  print(smi, flush=True)
  print(json.dumps(dict(ok=True, device=dict(
      platform='gpu', kind=torch.cuda.get_device_name(0),
      count=torch.cuda.device_count()))), flush=True)


if __name__ == '__main__':
  main()
