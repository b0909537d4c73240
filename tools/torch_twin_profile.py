#!/usr/bin/env python3
'''Where one step of the fused step's twin spends its time, on one NVIDIA
GPU:

    python3 tools/torch_twin_profile.py [RAYS]

The twin (`tracing/fused.makeFusedStep`: the source's device generator, then
`batch_tracer.bounceBatch` a bounce and one `index_add_` a histogram, plain
PyTorch) on the lens-and-mirror scene at RAYS rays (1 << 20), 6 bounces,
128 x 128 bins. Prints, one JSON object a line:

  * `step`: ms per step by CUDA events (3 warm steps, then 10), the bounces
    a step runs, segments per second;
  * `profile`: one step under `torch.profiler`: the summed time of its
    kernels against the step's time without the profiler (the device's
    busy share) and the profiled wall time, the kernel launches a bounce,
    and the host's time in the per-bounce read of `alive.any()`
    (`aten::is_nonzero` / `aten::item`, which wait for the device);
  * `ops`: the top 15 operators by device time (calls, device ms, host ms);
  * `grating`: the grating formulas of `bounceBatch`
    (`batch_tracer._gratingDirections`) timed alone on RAYS rays, against
    one bounce of the scene timed alone with them (its element types
    marked as gratings) and without them (as the scene is: a bounce skips
    them where no element is a grating), with their share.

Exits non-zero without a CUDA device. Prints the card's name and power
limit.'''

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from optics_design_workbench_tpu_torch import benchmarks
from optics_design_workbench_tpu_torch.tracing import batch_tracer
from optics_design_workbench_tpu_torch.tracing.element_table import GRATING

MAX_I, MAX_L, DIST_TOL = 6, 1000., 1e-4


def cudaMs(fn, reps):
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  torch.cuda.synchronize()
  start.record()
  for _ in range(reps):
    fn()
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / reps


def emit(obj):
  print(json.dumps(obj), flush=True)


def main():
  if not torch.cuda.is_available():
    sys.exit('torch_twin_profile.py needs a CUDA device')
  smi = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, check=True).stdout.strip()
  dev = torch.device('cuda')
  rays = int(sys.argv[1]) if len(sys.argv) > 1 else 1 << 20
  step, hist, meta = benchmarks.makeBenchStep(
      raysPerStep=rays, maxIntersections=MAX_I, useKernel=False, device=dev)
  assert meta['backend'] == 'tracer'
  out = {}

  def run():
    out['c'] = step(7, hist)[1]

  for _ in range(3):
    run()
  ms = cudaMs(run, 10)
  bounces = []
  bounce = batch_tracer.bounceBatch

  def counted(*args, **kwargs):
    bounces.append(1)
    return bounce(*args, **kwargs)

  batch_tracer.bounceBatch = counted
  try:
    run()
  finally:
    batch_tracer.bounceBatch = bounce
  nBounces = len(bounces)
  segments = int(out['c']['segments'])
  emit(dict(part='step', scene='lensMirror', rays=rays, ms=ms,
            bounces=nBounces, segments=segments,
            segmentsPerSecond=segments / (ms / 1e3),
            raysPerSecond=rays / (ms / 1e3)))

  from torch.profiler import ProfilerActivity, profile
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
      as prof:
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wallMs = (time.perf_counter() - t0) * 1e3
  events = prof.key_averages()
  devKey = ('self_device_time_total'
            if hasattr(events[0], 'self_device_time_total')
            else 'self_cuda_time_total')
  kernels = [e for e in prof.events()
             if getattr(e, 'device_type', None) is not None
             and str(e.device_type).endswith('CUDA')]
  deviceMs = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
  syncNames = ('aten::is_nonzero', 'aten::item', 'aten::_local_scalar_dense')
  syncMs = sum(e.cpu_time_total for e in events if e.key in syncNames) / 1e3
  syncCalls = max((e.count for e in events if e.key == 'aten::is_nonzero'),
                  default=0)
  emit(dict(part='profile', profiledWallMs=wallMs, deviceMs=deviceMs,
            deviceBusyShare=deviceMs / ms, kernelLaunches=len(kernels),
            launchesPerBounce=len(kernels) / max(nBounces, 1),
            aliveReads=syncCalls, aliveReadHostMs=syncMs,
            aliveReadHostMsPerBounce=syncMs / max(nBounces, 1)))
  top = sorted(events, key=lambda e: -getattr(e, devKey))[:15]
  emit(dict(part='ops', top=[dict(
      name=e.key, calls=e.count, deviceMs=getattr(e, devKey) / 1e3,
      hostMs=e.self_cpu_time_total / 1e3) for e in top]))

  # the grating formulas alone, against one bounce alone, at `rays` rays
  scene = step.scene
  g = torch.Generator(device=dev)
  g.manual_seed(3)
  cols, _meta = meta['scene'].lightSources()[0].deviceGenerator(dev)(g, rays)
  o = torch.stack([cols['ox'], cols['oy'], cols['oz']], -1)
  d = torch.stack([cols['dx'], cols['dy'], cols['dz']], -1)
  state = (o, d, cols['pw'], cols['wl'],
           torch.full((rays,), -1, dtype=torch.int64, device=dev),
           torch.zeros(rays, dtype=torch.int64, device=dev),
           torch.ones(rays, dtype=torch.bool, device=dev))
  types = scene['elements']['_hostOptType']
  assert not (types == GRATING).any()
  marked = dict(scene, elements=dict(scene['elements'],
                                     _hostOptType=np.full_like(types, GRATING)))
  bounceMs = cudaMs(lambda: bounce(marked, DIST_TOL, MAX_L, *state), 10)
  skippedMs = cudaMs(lambda: bounce(scene, DIST_TOL, MAX_L, *state), 10)
  unit = lambda v: v / v.norm(dim=0, keepdim=True)
  dd = unit(torch.randn((3, rays), generator=g, device=dev))
  nn = unit(torch.randn((3, rays), generator=g, device=dev))
  f = lambda x: torch.full((rays,), x, device=dev)
  flip = torch.rand(rays, generator=g, device=dev) < 0.5
  args = (flip, ~flip, f(1.), f(1.5), *nn, *dd, f(0.), f(0.), f(1.),
          cols['wl'], f(600.), f(1.), *dd)
  gratMs = cudaMs(lambda: batch_tracer._gratingDirections(*args), 10)
  emit(dict(part='grating', rays=rays, bounceMs=bounceMs,
            bounceWithoutGratingMs=skippedMs, gratingMs=gratMs,
            share=gratMs / bounceMs))
  print(smi, flush=True)


if __name__ == '__main__':
  main()
