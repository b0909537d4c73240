'''
The fused Monte-Carlo path outside the kernels (counterpart of the JAX
package's tracing/fused.py): sampling, the bounce loop of the record tracer
(tracing/batch_tracer.bounceBatch) and the binning of the recording hits in
one step that carries only histograms and counters between steps.

The hand-written kernels take this step where they cover the scene
(ops/cuda_trace.makeTraceStep). This plain PyTorch twin, as the reference's
is plain XLA, takes the scenes `cuda_trace.ineligibleReason` refuses and the
sources the in-kernel sampler cannot draw: histogram-first recording
(simulation/runner.py), `ParameterSweeper.evaluateBatched` and
`benchmarks.makeBenchStep`. The one-hot matrix binning the JAX package uses
on the TPU (ops/histogram.py) stays behind: a bounce's hits are binned by
one `index_add_` per histogram.
'''

import numpy as np
import torch

from .. import hostArray, resolveDevice
from .element_table import VACUUM_MEDIUM


def makeHistogramSpec(scene, info, recordElems=None, bounds=None,
                      bins=(128, 128)):
  '''Build the histogram config: which elements accumulate, one (H, W)
  histogram per recording element, binned over local-frame (x, y) `bounds`
  = (x0, x1, y0, y1) (shared, or dict label->bounds). Host numpy arrays:
  the spec is baked into the kernel's element table.'''
  elemLabels = info['elementLabels']
  recordFlags = hostArray(scene['elements']['recordHits'])
  if recordElems is None:
    recordElems = [i for i in range(len(elemLabels)) if recordFlags[i]]
  elemToDet = np.full(len(elemLabels), -1, dtype=np.int32)
  allBounds = []
  for d, e in enumerate(recordElems):
    elemToDet[e] = d
    b = bounds
    if isinstance(bounds, dict):
      b = bounds.get(elemLabels[e])
    if b is None:
      b = (-50., 50., -50., 50.)
    allBounds.append(b)
  return dict(elemToDet=elemToDet,
              bounds=np.asarray(allBounds, dtype=np.float32).reshape(-1, 4),
              bins=tuple(bins),
              detLabels=[elemLabels[e] for e in recordElems])


def initHistograms(histSpec, dtype=torch.float32, device='cuda'):
  '''Zeroed (D, H, W) power and count histograms on `device`. The trace
  steps accumulate into these tensors IN PLACE (where the JAX step relied
  on buffer donation).'''
  dev = resolveDevice(device)
  D = histSpec['bounds'].shape[0]
  H, W = histSpec['bins']
  return dict(power=torch.zeros((D, H, W), dtype=dtype, device=dev),
              counts=torch.zeros((D, H, W), dtype=dtype, device=dev))


def _binTensors(histSpec, dev):
  '''(elemToDet int64, bounds float32 (D, 4)) of a histogram spec, as
  tensors on `dev` (a spec whose fields are tensors there already costs no
  copy).'''
  return tuple(torch.as_tensor(histSpec[k], dtype=dtype, device=dev)
               for k, dtype in (('elemToDet', torch.int64),
                                ('bounds', torch.float32)))


def _binIndex(f, n):
  '''Bin index of the fractions `f` over `n` bins, clipped to [0, n - 1]
  (the reference's `astype(int32)` then clip; the value of a row outside
  the bounds does not matter, it bins nothing).'''
  f = torch.nan_to_num(f * n, nan=0., posinf=float(n), neginf=-1.)
  return torch.clamp(torch.clamp(f, -1., float(n)).to(torch.int64), 0, n - 1)


def hitBins(records, elemToDet, bounds, bins):
  '''Where a bounce's records bin: (inside, flat), `inside` (N,) bool for
  the recording hits that fall in their detector's bounds (fx, fy in
  [0, 1)), `flat` (N,) int64 their bin in the flattened (D, H, W)
  histogram (any value where not inside). `elemToDet`, `bounds` are
  `_binTensors`'s, `bins` (H, W).'''
  H, W = bins
  det = elemToDet[torch.clamp(records['hitElem'], min=0)]
  d0 = torch.clamp(det, min=0)
  b = bounds[d0]
  fx = (records['plx'] - b[:, 0]) / (b[:, 1] - b[:, 0])
  fy = (records['ply'] - b[:, 2]) / (b[:, 3] - b[:, 2])
  inside = (records['recordHit'] & (records['hitElem'] >= 0) & (det >= 0)
            & (fx >= 0) & (fx < 1) & (fy >= 0) & (fy < 1))
  return inside, (d0 * H + _binIndex(fy, H)) * W + _binIndex(fx, W)


def traceHistogram(scene, histSpec, histograms, origins, directions, powers,
                   wavelengths, maxIntersections, maxRayLength, distTol,
                   generator=None, earlyExit=True):
  '''Trace a batch through the record tracer's bounce and add the recorded
  hits into `histograms` IN PLACE: each bounce bins the hits on a recording
  element at their local (x, y), with fx, fy in [0, 1) of the detector's
  bounds. Returns (histograms, counters), counters 0-d int64 tensors
  `segments`, `hits` (binned), `escaped` (rays dead at the end) and
  `hitOverflow` (always 0: every hit is binned; the kernels' steps count
  the hits their slots dropped there).

  `scene` is a compiled scene or `batch_tracer.prepareScene` of one; the
  rays are (N, 3) / (N,) tensors on the device the trace runs on. A bounce
  runs while some ray is alive (one host read a bounce); earlyExit=False
  runs all `maxIntersections` bounces without reading, with the same
  histograms (a bounce of dead rays bins nothing). Scatter draws come from
  `generator` (seed 0 where the scene scatters and none is given).'''
  from .batch_tracer import bounceBatch, prepareScene
  dev = origins.device
  scene = prepareScene(scene, dev)
  if generator is None and 'scatter' in scene:
    generator = torch.Generator(device=dev)
    generator.manual_seed(0)
  elemToDet, bounds = _binTensors(histSpec, dev)
  N = origins.shape[0]
  f32 = lambda x: x.to(device=dev, dtype=torch.float32)
  state = (f32(origins), f32(directions), f32(powers), f32(wavelengths),
           torch.full((N,), VACUUM_MEDIUM, dtype=torch.int64, device=dev),
           torch.zeros((N,), dtype=torch.int64, device=dev),
           torch.ones((N,), dtype=torch.bool, device=dev))
  power = histograms['power'].view(-1)
  counts = histograms['counts'].view(-1)
  segments = torch.zeros((), dtype=torch.int64, device=dev)
  hits = torch.zeros((), dtype=torch.int64, device=dev)
  for _ in range(int(maxIntersections)):
    if earlyExit and not bool(state[6].any()):
      break
    state, rec = bounceBatch(scene, distTol, maxRayLength, *state,
                             generator=generator)
    inside, flat = hitBins(rec, elemToDet, bounds, histSpec['bins'])
    zero = torch.zeros_like(rec['power'])
    power.index_add_(0, flat, torch.where(inside, rec['power'], zero)
                     .to(power.dtype))
    counts.index_add_(0, flat, inside.to(counts.dtype))
    segments += rec['segValid'].sum()
    hits += inside.sum()
  return histograms, dict(segments=segments, hits=hits,
                          escaped=(~state[6]).sum(),
                          hitOverflow=torch.zeros_like(hits))


def makeFusedStep(scene, generator, histSpec, raysPerStep, maxIntersections,
                  maxRayLength, distTol, stratified=False, chunkLimit=1 << 26,
                  device='cuda'):
  '''Compose sampling + trace + binning into one step
  `step(seed, histograms) -> (histograms, counters)`, the call of
  `cuda_trace.makeTraceStep`'s step: `seed` is a python int or a
  torch.Generator on `device`, `histograms` (`initHistograms`) are added
  to IN PLACE, counters are `traceHistogram`'s.

  `scene` is the compiled host scene (with the source's `surfMask` and the
  run's `powerTol`); `generator(torchGenerator, N, stratified=)` draws the
  rays on `device`: a source's `deviceGenerator(device)` ((columns,
  metadata)) or `deviceColumnsGenerator(device)` (columns). Where surfaces
  x rays exceeds `chunkLimit` the rays are traced in 2, 4, ... chunks of the
  one draw, into the same histograms; that bounds the bounce's (N,)
  temporaries (the sweep bounds its own (S, N) ones), and without scatter
  the histograms do not depend on the split. Scatter draws follow the ray
  draws on the same generator.'''
  from .batch_tracer import prepareScene
  dev = resolveDevice(device)
  prepared = prepareScene(scene, dev)
  elemToDet, bounds = _binTensors(histSpec, dev)
  spec = dict(histSpec, elemToDet=elemToDet, bounds=bounds)
  nSurf = int(prepared['surfaces']['elem'].shape[0])
  chunks = 1
  while nSurf * (raysPerStep // chunks) > chunkLimit \
      and raysPerStep % (chunks * 2) == 0:
    chunks *= 2
  kw = dict(maxIntersections=maxIntersections, maxRayLength=maxRayLength,
            distTol=distTol)

  def step(seed, histograms):
    gen = seed
    if not isinstance(seed, torch.Generator):
      gen = torch.Generator(device=dev)
      gen.manual_seed(int(seed))
    cols = generator(gen, raysPerStep, stratified=stratified)
    if isinstance(cols, tuple):
      cols = cols[0]
    o = torch.stack([cols['ox'], cols['oy'], cols['oz']], -1)
    d = torch.stack([cols['dx'], cols['dy'], cols['dz']], -1)
    total = None
    n = raysPerStep // chunks
    for c in range(chunks):
      part = slice(c * n, (c + 1) * n)
      histograms, counters = traceHistogram(
          prepared, spec, histograms, o[part], d[part],
          cols['pw'][part], cols['wl'][part], generator=gen, **kw)
      total = counters if total is None else {
          k: total[k] + v for k, v in counters.items()}
    return histograms, total

  step.chunks = chunks
  step.scene = prepared
  return step
