'''
Simulation runtime — the recording run (counterpart of the JAX package's
simulation/runner.py; reference: simulation/processes/simulation_loop.py:
291-775). One process drives the trace kernels over whole ray batches on one
device; lifecycle flag files, the results folder layout, progress dumps, end
criteria and the per-source iteration structure are the reference's, so
external tooling behaves identically.

Actions (reference: simulation_actions.py:22-37, simulation_loop.py:341-348):
  'fans'         one deterministic ray-fan iteration
  'singletrue'   one Monte-Carlo iteration (true random)
  'singlepseudo' one Monte-Carlo iteration (latin-hypercube draws)
  'true'         continuous Monte-Carlo until end criteria / cancel
  'pseudo'       continuous latin-hypercube Monte-Carlo
  'stop'         cancel a running simulation
  'clear'        stop + clear drawn rays (GUI no-op here)

Routes. Each source takes one route for the whole run, decided once from
the scene's properties (`_routeOf`), never by catching a kernel's failure:

  * 'kernel': the hand-written kernels of ops/cuda_trace. Monte-Carlo
    iterations go through `makeRawStep` (stored raw hits, rays drawn in the
    kernel) or `makeTraceStep` (histogram-first recording); ray fans and
    runs that store StoreHit* metadata columns feed the raw-record kernel
    (K4) ray columns drawn outside it (`traceRaw(columns=)`), and the hits
    pick up their rays' metadata by ray index.
  * 'tracer': the record tracer (tracing/tracer.trace, plain PyTorch),
    where the reference takes its own record tracer: sources with
    RecordRays (ray polylines), `draw=` runs, sources without device
    sampling, and scenes the kernels do not cover
    (`cuda_trace.ineligibleReason`).
  * 'twin': histogram-first recording of a source with device sampling on a
    scene the kernels do not cover, through the fused step's twin
    (tracing/fused.makeFusedStep, plain PyTorch over the record tracer's
    bounce), where the reference takes its XLA fused step. Histogram-first
    recording takes the fused step for every source with device sampling
    outside a `draw=` run, RecordRays or not (no polylines are stored
    then): K1 where the kernels cover the scene, else the twin.

`mesh=` and `slaveInfo=` (`_refuseArguments`) are not ported and raise
NotImplementedError by name.
'''

import time

import numpy as np
import torch

from .. import distributions, hostArray, resolveDevice
from ..ops import cuda_trace
from ..tracing import fused, tracer
from ..tracing.batch_tracer import prepareScene
from ..utils import io, timing
from . import results_store
from .lifecycle import Lifecycle, SimulationEnded

SINGLE_SHOT_ACTIONS = ('fans', 'singletrue', 'singlepseudo')
CONTINUOUS_ACTIONS = ('true', 'pseudo')

# rays per step are padded to a multiple of the kernels' thread block, so
# that the ray-index strata of the in-kernel sampler decompose
RAY_BLOCK = 256

# where each refused feature is queued (ROADMAP.md, section A)
_ROADMAP = {
    'slaveInfo': 'A.10c (parallel/multiprocess.py workers)',
    'mesh': 'A.13 (multi-GPU)',
}


def _notPorted(what, key):
  return NotImplementedError(
      f'{what} is not ported to the PyTorch package yet: ROADMAP item '
      f'{_ROADMAP[key]}')


def setupRandomSeed(seed=None, device='cuda'):
  '''Per-process random seeding (reference: simulation_loop.py:813-820).
  Returns a torch.Generator on `device`; the run draws its per-step seeds
  and its latin-hypercube columns from it explicitly.'''
  if seed is None:
    seed = int(time.time() * 1e3) % (2 ** 31)
  distributions.setGlobalSeed(seed)
  np.random.seed(seed % (2 ** 31))
  generator = torch.Generator(device=resolveDevice(device))
  generator.manual_seed(int(seed))
  return generator


def _drawSeeds(generator, count):
  '''`count` kernel seeds from the run's generator, as python ints, with ONE
  device-to-host copy.'''
  return torch.randint(0, 2 ** 62, (count,), generator=generator,
                       device=generator.device).tolist()


def _actionMode(action):
  if action in ('singletrue', 'true'):
    return 'true'
  if action in ('singlepseudo', 'pseudo'):
    return 'pseudo'
  if action == 'fans':
    return 'fans'
  raise ValueError(f'unexpected action {action!r}')


def _withMetadata(cols, rayIdx, metadata, enabledKeys):
  '''Add the enabled per-ray metadata columns, gathered at the hits' ray
  indices (`rayIdx()` is only called when there is any metadata).'''
  wanted = {k: v for k, v in (metadata or {}).items()
            if enabledKeys is None or k.lower() in enabledKeys}
  if wanted:
    nIdx = rayIdx()
    for k, v in wanted.items():
      cols[k] = np.asarray(v)[nIdx]
  return cols


def compactRecordsToHits(records, metadata, elementLabels, enabledKeys=None):
  '''recordsToHits via compaction on the device: the recording rows of the
  slot-major (S, N) records are found and split by element there
  (`torch.nonzero` + `index_select`, plain PyTorch where the reference is
  plain XLA), and each column of each element crosses to the host in ONE
  copy of exactly its `count` rows instead of all S*N. The reference pads
  the compacted rows to a power of two and falls back to a full fetch
  beyond its buffer; both exist for fixed jit shapes and are left behind.
  It also splits by element on the host; masking ~100 MB of fetched columns
  with numpy there cost more than everything else in a raw step, so the
  split happens before the copy. Row order within an element is not part of
  the contract.'''
  recordHit = records['recordHit']
  S, N = recordHit.shape
  idx = torch.nonzero(recordHit.reshape(-1)).reshape(-1)
  if idx.numel() == 0:
    return {}
  elem = records['hitElem'].reshape(-1).index_select(0, idx)
  out = {}
  for e in torch.unique(elem).tolist():      # one small fetch per call
    sel = idx[elem == e]

    def take(x):
      return x.reshape((S * N,) + tuple(x.shape[2:])).index_select(0, sel) \
          .cpu().numpy()

    cols = dict(points=take(records['point']),
                directions=take(records['direction']),
                powers=take(records['power']),
                isEntering=take(records['isEntering']))
    out[elementLabels[e]] = _withMetadata(
        cols, lambda: (sel % N).cpu().numpy(), metadata, enabledKeys)
  return out


def recordsToHits(records, metadata, elementLabels, enabledKeys=None):
  '''Convert slot-major device records into per-element columnar hit
  batches: {elementLabel: dict(points, directions, powers, isEntering,
  metadata columns)} (host side; fetches the full records).'''
  host = {k: records[k].cpu().numpy()
          for k in ('recordHit', 'hitElem', 'point', 'direction', 'power',
                    'isEntering')}
  recordHit = host['recordHit']
  out = {}
  for e, label in enumerate(elementLabels):
    sel = np.nonzero(recordHit & (host['hitElem'] == e))
    if not len(sel[0]):
      continue
    cols = dict(points=host['point'][sel], directions=host['direction'][sel],
                powers=host['power'][sel], isEntering=host['isEntering'][sel])
    out[label] = _withMetadata(cols, lambda: sel[1], metadata, enabledKeys)
  return out


def recordsToRays(records, elementLabels):
  '''Convert the record tracer's segment records into the ragged polyline
  encoding of SimulationResults.addRayBatch (host side).'''
  segValid = records['segValid'].cpu().numpy()          # (B, N)
  if not segValid.any():
    return None
  p1 = records['segP1'].cpu().numpy()                   # (B, N, 3)
  p2 = records['segP2'].cpu().numpy()
  power = records['segPower'].cpu().numpy()
  medium = records['segMedium'].cpu().numpy()
  counts = segValid.sum(axis=0)                          # (N,)
  pointsList, powersList, mediaList = [], [], []
  offsets = [0]
  labelArr = np.array([str(l) for l in elementLabels] + ['None'])
  for n in np.nonzero(counts > 0)[0]:
    k = counts[n]
    pointsList.append(np.concatenate([p1[:k, n], p2[k - 1:k, n]]))
    powersList.append(power[:k, n])
    med = medium[:k, n]
    mediaList.append(labelArr[np.where(med < 0, len(elementLabels), med)])
    offsets.append(offsets[-1] + k + 1)
  return dict(points=np.concatenate(pointsList),
              powers=np.concatenate(powersList),
              media=np.concatenate(mediaList),
              offsets=np.array(offsets))


def _sliceBatch(batch, index, count):
  '''Strided slice [index::count] of every per-ray column of a generated
  ray batch (origins / directions / powers / wavelengths + metadata).'''
  n = len(batch['origins'])
  out = {}
  for k, v in batch.items():
    if k == 'metadata':
      out[k] = {mk: (np.asarray(mv)[index::count]
                     if hasattr(mv, '__len__') and len(mv) == n else mv)
                for mk, mv in v.items()}
    elif hasattr(v, '__len__') and len(v) == n:
      out[k] = np.asarray(v)[index::count]
    else:
      out[k] = v
  return out


def _columnsOf(batch, dev):
  '''The (8, N) float32 ray columns (ox..dz, pw, wl) of a host ray batch
  (`generateRays`), on `dev`.'''
  o = np.asarray(batch['origins'], np.float32).reshape(-1, 3)
  d = np.asarray(batch['directions'], np.float32).reshape(-1, 3)
  cols = np.concatenate([o.T, d.T, np.asarray(batch['powers'],
                                              np.float32)[None],
                         np.asarray(batch['wavelengths'], np.float32)[None]])
  return torch.as_tensor(np.ascontiguousarray(cols), device=dev)


class SimulationRun:
  '''One compiled simulation: the scene's host tables (what
  `cuda_trace.buildTraceTables` reads) + per-source settings. A source with
  IgnoredOpticalElements traces its own copy of the scene, with its surface
  mask (`sceneFor`). Single device; sharding the ray axis over several cards
  waits for the multi-GPU port.'''

  def __init__(self, scene, settings, device='cuda'):
    self.scene = scene
    self.settings = settings
    self.torchDevice = resolveDevice(device)
    self.device, self.info = scene.compile(device=None)
    self.device['powerTol'] = 1e-6
    self._prepared = {}

  def sceneFor(self, source):
    '''The scene `source` is traced through: the compiled scene, plus the
    source's `surfMask` where its IgnoredOpticalElements leave out some
    surfaces.'''
    mask = self.info['surfaceMasks'].get(source.Label)
    if mask is None:
      return self.device
    return dict(self.device, surfMask=mask)

  def maxIntersections(self, source):
    return max(1, int(round(self.settings.maxIntersections()
                            * float(source.MaxIntersectionsScale))))

  def maxRayLength(self, source):
    return self.settings.maxRayLength() * float(source.MaxRayLengthScale)

  def traceBatch(self, source, columns, recordSegments, generator=None):
    '''Trace (8, N) ray columns of `source` through the record tracer
    (tracing/tracer.trace) on the run's device. Returns (state, records),
    bounce-major.'''
    key = source.Label
    if key not in self._prepared:
      self._prepared[key] = prepareScene(self.sceneFor(source),
                                         self.torchDevice)
    o = columns[0:3].T
    d = columns[3:6].T
    return tracer.trace(
        self._prepared[key], o, d, columns[6], columns[7],
        maxIntersections=self.maxIntersections(source),
        maxRayLength=self.maxRayLength(source),
        distTol=max(self.settings.distanceTolerance(), 1e-4),
        recordSegments=recordSegments, generator=generator)

  def stepKwargs(self, source, raysPerStep):
    '''Keyword arguments of a step factory that derive from the settings
    and the source's scale factors.'''
    return dict(raysPerStep=raysPerStep,
                maxIntersections=self.maxIntersections(source),
                maxRayLength=self.maxRayLength(source),
                device=self.torchDevice)


def _refuseArguments(unsupported):
  '''Raise NotImplementedError, by name, for the reference's arguments that
  need modules this package lacks; TypeError for anything else.'''
  for key, what in (('mesh', 'mesh= (sharding over several devices)'),
                    ('slaveInfo', 'slaveInfo= (the worker role)')):
    value = unsupported.pop(key, None)
    if value is not None and value is not False:
      raise _notPorted(what, key)
  if unsupported:
    raise TypeError(f'runSimulation got unexpected keyword arguments '
                    f'{sorted(unsupported)}')


def _routeOf(run, src, mode, drawn, histMode=False):
  '''(route, reason) of a source, from the scene's properties only:
  ('tracer', why) where the reference takes its record tracer too, ('twin',
  why) where it takes its XLA fused step (histogram-first recording on a
  scene the kernels do not cover), else ('kernel', None).'''
  if histMode and drawn is None and src.supportsDeviceSampling():
    reason = cuda_trace.ineligibleReason(run.sceneFor(src))
    if reason is None:
      return 'kernel', None
    return 'twin', f'the kernels do not cover this scene ({reason})'
  if bool(src.RecordRays):
    return 'tracer', f'RecordRays (ray polylines of source {src.Label})'
  if drawn is not None:
    return 'tracer', 'draw= (drawn ray polylines)'
  if mode != 'fans' and not src.supportsDeviceSampling():
    return 'tracer', f'source {src.Label} without device sampling'
  reason = cuda_trace.ineligibleReason(run.sceneFor(src))
  if reason is not None:
    return 'tracer', f'the kernels do not cover this scene ({reason})'
  return 'kernel', None


def runSimulation(scene, action, endIf=None, seed=None, store=None,
                  draw=False, progressCallback=None, flushEverySeconds=5,
                  recording='raw', histBounds=None, histBins=(256, 256),
                  rawSampleRays=1 << 13, rawSampleEvery=8, device='cuda',
                  **unsupported):
  '''
  Run a simulation on `scene` (a models.Scene) on `device` (default 'cuda';
  raises without a card; 'cpu' runs the kernels' plain PyTorch versions and
  the record tracer on the CPU). Returns the run folder path (or None for
  'stop'/'clear'). See the module docstring for actions and routes.

  recording='raw' stores every hit on a recording element: on the kernel
  route each Monte-Carlo iteration is one launch of the raw-record kernel,
  a compaction of its hit ring on the device, one fetch of the recording
  rows and a buffered write.

  recording='histogram' switches Monte-Carlo runs on the kernel route to
  histogram-first storage: detector histograms accumulate ON THE DEVICE
  through the fused sample + trace + bin kernel and are flushed as
  cumulative snapshots (source-<label>/<ts>-histograms.npz, loader:
  results_store.loadHistogramSnapshots); only a capped raw-hit sample
  (`rawSampleRays` rays every `rawSampleEvery` iterations) goes through the
  raw-record path, so a storing run keeps the fused step's throughput.
  Sources with device sampling take it whatever their RecordRays (no
  polylines are stored then); on a scene the kernels do not cover the
  fused step is its twin (route 'twin') and the raw sample goes through the
  record tracer. Other sources keep their own route.
  histBounds: detector-local (x0, x1, y0, y1) or dict label->bounds.

  Hits of rays drawn outside the kernels (fans, host-sampled sources) or
  traced by the record tracer carry the metadata columns their StoreHit*
  flags enable plus the fan indices (fanIndex, rayIndex, totalFanCount,
  totalRaysInFan), or every column of their rays where no flag is set, as
  in the reference. Sources with RecordRays also store their ray polylines
  (`RawFolder.loadRays`).

  draw=True collects the traced polylines of a SINGLE-SHOT action into a
  simulation.draw.DrawnRays (written to the run folder as drawn-rays.ply /
  .npz); pass an existing DrawnRays as `draw` to collect into it.
  Continuous actions ignore draw with a warning (the reference GUI likewise
  only draws single-shot runs).
  '''
  resultsFolder = results_store.getResultsFolderPath(
      scene.path or scene.label)
  lifecycle = Lifecycle(resultsFolder)

  if action in ('stop', 'clear'):
    lifecycle.setIsCanceled(True)
    for src in scene.lightSources():
      src.clear()
    return None

  _refuseArguments(unsupported)
  if action not in SINGLE_SHOT_ACTIONS + CONTINUOUS_ACTIONS:
    raise ValueError(f'unknown action {action!r}')

  if lifecycle.isRunning():
    raise RuntimeError('a simulation is already running for this document')

  dev = resolveDevice(device)
  settings = scene.activeSimulationSettings()
  mode = _actionMode(action)
  continuous = action in CONTINUOUS_ACTIONS
  run = SimulationRun(scene, settings, device=dev)

  # headless ray drawing (single-shot only, as the reference GUI)
  drawn, drawParams = None, {}
  if draw:
    if continuous:
      io.warn('draw=True is ignored for continuous actions '
              '(the reference GUI only draws single-shot runs)')
    else:
      from . import draw as drawMod
      drawn = (draw if isinstance(draw, drawMod.DrawnRays)
               else drawMod.DrawnRays())
      drawParams = drawMod.sceneDrawParams(scene)

  histMode = recording == 'histogram' and mode != 'fans'
  routes = {}
  for src in scene.lightSources():
    routes[src.Label], why = _routeOf(run, src, mode, drawn, histMode)
    io.verb(f'{src.Label}: taking the {routes[src.Label]} route'
            + ('' if why is None else f': {why}'))

  # store decisions (reference: simulation_loop.py:350-378): continuous runs
  # always store; single-shot only with EnableStoreSingleShotData (or when
  # explicitly requested)
  if store is None:
    store = continuous or bool(settings.EnableStoreSingleShotData)

  generator = setupRandomSeed(seed, dev)
  lifecycle.clearAll()
  lifecycle.setIsRunning(True)

  results = None
  hists = {}         # referenced in `finally` — must exist even when the
                     # run fails before the histogram-mode setup below
  try:
    endIter = settings.endAfterIterations() if continuous else 1
    results = results_store.SimulationResults(
        simulationType=action,
        basePath=resultsFolder,
        simulationRunFolder=results_store.generateSimulationFolderName(
            resultsFolder),
        flushEverySeconds=flushEverySeconds,
        endAfterIterations=endIter,
        endAfterRays=settings.endAfterRays() if continuous else np.inf,
        endAfterHits=settings.endAfterHits() if continuous else np.inf)
    results.dumpGlobalInfo(scene.collectGlobalInfo())

    chunkTimer = timing.IntervalTimer(3600)
    perfTimer = timing.IntervalTimer(60)
    enabledKeys = settings.enabledMetadataKeys()

    # ---- histogram-first recording: accumulation state on the device ----
    histSteps, rawSteps, columnTables = {}, {}, {}
    overflowWarned = set()
    histFlushTimer = timing.IntervalTimer(flushEverySeconds)
    # the histogram spec doubles as the raw path's element/detector map
    histSpec = fused.makeHistogramSpec(run.device, run.info,
                                       bounds=histBounds, bins=histBins)
    histMeta = dict(bounds=np.asarray(histSpec['bounds']),
                    detLabels=histSpec['detLabels'])
    elementLabels = run.info['elementLabels']

    # float32 kernels: a tolerance below 1e-4 mm lets a ray re-hit the
    # surface it just left. The reference clamps on its raw path only; its
    # histogram path passes the setting through and, at the default 1e-6,
    # loses about a fifth of the hits on the lens-and-mirror scene. Every
    # path clamps here, the record tracer's too (`SimulationRun.traceBatch`).
    distTol = max(settings.distanceTolerance(), 1e-4)

    # true random draws happen inside the kernel where the source has a
    # sampler spec; latin-hypercube draws ('pseudo') always come as columns
    # from the source's device generator
    def buildHistStep(src, n):
      if routes[src.Label] == 'twin':
        kw = run.stepKwargs(src, n)
        return fused.makeFusedStep(
            run.sceneFor(src), src.deviceGenerator(device=dev), histSpec,
            kw['raysPerStep'], kw['maxIntersections'], kw['maxRayLength'],
            distTol, stratified=(mode == 'pseudo'), device=dev), n
      nPad = -(-n // RAY_BLOCK) * RAY_BLOCK
      return cuda_trace.makeTraceStep(
          run.sceneFor(src), histSpec,
          src.deviceColumnsGenerator(device=dev), sampler=src.samplerSpec(),
          stratified=(mode == 'pseudo'), distTol=distTol,
          emissionBound=src.emissionBound(),
          **run.stepKwargs(src, nPad)), nPad

    def buildRawStep(src, n):
      nPad = -(-n // RAY_BLOCK) * RAY_BLOCK
      columns, sampler = src.deviceColumnsGenerator(device=dev), None
      if mode == 'pseudo':
        columns = (lambda draw: lambda gen, count: draw(
            gen, count, stratified=True))(columns)
      else:
        sampler = src.samplerSpec()
      return cuda_trace.makeRawStep(
          run.sceneFor(src), histSpec, columns, sampler=sampler,
          distTol=distTol, emissionBound=src.emissionBound(),
          **run.stepKwargs(src, nPad)), nPad

    def stepSeed():
      '''What a step is handed as its seed: a python int for the in-kernel
      sampler, the run's generator itself for latin-hypercube columns.'''
      return generator if mode == 'pseudo' else _drawSeeds(generator, 1)[0]

    def flushHistograms():
      for label, hist in hists.items():
        results.writeHistogramSnapshot(
            label, dict(power=hist['power'].cpu().numpy(),
                        counts=hist['counts'].cpu().numpy()), histMeta)

    def storeHits(srcLabel, hits):
      '''One stored-hit schema for every path (raw / sampled / columns).'''
      for label, cols in hits.items():
        meta = {k: v for k, v in cols.items()
                if k not in ('points', 'directions', 'powers',
                             'isEntering')}
        results.addHitBatch(srcLabel, label, cols['points'],
                            cols['directions'], cols['powers'],
                            cols['isEntering'], meta)

    def warnOverflow(src, overflow, what):
      if overflow and src.Label not in overflowWarned:
        overflowWarned.add(src.Label)
        io.warn(f'{overflow} detector passes overflowed the per-ray '
                f'hit-slot ring; {what} under-record (raise hitSlots)')

    def rawIteration(src, n, key, countHits=True):
      '''One launch of the raw-record kernel for `src`, its hits compacted,
      fetched and buffered (or only counted when nothing is stored).
      Returns the number of rays traced.'''
      entry = rawSteps.get(key)
      if entry is None:
        entry = rawSteps[key] = buildRawStep(src, n)
      stepR, nPad = entry
      records, rawCounters = stepR(stepSeed())
      before = results.totalRecordedHits
      if store:
        warnOverflow(src, int(rawCounters['hitOverflow']), 'stored hits')
        storeHits(src.Label, compactRecordsToHits(records, {},
                                                  elementLabels))
      else:
        # still count hits for end criteria / progress
        results.totalRecordedHits += int(rawCounters['hits'])
      if not countHits:
        results.totalRecordedHits = before
      return nPad

    def columnsRecords(src, columns):
      '''Hit records of ray `columns` (8, N) through the raw-record kernel
      in its columns input mode (the kernel route of fans and metadata
      runs); its tables are built once per source.'''
      entry = columnTables.get(src.Label)
      if entry is None:
        sc = run.sceneFor(src)
        maxI = run.maxIntersections(src)
        entry = columnTables[src.Label] = (
            cuda_trace.buildTraceTables(sc, histSpec, device=dev),
            cuda_trace.autoHitSlots(sc, histSpec, maxI))
      tables, hitSlots = entry
      extra = ({'seed': _drawSeeds(generator, 1)[0]} if tables['scatter']
               else {})
      ring, counters = cuda_trace.traceRaw(
          tables, columns.shape[1], run.maxIntersections(src),
          run.maxRayLength(src), distTol,
          powerTol=float(run.device['powerTol']), hitSlots=hitSlots,
          columns=columns, **extra)
      warnOverflow(src, int(counters[2]), 'stored hits')
      return cuda_trace.recordsFromRing(ring)

    def generateBatch(src, n):
      '''(columns (8, N) on the device, metadata {name: (N,) array}) of one
      iteration of `src`: its fans, its device generator's draws, or its
      host-side draws.'''
      if mode == 'fans' or not src.supportsDeviceSampling():
        # host draws use the seeded default generator (setupRandomSeed)
        batch = src.generateRays(mode, settings=settings)
        return (_columnsOf(batch, dev) if len(batch['origins']) else None,
                batch.get('metadata', {}))
      cols, meta = src.deviceGenerator(device=dev)(
          generator, n, stratified=(mode == 'pseudo'))
      return torch.stack([cols[k] for k in cuda_trace._COLUMN_KEYS]), meta

    def recordIteration(src, n, countHits=True):
      '''One iteration of a source whose rays are drawn outside the kernels
      (fans, metadata runs, host-sampled sources) or that takes the record
      tracer. Returns the number of rays traced.'''
      columns, metadata = generateBatch(src, n)
      if columns is None:
        return 0
      recordSegs = routes[src.Label] == 'tracer' and (
          bool(src.RecordRays) or drawn is not None)
      if routes[src.Label] == 'kernel':
        records = columnsRecords(src, columns)
      else:
        _state, records = run.traceBatch(src, columns, recordSegs,
                                         generator=generator)
      if drawn is not None:
        drawn.add(records, sourceLabel=src.Label,
                  sourceColor=getattr(src, 'ViewColor', (1., 0., 0.)),
                  **drawParams)
      if store:
        # the enabled columns, plus the fan indices where present (fan
        # analysis needs them); with no StoreHit* flag every column of the
        # batch, as the reference's record path stores
        keys = (None if not enabledKeys
                else enabledKeys + ['fanindex', 'rayindex', 'totalfancount',
                                    'totalraysinfan'])
        before = results.totalRecordedHits
        storeHits(src.Label, compactRecordsToHits(
            records, {k: hostArray(v) for k, v in metadata.items()},
            elementLabels, enabledKeys=keys))
        if not countHits:
          results.totalRecordedHits = before
        if recordSegs:
          rays = recordsToRays(records, elementLabels)
          if rays is not None:
            results.addRayBatch(src.Label, **rays)
      else:
        results.totalRecordedHits += int(records['recordHit'].sum())
      return columns.shape[1]

    for src in scene.lightSources():
      src.onInitializeSimulation(state='pre-worker-launch', ident=action)

    iteration = 0
    while True:
      iteration += 1
      # iteration accounting for windowed histogram dispatch: the window is
      # shared across sources (one loop pass advances every source), so the
      # extra iterations counted per pass are the MAX inner window over the
      # sources, not their sum
      passExtraIters = 0
      for src in scene.lightSources():
        n = max(1, int(round(settings.raysPerIteration()
                             * float(src.RaysPerIterationScale))))
        if mode == 'fans' or routes[src.Label] == 'tracer' \
            or not src.supportsDeviceSampling() \
            or (enabledKeys and not histMode):
          results.incrementRayCount(recordIteration(src, n))
          continue
        if not histMode:
          results.incrementRayCount(rawIteration(src, n, src.Label))
          continue

        # ---- histogram-first path ----
        entry = histSteps.get(src.Label)
        if entry is None:
          entry = histSteps[src.Label] = buildHistStep(src, n)
          hists[src.Label] = fused.initHistograms(histSpec, device=dev)
        step, nStep = entry
        # dispatch a WINDOW of steps and fetch the hit counter once: a
        # fetch per step would make the host wait for every kernel before
        # it queues the next
        if not continuous:
          inner = 1
        elif np.isfinite(results.endAfterRays):
          remaining = results.endAfterRays - results.totalTracedRays
          # divide by the PADDED per-step count (what incrementRayCount
          # advances by) or the window overshoots endAfterRays
          inner = int(np.clip(np.ceil(remaining / max(nStep, 1)), 1, 16))
        else:
          inner = 16
        if np.isfinite(results.endAfterIterations):
          inner = int(np.clip(results.endAfterIterations
                              - results.totalIterations, 1, inner))
        if np.isfinite(results.endAfterHits):
          inner = min(inner, 4)     # bound the overshoot past the target
        seeds = ([generator] * inner if mode == 'pseudo'
                 else _drawSeeds(generator, inner))
        counterAcc = None
        for stepSeedValue in seeds:
          hists[src.Label], counters = step(stepSeedValue, hists[src.Label])
          c = torch.stack([counters['hits'], counters['hitOverflow']])
          counterAcc = c if counterAcc is None else counterAcc + c
        # count the rays the step ACTUALLY traced: the batch is padded to
        # a block multiple and the padding rays are REAL rays whose hits
        # land in the histograms, so the padded count is the correct
        # normalization for power-per-ray statistics
        results.incrementRayCount(nStep * inner)
        passExtraIters = max(passExtraIters, inner - 1)
        hitTotal, overflow = counterAcc.tolist()   # the window's one fetch
        results.totalRecordedHits += hitTotal
        warnOverflow(src, overflow, 'histogram counts')
        # capped raw-hit sample for per-hit storage. Its rays are extra:
        # they count neither as traced rays (as in the reference) nor as
        # recorded hits (the reference adds them to the hit total, which
        # then exceeds what the histograms hold)
        if store and rawSampleRays and iteration % rawSampleEvery == 1:
          if enabledKeys or routes[src.Label] == 'twin':
            recordIteration(src, rawSampleRays, countHits=False)
          else:
            rawIteration(src, rawSampleRays, (src.Label, 'sample'),
                         countHits=False)
        if store and histFlushTimer.check():
          flushHistograms()

      results.incrementIterationCount(1 + passExtraIters)
      results.writeDiskIfNeeded()
      progress = results.getProgress()
      if progressCallback is not None:
        progressCallback(progress)
      if endIf is not None and endIf(results.runPath()):
        lifecycle.setIsFinished(True)
      if perfTimer.check():
        io.info(results.performanceDescription())
      if chunkTimer.check():
        try:
          results_store.chunkFiles(results.runPath())
        except Exception as e:
          io.warn(f'result-file chunking failed (run continues): {e}')
      lifecycle.touchRunning()
      if progress['reachedEnd'] or lifecycle.isCanceled() \
          or lifecycle.isFinished():
        break
      if not continuous:
        break
  except SimulationEnded:
    pass
  finally:
    if results is not None:
      try:
        if store and hists:
          flushHistograms()
      except Exception as e:
        io.warn(f'final histogram flush failed: {e}')
      if drawn is not None and drawn.rayCount:
        try:
          drawn.save(results.runPath())
        except Exception as e:
          io.warn(f'writing drawn rays failed: {e}')
      results.cleanup()
      io.info(f'simulation ended: {results.performanceDescription()}')
    for src in scene.lightSources():
      src.onExitSimulation(ident=action)
    lifecycle.setIsFinished(True)
    lifecycle.setIsRunning(False)
    lifecycle.setIsCanceled(False)
    io.gatherWorkerLogs()
  return results.runPath()


def runAction(scene, action, **kwargs):
  '''Parity wrapper (reference: simulation_loop.py:275-289).'''
  return runSimulation(scene, action, **kwargs)
