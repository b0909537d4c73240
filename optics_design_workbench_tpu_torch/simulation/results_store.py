'''
Results store — the on-disk contract of the reference, re-implemented
batch-first (reference: simulation/results_store.py:28-739):

  <name>.OpticsDesign/
    README.md
    raw/simulation-run-NNNNNN/
      uid-<uuid4>                  run identity marker (:289-298)
      global-info.pkl              scene snapshot (:333-336)
      progress/<fingerprint>-*     per-worker progress dumps (:462-480)
      source-<label>/
        <ts>-pid..-rays.npz        ray polylines per source (:380-403)
        object-<label>/
          <ts>-pid..-hits.npz      columnar hit data (:405-457)
    notebooks/

Differences by design: data files are numpy `.npz` archives instead of
pickles (safe to load, zero-copy columns); `global-info.pkl` stays pickle
for reader parity. Hit files keep the reference's columnar schema (points,
directions, powers, isEntering + nan-padded metadata columns) so the
analysis layer is format-compatible in spirit.
'''

import glob
import os
import pickle
import random
import threading
import time
import uuid
import io as _io

import numpy as np

from ..utils import io
from ..utils import native_store

_README_TEXT = '''# OpticsDesign simulation results

This folder was generated by optics_design_workbench_tpu_torch. Subfolder `raw/`
contains one folder per simulation run with recorded ray/hit data; put your
analysis notebooks into `notebooks/`.
'''

CHUNK_TARGET_BYTES = 500_000_000  # reference: results_store.py:74

# result file format: 'odwc' = native async columnar writer (the simulation
# loop never blocks on disk; see native/odw_store.cpp), 'npz' = numpy
# archives. Loaders read both transparently.
DEFAULT_FILE_FORMAT = os.environ.get('OPTICS_TPU_STORE_FORMAT', 'odwc')


def getResultsFolderPath(documentPath, ensure=True):
  '''`<name>.OpticsDesign` next to the document file (reference:
  results_store.py:28-72).'''
  base = os.path.splitext(os.path.abspath(documentPath))[0]
  path = base + '.OpticsDesign'
  if ensure:
    os.makedirs(path, exist_ok=True)
  return path


def getLatestRunIndex(resultsFolder):
  indices = [-1]
  for p in glob.glob(f'{resultsFolder}/raw/simulation-run-*'):
    try:
      indices.append(int(os.path.basename(p).rsplit('-', 1)[-1]))
    except ValueError:
      pass
  return max(indices)


def generateSimulationFolderName(resultsFolder, index=None):
  if index is None:
    index = getLatestRunIndex(resultsFolder) + 1
  return f'raw/simulation-run-{int(index):06d}'


def _saveNpz(path, payload):
  buf = _io.BytesIO()
  np.savez_compressed(buf, **payload)
  io.atomicWrite(path, buf.getvalue())


def _saveColumns(path, payload, fileFormat=None):
  '''Write a columnar result file in the configured format. Returns the
  actual path written (extension depends on format).'''
  fmt = fileFormat or DEFAULT_FILE_FORMAT
  payload = {k: np.asarray(v) for k, v in payload.items()}
  if fmt == 'odwc':
    path = path + '.odwc'
    try:
      native_store.writeColumns(path, payload, asynchronous=True)
      return path
    except Exception as e:
      io.warn(f'native store write failed ({e}); falling back to npz')
      path = path[:-5]
  _saveNpz(path + '.npz', payload)
  return path + '.npz'


def loadResultFile(path):
  '''Read one columnar result file: npz, odwc, or a reference-era pkl
  (the reference pickles columnar dicts as `<ts>-pid-thread-hits.pkl`,
  results_store.py:399-453 — loading them lets a user point this
  framework's loaders and ReplaySource at an existing reference run
  folder unchanged; numpy module renames are tolerated, io.py:242-249).'''
  if path.endswith('.odwc'):
    return native_store.readColumns(path)
  if path.endswith('.pkl'):
    data = io.unpickle(path)
    if not isinstance(data, dict):
      raise ValueError(f'{path}: expected a pickled columnar dict, '
                       f'got {type(data).__name__}')
    return {k: (np.asarray(v) if not np.isscalar(v) and v is not None
                else v) for k, v in data.items()}
  return {k: v for k, v in np.load(path, allow_pickle=True).items()}


def resultFilePaths(folder, kind='hits'):
  '''All result files of a kind under folder (all formats, including
  reference-written .pkl).'''
  out = []
  for ext in ('npz', 'odwc', 'pkl'):
    out.extend(glob.glob(os.path.join(folder, f'*-{kind}.{ext}')))
    out.extend(glob.glob(os.path.join(folder, f'*-{kind}-chunk.{ext}')))
  return sorted(set(out))


def _progressWorkerKey(filename):
  '''Stable worker key for a progress-dump filename, so later cumulative
  dumps from the same worker REPLACE earlier ones instead of being summed
  (the reference keys by pid: results_store.py:558-599). Filenames are
  either '<workerId>-<ts>-pid<P>-thread<T>' or '<ts>-pid<P>-thread<T>-<hash>'.'''
  parts = filename.split('-')
  if parts and not parts[0].isdigit():
    return parts[0]
  pidThread = [p for p in parts
               if p.startswith('pid') or p.startswith('thread')]
  return '-'.join(pidThread) if pidThread else filename


class SimulationResults:
  '''Accumulates traced batches and flushes them to the run folder with the
  reference's cadence semantics (flush ~5 s with jitter, progress ~0.2 s;
  results_store.py:264-278).'''

  def __init__(self, simulationType, basePath, simulationRunFolder,
               flushEverySeconds=5, dumpProgressEverySeconds=.2,
               endAfterIterations=np.inf, endAfterRays=np.inf,
               endAfterHits=np.inf, fileFormat=None):
    self.simulationType = simulationType
    self.fileFormat = fileFormat or DEFAULT_FILE_FORMAT
    self.basePath = basePath
    self.simulationRunFolder = simulationRunFolder
    self.flushEverySeconds = flushEverySeconds
    self.dumpProgressEverySeconds = dumpProgressEverySeconds
    self._lastFlush = time.time() + flushEverySeconds * random.random()
    self._lastDumpedProgress = time.time() \
        + dumpProgressEverySeconds * random.random()
    self._masterProgressDumpIdx = 0
    self._lastMasterDump = 0.0
    self._lastStamp = 0
    self.t0 = time.time()

    self.endAfterIterations = endAfterIterations
    self.endAfterRays = endAfterRays
    self.endAfterHits = endAfterHits
    self.reachedEnd = False

    self.totalIterations = 0
    self.totalTracedRays = 0
    self.totalRecordedRays = 0
    self.totalRecordedHits = 0
    self.progressByWorker = {}

    # buffered batches: {(sourceLabel, objLabel): [hit dicts]} and
    # {sourceLabel: [ray dicts]}
    self._hitBatches = {}
    self._rayBatches = {}
    self._cleanedUp = False

    runPath = os.path.join(self.basePath, self.simulationRunFolder)
    try:
      os.makedirs(runPath, exist_ok=True)
      if not any(f.startswith('uid-') for f in os.listdir(runPath)):
        with open(os.path.join(runPath, f'uid-{uuid.uuid4()}'), 'w'):
          pass
    except Exception:
      raise RuntimeError(f'simulation result path is not writable: {runPath}')
    self._ensureFolderStructureExists()

  def _ensureFolderStructureExists(self):
    for sub in ('raw', 'notebooks'):
      os.makedirs(os.path.join(self.basePath, sub), exist_ok=True)
    readme = os.path.join(self.basePath, 'README.md')
    if not os.path.exists(readme):
      io.atomicWrite(readme, _README_TEXT.encode())

  def runPath(self):
    return os.path.join(self.basePath, self.simulationRunFolder)

  def dumpGlobalInfo(self, info):
    path = os.path.join(self.runPath(), 'global-info.pkl')
    if not os.path.exists(path):
      io.atomicWrite(path, pickle.dumps(info))

  def _raiseIfCleanedUp(self):
    if self._cleanedUp:
      raise RuntimeError('this storage was already cleaned up')

  def _fingerprint(self):
    # the millisecond stamp goes up on every call, so two flushes within one
    # millisecond write two files instead of the second overwriting the first
    self._lastStamp = max(int(time.time() * 1e3), self._lastStamp + 1)
    return (f'{self._lastStamp}-pid{os.getpid()}'
            f'-thread{threading.get_ident()}')

  # ----------------------------------------------------------------- adding

  def incrementIterationCount(self, by=1):
    self.totalIterations += by

  def incrementRayCount(self, by=1):
    self.totalTracedRays += by

  def addHitBatch(self, sourceLabel, objLabel, points, directions, powers,
                  isEntering, metadata=None):
    '''Record a batch of hits on one optical object (the batched analog of
    addRayHit, results_store.py:641-648). Arrays must share leading dim.'''
    self._raiseIfCleanedUp()
    n = len(points)
    if n == 0:
      return
    batch = dict(points=np.asarray(points), directions=np.asarray(directions),
                 powers=np.asarray(powers),
                 isEntering=np.asarray(isEntering).astype(np.int8))
    for k, v in (metadata or {}).items():
      batch[k] = np.asarray(v)
    self._hitBatches.setdefault((sourceLabel, objLabel), []).append(batch)
    self.totalRecordedHits += n

  def addRayBatch(self, sourceLabel, points, powers, media, offsets):
    '''Record a batch of ray polylines: `points` (P,3) concatenated vertices,
    `powers` (P-ish,) per-segment powers, `media` per-segment medium labels,
    `offsets` (R+1,) slicing individual rays out of the concatenated arrays
    (ragged encoding of SimulationResultsSingleRay.dump,
    results_store.py:232-257).'''
    self._raiseIfCleanedUp()
    if len(offsets) <= 1:
      return
    self._rayBatches.setdefault(sourceLabel, []).append(dict(
        points=np.asarray(points), powers=np.asarray(powers),
        media=np.asarray(media), offsets=np.asarray(offsets)))
    self.totalRecordedRays += len(offsets) - 1

  # ---------------------------------------------------------------- flushing

  def flush(self):
    '''Write buffered batches to disk (reference: results_store.py:369-460).'''
    self._raiseIfCleanedUp()
    fingerprint = self._fingerprint()
    for (srcLabel, objLabel), batches in self._hitBatches.items():
      folder = os.path.join(self.runPath(), f'source-{srcLabel}',
                            f'object-{objLabel}')
      os.makedirs(folder, exist_ok=True)
      keys = set()
      for b in batches:
        keys.update(b.keys())
      merged = dict(source=srcLabel, obj=objLabel)
      for k in sorted(keys):
        cols = []
        for b in batches:
          n = len(b['points'])
          if k in b:
            cols.append(np.asarray(b[k]))
          else:
            # nan-pad missing metadata columns (results_store.py:423-430)
            ref = next((np.asarray(x[k]) for x in batches if k in x), None)
            shape = (n,) + (ref.shape[1:] if ref is not None else ())
            cols.append(np.full(shape, np.nan))
        merged[k] = np.concatenate(cols)
      _saveColumns(os.path.join(folder, f'{fingerprint}-hits'), merged,
                   self.fileFormat)
    self._hitBatches = {}

    for srcLabel, batches in self._rayBatches.items():
      folder = os.path.join(self.runPath(), f'source-{srcLabel}')
      os.makedirs(folder, exist_ok=True)
      pointSets, powerSets, mediaSets, offsetSets = [], [], [], []
      base = 0
      for b in batches:
        pointSets.append(b['points'])
        powerSets.append(b['powers'])
        mediaSets.append(b['media'])
        offs = np.asarray(b['offsets'])
        offsetSets.append(offs[:-1] + base)
        base += offs[-1]
      offsets = np.concatenate(offsetSets + [[base]])
      _saveColumns(os.path.join(folder, f'{fingerprint}-rays'),
                   dict(points=np.concatenate(pointSets),
                        powers=np.concatenate(powerSets),
                        media=np.concatenate(mediaSets),
                        offsets=offsets),
                   self.fileFormat)
    self._rayBatches = {}
    self._lastFlush = time.time() \
        + (.1 * random.random() - .05) * self.flushEverySeconds

  def writeDiskIfNeeded(self):
    if time.time() > self._lastFlush + self.flushEverySeconds:
      self.flush()

  # ---------------------------------------------------------------- progress

  def dumpProgress(self, workerId=None):
    '''Atomic per-worker progress dump consumed by the master
    (reference: results_store.py:462-480).'''
    self._raiseIfCleanedUp()
    folder = os.path.join(self.runPath(), 'progress')
    os.makedirs(folder, exist_ok=True)
    name = (f'{self._fingerprint()}-{hex(int(random.random()*1e15))[2:]}'
            if workerId is None else f'{workerId}-{self._fingerprint()}')
    io.atomicWrite(os.path.join(folder, name), pickle.dumps(dict(
        simulationType=self.simulationType,
        totalIterations=self.totalIterations,
        totalTracedRays=self.totalTracedRays,
        totalRecordedHits=self.totalRecordedHits,
        totalRecordedRays=self.totalRecordedRays)))
    self._lastDumpedProgress = time.time() \
        + (2 * random.random() - 1) * self.dumpProgressEverySeconds

  def dumpProgressIfNeeded(self, workerId=None):
    if time.time() > self._lastDumpedProgress + self.dumpProgressEverySeconds:
      self.dumpProgress(workerId=workerId)

  def getProgress(self, consume=True):
    '''Master aggregation: consume worker progress dumps, add own counters,
    check end criteria and dump a `master-%09d` snapshot for external
    trackers (reference: results_store.py:486-550).'''
    folder = os.path.join(self.runPath(), 'progress')
    if os.path.isdir(folder):
      # sorted: filenames embed a ms timestamp, so later (cumulative) dumps
      # from the same worker override earlier ones deterministically
      for fn in sorted(os.listdir(folder)):
        # '.tmp-*' are atomicWrite's in-flight files: a fully-written but
        # not-yet-renamed dump LOADS successfully, and consuming it makes
        # the writer's os.replace crash with ENOENT (observed as periodic
        # worker rc=1 deaths at fast dump cadences)
        if fn.startswith('master-') or fn.startswith('.tmp'):
          continue
        path = os.path.join(folder, fn)
        try:
          with open(path, 'rb') as f:
            data = pickle.load(f)
          if consume:
            os.remove(path)
          self.progressByWorker[_progressWorkerKey(fn)] = data
        except Exception:
          continue
    total = dict(simulationType=self.simulationType,
                 totalIterations=self.totalIterations,
                 totalTracedRays=self.totalTracedRays,
                 totalRecordedHits=self.totalRecordedHits,
                 totalRecordedRays=self.totalRecordedRays,
                 endAfterIterations=self.endAfterIterations,
                 endAfterRays=self.endAfterRays,
                 endAfterHits=self.endAfterHits,
                 elapsedSeconds=time.time() - self.t0)
    for data in self.progressByWorker.values():
      for k in ('totalIterations', 'totalTracedRays', 'totalRecordedHits',
                'totalRecordedRays'):
        total[k] += data.get(k, 0)
    if (total['totalIterations'] >= self.endAfterIterations
        or total['totalTracedRays'] >= self.endAfterRays
        or total['totalRecordedHits'] >= self.endAfterHits):
      self.reachedEnd = True
    total['reachedEnd'] = self.reachedEnd
    # master snapshot for the jupyter progress tracker: throttled to ~0.5 s
    # and pruned of snapshots older than 10 s, as the reference does
    # (results_store.py:515-539) — otherwise progress/ grows without bound
    now = time.time()
    if now - self._lastMasterDump >= .5 or total['reachedEnd']:
      self._lastMasterDump = now
      os.makedirs(folder, exist_ok=True)
      io.atomicWrite(os.path.join(
          folder, f'master-{self._masterProgressDumpIdx:09d}'),
          pickle.dumps(total))
      self._masterProgressDumpIdx += 1
      for fn in os.listdir(folder):
        if not fn.startswith('master-'):
          continue
        path = os.path.join(folder, fn)
        try:
          if now - os.path.getmtime(path) > 10:
            os.remove(path)
        except OSError:
          pass
    return total

  def performanceDescription(self):
    '''Throughput summary (reference: results_store.py:552-556).'''
    dt = max(time.time() - self.t0, 1e-9)
    return (f'{self.totalTracedRays/dt*3600:.3g} rays/hour, '
            f'{self.totalRecordedHits/dt*3600:.3g} recorded hits/hour '
            f'({self.totalTracedRays/dt:.3g} rays/s)')

  # ------------------------------------------------------------- histograms

  def writeHistogramSnapshot(self, sourceLabel, histograms, histMeta):
    '''Persist cumulative on-device detector histograms for a
    histogram-first recording run. Snapshots are cumulative PER WORKER
    (process/thread), so files are keyed by the worker fingerprint and a
    newer snapshot supersedes and deletes only THIS worker's previous one
    — multiple workers sharing a run folder (runMultiprocess with
    recording='histogram') each keep their latest snapshot and
    loadHistogramSnapshots sums them (the histogram analog of the
    reference's per-worker progress summing, results_store.py:462-550).
    histograms: dict(power (D,H,W), counts); histMeta: dict(bounds (D,4),
    detLabels).'''
    self._raiseIfCleanedUp()
    folder = os.path.join(self.runPath(), f'source-{sourceLabel}')
    os.makedirs(folder, exist_ok=True)
    payload = dict(power=np.asarray(histograms['power']),
                   counts=np.asarray(histograms['counts']),
                   bounds=np.asarray(histMeta['bounds']),
                   detLabels=np.asarray(
                       [str(l) for l in histMeta['detLabels']]))
    ownKey = f'pid{os.getpid()}-thread{threading.get_ident()}'
    path = os.path.join(folder, f'{self._fingerprint()}-histograms.npz')
    # (should a snapshot get the name of the one before, it replaces that
    # file and must not be deleted with it)
    old = [f for f in glob.glob(os.path.join(folder, '*-histograms.npz'))
           if _histogramWorkerKey(os.path.basename(f)) == ownKey
           and f != path]
    _saveNpz(path, payload)
    for f in old:
      try:
        os.remove(f)
      except OSError:
        pass


  # ----------------------------------------------------------------- cleanup

  def cleanup(self):
    if not self._cleanedUp:
      self.flush()
      try:
        native_store.drain()   # wait for spooled writes to hit the disk
      except Exception as e:
        io.warn(str(e))
      self._cleanedUp = True


def _histogramWorkerKey(filename):
  '''Stable worker key of a histogram-snapshot filename
  '<ts>-pid<P>-thread<T>-histograms.npz' — the pid/thread fields of the
  fingerprint. Snapshots are cumulative per worker; the loader sums the
  latest snapshot of each worker.'''
  parts = filename.split('-')
  pidThread = [p for p in parts
               if p.startswith('pid') or p.startswith('thread')]
  return '-'.join(pidThread) if pidThread else filename


def loadHistogramSnapshots(runPath):
  '''Summed latest-per-worker histogram snapshots per source of a
  histogram-first run:
  {sourceLabel: {detLabel: dict(power (H,W), counts, bounds (4,))}}.
  Each worker's snapshots are cumulative, so per worker only the latest
  (largest timestamp) file counts; workers are independent streams and
  their histograms add.'''
  out = {}
  for srcFolder in glob.glob(os.path.join(runPath, 'source-*')):
    files = glob.glob(os.path.join(srcFolder, '*-histograms.npz'))
    if not files:
      continue
    latestPerWorker = {}
    for f in files:
      name = os.path.basename(f)
      try:
        ts = int(name.split('-', 1)[0])
      except ValueError:
        ts = 0
      key = _histogramWorkerKey(name)
      if key not in latestPerWorker or ts > latestPerWorker[key][0]:
        latestPerWorker[key] = (ts, f)
    power = counts = None
    data = None
    for _ts, f in sorted(latestPerWorker.values()):
      data = {k: v for k, v in np.load(f, allow_pickle=False).items()}
      power = data['power'] if power is None else power + data['power']
      counts = data['counts'] if counts is None else counts + data['counts']
    dets = {}
    for d, label in enumerate(data['detLabels']):
      dets[str(label)] = dict(power=power[d],
                              counts=counts[d],
                              bounds=data['bounds'][d])
    out[os.path.basename(srcFolder)[len('source-'):]] = dets
  return out


def chunkFiles(runPath, targetBytes=CHUNK_TARGET_BYTES, olderThanSeconds=60):
  '''Merge small result files into larger chunks (reference:
  results_store.py:74-181, 670-674). Only touches files idle for
  `olderThanSeconds` to avoid racing an active writer.'''
  now = time.time()
  merged = 0
  for folder, _dirs, _files in os.walk(runPath):
    for kind in ('hits', 'rays'):
      group = sorted(
          f for f in resultFilePaths(folder, kind)
          if now - os.path.getmtime(f) > olderThanSeconds)
      if len(group) < 2:
        continue
      total = sum(os.path.getsize(f) for f in group)
      if total > targetBytes:
        continue
      dicts = [loadResultFile(f) for f in group]
      if kind == 'hits':
        out = {}
        keys = set().union(*[set(d.keys()) for d in dicts])
        for k in keys:
          if k in ('source', 'obj'):
            out[k] = dicts[0][k]
            continue
          ref = next((np.asarray(d[k]) for d in dicts if k in d), None)
          tailShape = ref.shape[1:] if ref is not None else ()
          cols = []
          for d in dicts:
            n = len(d['points'])
            cols.append(d[k] if k in d else np.full((n,) + tailShape, np.nan))
          out[k] = np.concatenate(cols)
      else:
        points = np.concatenate([d['points'] for d in dicts])
        powers = np.concatenate([d['powers'] for d in dicts])
        media = np.concatenate([d['media'] for d in dicts])
        offs, base = [], 0
        for d in dicts:
          o = np.asarray(d['offsets'])
          offs.append(o[:-1] + base)
          base += o[-1]
        out = dict(points=points, powers=powers, media=media,
                   offsets=np.concatenate(offs + [[base]]))
      # normalize the output stem: strip any trailing '-chunk' repetitions so
      # re-merging chunks yields '<ts>-hits-chunk', never '-chunk-chunk'
      # (which resultFilePaths would stop matching — data would vanish from
      # loaders after the second merge)
      stem = os.path.basename(group[0]).rsplit('.', 1)[0]
      while stem.endswith('-chunk'):
        stem = stem[:-len('-chunk')]
      written = _saveColumns(os.path.join(folder, f'{stem}-chunk'), out)
      native_store.drain()
      for f in group:
        if os.path.abspath(f) != os.path.abspath(written):
          os.remove(f)
      merged += len(group)
  return merged
