'''
Document API for notebooks — the counterpart of the reference's
remote-control `FreecadDocument` (reference: jupyter_utils/
freecad_document.py) and of the JAX package's jupyter_utils/document.py. The
reference drives a headless FreeCAD subprocess over a stdin REPL; here the
scene is a plain Python object so the document runs in-process, while
keeping the same user-facing surface:

  * `Document(path)` with path autodetection (unique scene file in cwd, or
    the enclosing `.OpticsDesign` folder — freecad_document.py:411-475),
  * `workInTempCopy` semantics with aged tmp cleanup (:487-615),
  * attribute-style object access `doc.Source.PowerDensity = ...` (:132-408),
  * `runSimulation(action, endIf=...)` returning a `RawFolder` (:631-761),
  * `rawFolders` / `latestRawFolder` / `rawFolderByIndex` (:1299-1338),
  * `RawFolder.loadHits/loadGlobalInfo/tree` (:1341-1452) and
    `RawFolderRange` multi-run concatenation (:1454-1487).

Scene files are pickles of the models.Scene object (`<name>.scene.pkl`).
Run folders are the layout `simulation.runSimulation` writes (`odwc` and
`npz` result files), which is the JAX package's, so either package's
`RawFolder` reads the other's runs.

`RawFolder.loadRays` reads the ray polylines of sources with RecordRays,
`RawFolder.drawnRays` the DrawnRays of a `draw=` run (simulation/draw.py).
`Document` takes `device=` (default 'cuda') and hands it to `runSimulation`.
'''

import glob
import os
import pickle
import shutil
import time
import uuid

import numpy as np

from .. import simulation
from ..simulation import results_store
from ..models import Scene
from ..utils import io
from .hits import Hits

SCENE_SUFFIX = '.scene.pkl'


def _findScenePath(path=None):
  '''Scene file autodetection (reference: freecad_document.py:411-475).'''
  if path is not None:
    if path.rstrip('/').endswith('.OpticsDesign'):
      base = path.rstrip('/')[:-len('.OpticsDesign')]
      return base + SCENE_SUFFIX
    if not path.endswith(SCENE_SUFFIX) and not os.path.exists(path):
      path = path + SCENE_SUFFIX
    return path
  # look in cwd, then in an enclosing .OpticsDesign folder
  cwd = os.getcwd()
  candidates = glob.glob(os.path.join(cwd, '*' + SCENE_SUFFIX))
  if len(candidates) == 1:
    return candidates[0]
  parts = cwd.split(os.sep)
  for i in range(len(parts), 0, -1):
    folder = os.sep.join(parts[:i])
    if folder.endswith('.OpticsDesign'):
      return folder[:-len('.OpticsDesign')] + SCENE_SUFFIX
  raise FileNotFoundError(
      'could not autodetect a scene file: pass a path, or run from a folder '
      'containing exactly one *.scene.pkl or from inside a .OpticsDesign '
      'folder')


def saveScene(scene, path=None):
  path = path or (scene.path or scene.label) + SCENE_SUFFIX
  if not path.endswith(SCENE_SUFFIX):
    path += SCENE_SUFFIX
  io.atomicWrite(path, pickle.dumps(scene))
  return path


def loadScene(path):
  with open(path, 'rb') as f:
    scene = pickle.load(f)
  if not isinstance(scene, Scene):
    raise TypeError(f'{path} does not contain a Scene')
  return scene


class Document:

  def __init__(self, path=None, scene=None, workInTempCopy=False,
               showProgress=True, device='cuda'):
    self.device = device
    if scene is not None:
      self.scene = scene
      self.scenePath = (scene.path or scene.label) + SCENE_SUFFIX
    else:
      self.scenePath = _findScenePath(path)
      self.scene = loadScene(self.scenePath)
    self._originalPath = self.scenePath
    self.showProgress = showProgress

    if workInTempCopy:
      resultsFolder = self.resultsFolderPath()
      tmpFolder = os.path.join(resultsFolder, 'tmp')
      os.makedirs(tmpFolder, exist_ok=True)
      self._cleanupAgedTempCopies(tmpFolder)
      base = os.path.basename(self.scenePath)[:-len(SCENE_SUFFIX)]
      tmpPath = os.path.join(tmpFolder,
                             f'{base}-{uuid.uuid4().hex[:8]}{SCENE_SUFFIX}')
      if os.path.exists(self.scenePath):
        shutil.copy(self.scenePath, tmpPath)
      self.scenePath = tmpPath
      self.scene.path = tmpPath[:-len(SCENE_SUFFIX)]

  @staticmethod
  def _cleanupAgedTempCopies(tmpFolder, maxAgeSeconds=7 * 86400):
    now = time.time()
    for f in glob.glob(os.path.join(tmpFolder, '*' + SCENE_SUFFIX)):
      try:
        if now - os.path.getmtime(f) > maxAgeSeconds:
          os.remove(f)
      except OSError:
        pass

  # ---------------------------------------------------------- scene plumbing

  def __getattr__(self, name):
    # delegate unknown attributes to scene objects by label
    if name.startswith('_') or name == 'scene':
      raise AttributeError(name)
    try:
      return self.__dict__['scene'].getObject(name)
    except KeyError:
      raise AttributeError(name)

  def __enter__(self):
    return self

  def __exit__(self, *exc):
    self.close()
    return False

  def open(self):
    return self

  def close(self):
    '''No subprocess to terminate (unlike freecad_document.py:1164-1250);
    sets the cancel flag so a concurrently running simulation stops.'''
    lc = simulation.Lifecycle(self.resultsFolderPath())
    if lc.isRunning():
      lc.setIsCanceled(True)

  def save(self, path=None):
    return saveScene(self.scene, path or self.scenePath)

  def resultsFolderPath(self):
    return simulation.getResultsFolderPath(
        self.scene.path or self.scene.label)

  # ------------------------------------------------------------- simulation

  def runSimulation(self, action='true', endIf=None, endIfMaxLoad=0.2,
                    seed=None, **kwargs):
    '''Run a simulation and return the RawFolder of the new run (reference:
    freecad_document.py:631-761). `endIf(rawFolder)` is polled between
    iterations and ends the run when it returns truthy; `endIfMaxLoad`
    duty-cycle-limits the callback so an expensive endIf (loading and
    histogramming every flush) cannot eat more than that fraction of the
    run's wall clock — polls arriving too soon are skipped (reference:
    freecad_document.py:631-761 endIfMaxLoad semantics).'''
    endIfWrapper = None
    if endIf is not None:
      state = dict(nextAllowed=0.)

      def endIfWrapper(runPath):
        now = time.monotonic()
        if now < state['nextAllowed']:
          return False
        t0 = now
        result = bool(endIf(RawFolder(runPath)))
        cost = time.monotonic() - t0
        # a callback that took `cost` seconds earns cost*(1-load)/load
        # of cooldown so its long-run share stays <= endIfMaxLoad
        load = min(max(float(endIfMaxLoad), 1e-3), 1.)
        state['nextAllowed'] = t0 + cost + cost * (1. - load) / load
        return result
    kwargs.setdefault('device', self.device)
    runPath = simulation.runSimulation(self.scene, action,
                                       endIf=endIfWrapper, seed=seed,
                                       **kwargs)
    return RawFolder(runPath) if runPath else None

  # ----------------------------------------------------------- raw folders

  def rawFolders(self):
    return rawFolders(self.resultsFolderPath())

  def rawFolderByIndex(self, index):
    return rawFolderByIndex(self.resultsFolderPath(), index)

  def latestRawFolder(self):
    return latestRawFolder(self.resultsFolderPath())


# alias for drop-in familiarity with the reference API
FreecadDocument = Document


def rawFolders(resultsFolder=None):
  '''All raw run folders, oldest first (reference:
  freecad_document.py:1299-1338).'''
  if resultsFolder is None:
    resultsFolder = os.getcwd()
  paths = sorted(glob.glob(os.path.join(resultsFolder, 'raw',
                                        'simulation-run-*')))
  return [RawFolder(p) for p in paths]


def rawFolderByIndex(resultsFolder, index):
  folders = rawFolders(resultsFolder)
  if not folders:
    return None
  return folders[index]


def latestRawFolder(resultsFolder=None):
  return rawFolderByIndex(resultsFolder, -1)


def updateResultEntry(entry, new):
  '''Merge two columnar hit dicts by concatenating columns, nan-padding
  missing metadata (reference: results_store.py updateResultEntry).'''
  if entry is None:
    return {k: np.asarray(v) for k, v in new.items()}
  out = dict(entry)
  nOld = len(np.asarray(entry.get('points', [])))
  nNew = len(np.asarray(new.get('points', [])))
  keys = set(entry) | set(new)
  for k in keys:
    if k in ('source', 'obj'):
      out[k] = entry.get(k, new.get(k))
      continue
    a = np.asarray(entry[k]) if k in entry else np.full((nOld,), np.nan)
    b = np.asarray(new[k]) if k in new else np.full((nNew,), np.nan)
    if a.ndim != b.ndim:
      # scalar metadata sneaked in; skip silently
      continue
    out[k] = np.concatenate([a, b])
  return out


class RawFolder:
  '''One `raw/simulation-run-NNNNNN` results folder (reference:
  freecad_document.py:1341-1452).'''

  def __init__(self, path):
    self.path = str(path)

  def __repr__(self):
    return f'RawFolder({self.path!r})'

  def uid(self):
    for f in os.listdir(self.path):
      if f.startswith('uid-'):
        return f[4:]
    return None

  def exists(self):
    return os.path.isdir(self.path)

  def tree(self):
    out = []
    for folder, _dirs, files in sorted(os.walk(self.path)):
      rel = os.path.relpath(folder, self.path)
      out.append((rel, sorted(files)))
    return out

  def printTree(self):
    for rel, files in self.tree():
      print(rel + '/')
      for f in files:
        print('  ' + f)

  def loadGlobalInfo(self):
    with open(os.path.join(self.path, 'global-info.pkl'), 'rb') as f:
      return pickle.load(f)

  def _hitFiles(self, source='*', obj='*'):
    out = []
    for folder in glob.glob(os.path.join(self.path, f'source-{source}',
                                         f'object-{obj}')):
      out.extend(results_store.resultFilePaths(folder, 'hits'))
    return sorted(out)

  def loadHits(self, obj='*', source='*'):
    '''Load and merge all hit files for matching source/object labels;
    returns a Hits wrapper (reference: freecad_document.py:1433-1452).
    Folders fragmented into many small files are chunk-merged on load,
    the analog of the reference's findPathsAndSanitize
    (results_store.py:670-674) — otherwise only the hourly runner timer
    ever consolidates them.'''
    files = self._hitFiles(source=source, obj=obj)
    if len(files) > 32:
      try:
        results_store.chunkFiles(self.path, olderThanSeconds=60)
      except Exception as e:
        io.warn(f'merge-on-load failed (continuing unmerged): {e}')
    entry = None
    for f in self._hitFiles(source=source, obj=obj):
      data = results_store.loadResultFile(f)
      entry = updateResultEntry(entry, {k: v for k, v in data.items()
                                        if getattr(v, 'ndim', 0) > 0})
    return Hits(entry or {})

  def loadRays(self, source='*'):
    '''Load ray polylines: list of dicts(points (K+1,3), powers (K,),
    media list) like SimulationResultsSingleRay.dump
    (results_store.py:232-257).'''
    from ..simulation import results_store
    rays = []
    files = []
    for folder in glob.glob(os.path.join(self.path, f'source-{source}')):
      files.extend(results_store.resultFilePaths(folder, 'rays'))
    for f in sorted(files):
      data = results_store.loadResultFile(f)
      points, powers, media, offsets = (data['points'], data['powers'],
                                        data['media'], data['offsets'])
      segBase = 0
      for i in range(len(offsets) - 1)[:]:
        a, b = int(offsets[i]), int(offsets[i + 1])
        k = b - a - 1  # segments in this ray
        rays.append(dict(points=points[a:b],
                         powers=powers[segBase:segBase + k],
                         media=list(media[segBase:segBase + k])))
        segBase += k
    return rays

  def drawnRays(self):
    '''Load the DrawnRays snapshot of a `runSimulation(..., draw=True)`
    run (drawn-rays.npz), or None if the run did not draw — the notebook
    hook for the headless ray view (simulation/draw.py).'''
    from ..simulation.draw import DrawnRays
    if not os.path.exists(os.path.join(self.path, 'drawn-rays.npz')):
      return None
    return DrawnRays.load(self.path)

  def progress(self):
    '''Latest aggregated progress snapshot.'''
    masters = sorted(glob.glob(os.path.join(self.path, 'progress',
                                            'master-*')))
    if not masters:
      return None
    with open(masters[-1], 'rb') as f:
      return pickle.load(f)


class RawFolderRange:
  '''Concatenated view over several runs (reference:
  freecad_document.py:1454-1487).'''

  def __init__(self, folders):
    self.folders = [f if isinstance(f, RawFolder) else RawFolder(f)
                    for f in folders]

  def __iter__(self):
    return iter(self.folders)

  def __len__(self):
    return len(self.folders)

  def loadHits(self, obj='*', source='*'):
    entry = None
    for folder in self.folders:
      h = folder.loadHits(obj=obj, source=source)
      if len(h.hits):
        entry = updateResultEntry(entry, h.hits)
    return Hits(entry or {})

  def loadRays(self, source='*'):
    out = []
    for folder in self.folders:
      out.extend(folder.loadRays(source=source))
    return out
