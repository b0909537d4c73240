'''
Progress tracking for notebooks: a background thread reads the
`progress/master-*` snapshots the running simulation dumps and renders
`iter x/y, hits a/b, rays c/d` lines with an ETA (reference:
jupyter_utils/progress.py:30-197).
'''

import glob
import os
import pickle
import sys
import threading
import time

from ..utils import io


class ProgressTracker:

  def __init__(self, refreshSeconds=1., silent=False, stream=None):
    self.refreshSeconds = refreshSeconds
    self.silent = silent
    self.stream = stream or sys.stdout
    self._watchPath = None
    self._thread = None
    self._stop = threading.Event()
    self._lastLine = ''
    self.latest = None

  def watch(self, runPath):
    self._watchPath = str(runPath)
    if self._thread is None or not self._thread.is_alive():
      self._stop.clear()
      self._thread = threading.Thread(target=self._loop, daemon=True)
      self._thread.start()
    return self

  def stop(self):
    self._stop.set()
    if self._thread is not None:
      self._thread.join(timeout=2)

  def _readLatest(self):
    if self._watchPath is None:
      return None
    masters = sorted(glob.glob(os.path.join(self._watchPath, 'progress',
                                            'master-*')))
    if not masters:
      return None
    try:
      with open(masters[-1], 'rb') as f:
        return pickle.load(f)
    except Exception:
      return None

  @staticmethod
  def formatLine(p):
    def frac(k, limitKey):
      total = p.get(limitKey, float('inf'))
      cur = p.get(k, 0)
      if total in (None, float('inf')):
        return f'{cur:g}'
      return f'{cur:g}/{total:g}'
    line = (f"iter {frac('totalIterations', 'endAfterIterations')}, "
            f"rays {frac('totalTracedRays', 'endAfterRays')}, "
            f"hits {frac('totalRecordedHits', 'endAfterHits')}")
    # ETA from the most constraining criterion
    etaCandidates = []
    elapsed = p.get('elapsedSeconds', 0)
    for k, limitKey in (('totalIterations', 'endAfterIterations'),
                        ('totalTracedRays', 'endAfterRays'),
                        ('totalRecordedHits', 'endAfterHits')):
      total, cur = p.get(limitKey), p.get(k, 0)
      if total and total != float('inf') and cur:
        etaCandidates.append(elapsed * (total - cur) / cur)
    if etaCandidates:
      line += f' (ETA {io.secondsToStr(max(0, min(etaCandidates)))})'
    if p.get('reachedEnd'):
      line += ' [done]'
    return line

  def _loop(self):
    while not self._stop.is_set():
      p = self._readLatest()
      if p is not None:
        self.latest = p
        if not self.silent:
          line = self.formatLine(p)
          if line != self._lastLine:
            print('\r' + line + ' ' * 8, end='', file=self.stream,
                  flush=True)
            self._lastLine = line
        if p.get('reachedEnd'):
          if not self.silent:
            print(file=self.stream)
          break
      time.sleep(self.refreshSeconds)


_GLOBAL_TRACKER = None


def setupProgressTracker(refreshSeconds=1., silent=False):
  '''Install the global tracker used by Document.runSimulation
  (reference: jupyter_utils/__init__.py:11-16, progress.py:30-45).'''
  global _GLOBAL_TRACKER
  if _GLOBAL_TRACKER is not None:
    _GLOBAL_TRACKER.stop()
  _GLOBAL_TRACKER = ProgressTracker(refreshSeconds=refreshSeconds,
                                    silent=silent)
  return _GLOBAL_TRACKER


def globalTracker():
  return _GLOBAL_TRACKER
