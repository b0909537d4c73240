'''
Simulation lifecycle via filesystem flag files, with stale-run recovery —
the reference's control plane, kept so external tools (endIf callbacks,
progress trackers, cancel buttons, other processes) interoperate
(reference: simulation/processes/simulation_loop.py:174-273):

  simulation-is-running / simulation-is-canceled / simulation-is-done
  flag files in the `.OpticsDesign` folder; a canceled-but-still-running
  state older than ASSUME_DEAD_TIMEOUT is treated as a dead run.
'''

import os
import time

from ..utils import io

ASSUME_DEAD_TIMEOUT = 15  # seconds (simulation_loop.py:67)


class Lifecycle:

  def __init__(self, resultsFolder):
    self.resultsFolder = resultsFolder

  def _path(self, name):
    return os.path.join(self.resultsFolder, name)

  def _query(self, name):
    return os.path.exists(self._path(name))

  def _set(self, name, state):
    path = self._path(name)
    if state and not os.path.exists(path):
      os.makedirs(os.path.dirname(path), exist_ok=True)
      with open(path, 'w'):
        pass
    elif not state and os.path.exists(path):
      try:
        os.remove(path)
      except FileNotFoundError:
        pass

  # ------------------------------------------------------------------- flags

  def isRunning(self, attemptCleanup=True):
    if not self._query('simulation-is-running'):
      return False
    if not self.isCanceled():
      return True
    if attemptCleanup:
      canceledAt = os.stat(self._path('simulation-is-canceled')).st_mtime
      if time.time() - canceledAt > ASSUME_DEAD_TIMEOUT:
        io.warn(f'simulation was canceled {time.time()-canceledAt:.0f}s ago '
                f'but is-running file still exists, assuming it died without '
                f'proper clean-up')
        self.setIsRunning(False)
        return False
    return True

  def setIsRunning(self, state):
    self._set('simulation-is-running', state)

  def isCanceled(self):
    return self._query('simulation-is-canceled')

  def setIsCanceled(self, state):
    self._set('simulation-is-canceled', state)

  def isFinished(self):
    return self._query('simulation-is-done')

  def setIsFinished(self, state):
    self._set('simulation-is-done', state)

  def clearAll(self):
    for name in ('simulation-is-running', 'simulation-is-canceled',
                 'simulation-is-done'):
      self._set(name, False)

  def touchRunning(self):
    '''Refresh the is-running mtime as a liveness heartbeat.'''
    path = self._path('simulation-is-running')
    if os.path.exists(path):
      os.utime(path)


class SimulationEnded(Exception):
  '''Control-flow exception raised when a run should stop (reference:
  freecad_elements/common.py:155).'''
