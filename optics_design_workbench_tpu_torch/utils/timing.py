'''
Timer utilities (reference: freecad/optics_design_workbench/timing.py:18 —
IntervalTimer; the reference's FrequencyTimer, ProgressTracker and Condition
have no caller in this package yet and are not copied).
'''

import time


class IntervalTimer:
  '''Fires at most once per `interval` seconds; optional jitter fraction
  desynchronizes many workers (reference: timing.py:18).'''

  def __init__(self, interval, jitter=0., fireImmediately=False):
    self.interval = float(interval)
    self.jitter = float(jitter)
    self._next = time.time() if fireImmediately else time.time() + self._span()

  def _span(self):
    if self.jitter:
      import random
      return self.interval * (1 + self.jitter * (2 * random.random() - 1))
    return self.interval

  def check(self):
    '''Return True (and re-arm) if the interval elapsed.'''
    now = time.time()
    if now >= self._next:
      self._next = now + self._span()
      return True
    return False
