'''Retry decorator (reference: jupyter_utils/retries.py:17-40).'''

import functools
import time

from ..utils import io


def retryOnError(subject='operation', maxRetries=3,
                 callbackAfterRetries=None, callback=None, delay=0.,
                 fatal=()):
  '''Retry the wrapped callable up to maxRetries times; `callback` runs after
  every failure, `callbackAfterRetries` once all retries are exhausted (the
  reference uses it to restart a wedged FreeCAD instance). Exceptions of the
  `fatal` types are not retried: they pass straight through.'''

  def decorator(fn):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
      lastErr = None
      for attempt in range(int(maxRetries) + 1):
        try:
          return fn(*args, **kwargs)
        except fatal:
          raise
        except Exception as e:
          lastErr = e
          io.warn(f'{subject} failed (attempt {attempt + 1}/'
                  f'{maxRetries + 1}): {e}')
          if callback is not None:
            callback()
          if delay:
            time.sleep(delay)
      if callbackAfterRetries is not None:
        callbackAfterRetries()
      raise lastErr
    return wrapper

  return decorator
