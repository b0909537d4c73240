'''
Shared helpers for the scene object model: expression/domain parsing with the
reference's sanitization semantics (reference: freecad_elements/common.py:
226-294 `_parsedDomain`; string-typed numerics allowing 'inf', 'pi/4',
'num_cpus' — SURVEY.md section 5 "Config / flag system").
'''

import numpy as np
import sympy as sy


def evalExpr(value):
  '''Evaluate a numeric scalar that may be given as a sympy-style expression
  string ("pi/4", "inf", "1e5") or a plain number.'''
  if isinstance(value, str):
    s = value.strip().lower()
    if s in ('inf', '+inf', 'infinity'):
      return np.inf
    if s in ('-inf', '-infinity'):
      return -np.inf
    return float(sy.sympify(value).evalf())
  return float(value)


def parseDomain(raw, default=None, limits=(-np.inf, np.inf),
                spanLimits=(0, np.inf)):
  '''
  Parse a '<lo>, <hi>' domain string into floats, clamping each bound to
  `limits` and the span to `spanLimits`; fall back to `default` when
  unparseable (reference: common.py:226-294). Returns (canonicalString,
  (lo, hi)).
  '''
  def _parse(text):
    parts = [p for p in str(text).split(',') if p.strip()]
    if len(parts) != 2:
      raise ValueError(f'domain must have exactly two entries: {text!r}')
    lo, hi = sorted(evalExpr(p) for p in parts)
    return lo, hi

  try:
    lo, hi = _parse(raw)
  except Exception:
    if default is None:
      raise
    lo, hi = _parse(default)

  l1, l2 = (evalExpr(limits[0]), evalExpr(limits[1]))
  lo, hi = max(lo, l1), min(hi, l2)
  s1, s2 = (evalExpr(spanLimits[0]), evalExpr(spanLimits[1]))
  if hi - lo < s1:
    hi = lo + s1
  if hi - lo > s2:
    hi = lo + s2
  canonical = f'{lo:g}, {hi:g}'
  return canonical, (lo, hi)


class PropertyMixin:
  '''Declarative property schema: subclasses define _properties() returning
  [(group, [(name, default, doc), ...]), ...]; instances get attributes with
  the defaults, overridable via constructor kwargs. Attribute names keep the
  reference's FreeCAD property spelling (e.g. `source.PowerDensity`) so
  existing user code and muscle memory carry over (the plain-Python analog
  of GenericFreecadElementProxy's property plumbing, common.py:180-195).'''

  def _applyProperties(self, kwargs):
    for _group, props in self._properties():
      for name, default, _doc in props:
        setattr(self, name, kwargs.pop(name) if name in kwargs else default)
    if kwargs:
      raise TypeError(f'unknown properties: {sorted(kwargs)}')

  def __getattr__(self, name):
    # forward compatibility for pickled scenes: an instance saved before a
    # property was added to the schema unpickles without that attribute —
    # fall back to the schema default instead of AttributeError (the
    # reference gets the same behavior from FreeCAD re-adding missing
    # properties on document load, common.py:180-195)
    if name.startswith('_'):
      raise AttributeError(name)
    for _g, props in self._properties():
      for pname, default, _doc in props:
        if pname == name:
          object.__setattr__(self, name, default)
          return default
    raise AttributeError(name)

  def propertyNames(self):
    return [name for _g, props in self._properties() for name, _d, _ in props]

  def propertiesDict(self):
    return {name: getattr(self, name) for name in self.propertyNames()}
