'''
On-device sampling from compiled random variables (counterpart of the JAX
package's distributions/device_sampler.py).

The compiled per-variable conditional inverse-CDF transforms are exported as
tables so that source sampling runs on the device: millions of (theta, phi)
draws per step, chained conditionally, from an explicit `torch.Generator`
(the stand-in for a jax key — the two libraries give different numbers from
the same seed, so tests feed both sides numpy-made uniforms instead).

Table construction and the piecewise-polynomial fit are host numpy and
repeat the reference's arithmetic, so both packages build the same tables.
Ported here: `buildDeviceTables`, `deviceDraw`, `tentInterp`, `evalPwpoly`,
`fitPiecewisePoly`. The 2-D / low-rank / discrete-event scatter fits are not
ported yet.
'''

import numpy as np
import torch

from .. import resolveDevice

_TENT_Q = 257


def tentInterp(table, u):
  '''Linear interpolation of `table` ((Q,), tabulated on a uniform [0,1]
  grid) at quantiles u. The reference sums Q tent weights
  max(0, 1 - |pos - q|) * table[q]; all but the two knots around `pos` are
  exactly zero, so this gathers those two and adds them in knot order —
  the same float result without a (N, Q) weight matrix.'''
  Q = table.shape[0]
  pos = u * (Q - 1)
  j = torch.clamp(pos.to(torch.int64), 0, Q - 2)
  jf = j.to(u.dtype)
  w0 = torch.clamp(1. - torch.abs(pos - jf), min=0.)
  w1 = torch.clamp(1. - torch.abs(pos - (jf + 1.)), min=0.)
  return w0 * table[j] + w1 * table[j + 1]


def nearestIndex(grid, x):
  '''Index of the nearest entry of sorted 1-D `grid` for each x (device).'''
  pos = torch.clamp(torch.searchsorted(grid, x), 1, grid.shape[0] - 1)
  lo, hi = grid[pos - 1], grid[pos]
  return torch.where(torch.abs(x - lo) <= torch.abs(hi - x), pos - 1, pos)


def _tablesFromTransform(vrv, varI, npDtype):
  '''Build the host table dict for one variable of a compiled
  VectorRandomVariable.'''
  import sympy as sy
  from .random_variables import _NumericTransform

  t = vrv._transforms[varI]
  discreteVals = np.asarray(getattr(t, 'discreteVals', np.zeros(0)), dtype=float)
  discreteProbs = np.asarray(getattr(t, 'discreteProbs', np.zeros(0)), dtype=float)

  if isinstance(t, _NumericTransform):
    values, cdf, laterGrids = t.values, t.cdf, t.laterGrids
  else:
    # analytic mode: tabulate the continuum part numerically
    smooth = (vrv._probabilityDensityExpr
              .replace(sy.Heaviside, lambda *a: 0)
              .replace(sy.DiracDelta, lambda *a: 0))
    if smooth == 0 and len(discreteVals):
      # purely discrete variable: dummy continuum table (never selected
      # because the discrete probabilities sum to one)
      l1, l2 = vrv._variableDomains.get(str(vrv._variables[varI]), (0., 1.))
      values = np.linspace(l1, l2, 2)
      cdf = np.array([[0., 1.]])
      laterGrids = []
    else:
      num = vrv._numericTransform(varI, exprOverride=smooth)
      values, cdf, laterGrids = num.values, num.cdf, num.laterGrids

  # zero-mass conditional rows would be NaN; replace with a uniform ramp so
  # they cannot poison downstream arithmetic (they are only reachable via
  # measure-zero conditioning values)
  ramp = np.linspace(0., 1., cdf.shape[1])
  cdf = np.where(np.isnan(cdf), ramp[None, :], cdf)

  # conditioning grids come from linspace in practice: record uniform-grid
  # parameters so nearest-index lookups become a round() instead of a
  # searchsorted
  gridMeta = []
  for g in laterGrids:
    g = np.asarray(g, dtype=float)
    steps = np.diff(g)
    uniform = len(g) > 1 and np.allclose(steps, steps[0], rtol=1e-6)
    gridMeta.append((bool(uniform), float(g[0]),
                     float(steps[0]) if len(g) > 1 else 1., len(g)))
  return dict(
      values=np.asarray(values, dtype=npDtype),
      cdf=np.asarray(cdf, dtype=npDtype),
      laterGrids=tuple(np.asarray(g, dtype=npDtype) for g in laterGrids),
      laterGridMeta=tuple(gridMeta),
      discreteVals=np.asarray(discreteVals, dtype=npDtype),
      discreteCum=np.cumsum(discreteProbs).astype(npDtype),
  )


def buildDeviceTables(vrv, dtype=np.float32, quantileRes=4097):
  '''
  Export a compiled VectorRandomVariable as a tuple of per-variable table
  dicts, ordered like vrv._variables. Pass the result to `deviceDraw`. When
  a `variableOrder` was given, the output rows of `deviceDraw` follow it.

  Leaves are HOST numpy arrays (deviceDraw moves what it gathers from to its
  device once and caches it there). Each variable carries a pre-inverted CDF
  tabulated on a uniform quantile grid (`invCdf`, shape (M, quantileRes)),
  with the structure flags the draw exploits:
    * affine rows (uniform marginal)   -> closed form, no gathers
    * all rows identical (separable)   -> no row-index conditioning
    * (v[j], v[j+1]) pair rows         -> one 2-wide gather, not two
  '''
  if vrv._transforms is None:
    vrv.compile()
  npDtype = np.dtype(dtype)
  q = np.linspace(0., 1., quantileRes)
  tables = []
  for i in range(len(vrv._variables)):
    t = _tablesFromTransform(vrv, i, npDtype)
    cdf = np.asarray(t['cdf'], dtype=np.float64)
    values = np.asarray(t['values'], dtype=np.float64)
    inv = np.stack([np.interp(q, row, values) for row in cdf])
    rowsEqual = bool(np.all(np.abs(inv - inv[0:1])
                            <= 1e-7 * max(np.ptp(values), 1e-30)))
    if rowsEqual:
      inv = inv[:1]
    lin = np.linspace(inv[0, 0], inv[0, -1], inv.shape[1])
    affine = rowsEqual and bool(
        np.all(np.abs(inv[0] - lin) <= 1e-6 * max(np.ptp(values), 1e-30)))
    t['invCdf'] = inv.astype(npDtype)
    pairs = np.stack([inv[:, :-1], inv[:, 1:]], axis=-1)  # (M, Q-1, 2)
    t['invCdfPairs'] = pairs.reshape(-1, 2).astype(npDtype)
    t['affine'] = (affine, float(inv[0, 0]), float(inv[0, -1]))
    t['rowsEqual'] = rowsEqual
    if rowsEqual and not affine:
      # small inverse table for the tent-interpolation path
      qs = np.linspace(0., 1., _TENT_Q)
      t['invCdfSmall'] = np.interp(qs, q, inv[0]).astype(npDtype)
    tables.append(t)
  names = [str(v) for v in vrv._variables]
  if vrv._variableOrder:
    order = tuple(names.index(v) for v in vrv._variableOrder if v in names)
  else:
    order = tuple(range(len(names)))
  return dict(tables=tuple(tables), order=order, names=tuple(names),
              _deviceCache={})


def _onDevice(deviceTables, i, name, dev):
  '''Tensor copy of host table `name` of variable i on `dev`, made once.'''
  cache = deviceTables['_deviceCache']
  key = (i, name, str(dev))
  if key not in cache:
    cache[key] = torch.as_tensor(deviceTables['tables'][i][name], device=dev)
  return cache[key]


def deviceDraw(deviceTables, generator, N, stratified=False, device='cuda',
               uniforms=None):
  '''
  Draw N samples on `device`; returns a float32 tensor of shape
  (numVariables, N) with rows ordered by the variable order the tables were
  built with. `generator` is a torch.Generator on that device.
  `stratified=True` feeds latin-hypercube quantiles through the same
  transforms. `uniforms` (optional, (numVariables, N), indexed like
  vrv._variables) replaces the generator's continuous draws — the seam the
  tests use to feed both packages the same numbers.
  '''
  dev = resolveDevice(device)
  tables = deviceTables['tables']
  k = len(tables)
  drawn = [None] * k

  def rand():
    return torch.rand((N,), generator=generator, device=dev,
                      dtype=torch.float32)

  for i in reversed(range(k)):
    t = tables[i]
    if uniforms is not None:
      u = uniforms[i]
    elif stratified:
      u = (torch.arange(N, dtype=torch.float32, device=dev) + rand()) / N
      u = u[torch.randperm(N, generator=generator, device=dev)]
    else:
      u = rand()
    Q = t['invCdf'].shape[1]
    affine, aLo, aHi = t['affine']
    if affine:
      # uniform marginal: closed form, no gathers at all
      out = aLo + u * (aHi - aLo)
    elif 'invCdfSmall' in t:
      out = tentInterp(_onDevice(deviceTables, i, 'invCdfSmall', dev), u)
    else:
      pos = u * (Q - 1)
      j = torch.clamp(pos.to(torch.int64), 0, Q - 2)
      frac = pos - j.to(pos.dtype)
      base = j
      if t['laterGrids'] and not t['rowsEqual']:
        rows = torch.zeros((N,), dtype=torch.int64, device=dev)
        for gi, (g, m) in enumerate(zip(t['laterGrids'],
                                        t['laterGridMeta'])):
          vals = drawn[i + 1 + gi]
          uniform, lo, step, L = m
          if uniform:
            near = torch.clamp(torch.round((vals - lo) / step)
                               .to(torch.int64), 0, L - 1)
          else:
            near = nearestIndex(torch.as_tensor(g, device=dev), vals)
          rows = rows * len(g) + near
        base = rows * (Q - 1) + j
      pair = _onDevice(deviceTables, i, 'invCdfPairs', dev)[base]
      v0, v1 = pair[:, 0], pair[:, 1]
      out = v0 + frac * (v1 - v0)

    if t['discreteVals'].shape[0]:
      u2 = rand()
      cum = _onDevice(deviceTables, i, 'discreteCum', dev)
      idx = torch.clamp(torch.searchsorted(cum, u2), 0, cum.shape[0] - 1)
      out = torch.where(u2 <= cum[-1],
                        _onDevice(deviceTables, i, 'discreteVals', dev)[idx],
                        out)
    drawn[i] = out

  result = torch.stack(drawn)
  return result[list(deviceTables['order'])]


def evalPwpoly(spec, u):
  '''Piecewise Horner evaluation of a fitPiecewisePoly spec on a float32
  tensor, in the in-kernel sampler's operation order: scaled coordinate
  (u - mid) * (1 / half) with both constants rounded to float32 first,
  ascending segments selected by `u >= a`, clamp to [lo, hi].'''
  _, segs, lo, hi = spec
  f32 = lambda x: float(np.float32(x))
  out = None
  for a, _b, mid, half, coeffs in segs:
    s = (u - f32(mid)) * f32(1.0 / half)
    acc = torch.full_like(u, f32(coeffs[-1]))
    for c in reversed(coeffs[:-1]):
      acc = acc * s + f32(c)
    out = acc if out is None else torch.where(u >= f32(a), acc, out)
  return torch.clamp(out, f32(lo), f32(hi))


def fitPiecewisePoly(inv, maxSegments=12, deg=9, relTol=5e-3):
  '''Fit the tabulated inverse CDF `inv` (uniform quantile grid) as a few
  Horner polynomials in per-segment scaled coordinates, for the in-kernel
  sampler (ops/cuda_trace 'pwpoly' marginals). Inverse CDFs of truncated
  smooth densities have boundary layers at u=0 (sqrt from the area
  Jacobian) and u=1 (thin tail), so fitting starts from the segment split
  [0, .03, .97, 1] and refines the worst segment until the max error is
  below relTol * range. Returns ('pwpoly', segments, lo, hi) or None if the
  tolerance is unmet at maxSegments.'''
  q = np.linspace(0., 1., inv.shape[0])
  qd = np.linspace(0., 1., 40001)
  ref = np.interp(qd, q, inv)
  rng = max(np.ptp(inv), 1e-30)
  splits = [0., .03, .97, 1.]

  def fit(splits):
    segs, errs = [], []
    for a, b in zip(splits[:-1], splits[1:]):
      m = (qd >= a) & (qd <= b)
      mid, half = (a + b) / 2., max((b - a) / 2., 1e-9)
      s = (qd[m] - mid) / half
      d = min(deg, max(1, m.sum() - 1))
      c = np.polyfit(s, ref[m], d)[::-1]          # ascending coeffs
      est = np.polyval(c[::-1], s)
      segs.append((a, b, mid, half, tuple(float(x) for x in c)))
      errs.append(float(np.abs(est - ref[m]).max()))
    return segs, errs

  while True:
    segs, errs = fit(splits)
    worst = int(np.argmax(errs))
    if errs[worst] <= relTol * rng:
      return ('pwpoly', tuple(segs), float(inv.min()), float(inv.max()))
    if len(splits) - 1 >= maxSegments:
      return None
    a, b = splits[worst], splits[worst + 1]
    splits = sorted(set(splits) | {(a + b) / 2.})
