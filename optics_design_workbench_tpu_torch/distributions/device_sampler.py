'''
On-device sampling from compiled random variables (counterpart of the JAX
package's distributions/device_sampler.py).

The compiled per-variable conditional inverse-CDF transforms are exported as
tables so that source sampling runs on the device: millions of (theta, phi)
draws per step, chained conditionally, from an explicit `torch.Generator`
(the stand-in for a jax key — the two libraries give different numbers from
the same seed, so tests feed both sides numpy-made uniforms instead).

Table construction and the fits are host numpy and repeat the reference's
arithmetic, so both packages build the same tables and constants. The
evaluators act on float32 tensors in the reference's operation order, each
python constant rounded to float32 once (what the JAX package's weakly
typed python floats come to), so that they are the plain twins of the CUDA
kernels' scatter draw (csrc/trace_common.cuh), which reads the same
constants packed as float32.

  sources:  `buildDeviceTables`, `deviceDraw`, `tentInterp`,
            `interpInverseRows`, `evalPwpoly`, `fitPiecewisePoly`
  scatter:  `fitPiecewisePoly2d`, `fitPoly1d`, `fitLowRankTheta`,
            `fitFourier` and their evaluators `evalPwpoly2d`,
            `evalLowRankTheta`, `evalFourier`, `evalPoly1d`,
            `evalDiscreteEvents`; `arccosApprox` (the conditioning angle)
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


def interpInverseRows(cdf, values, rows, u):
  '''
  Row-wise inverse interpolation: for each draw j, find v such that
  cdf[rows[j], :] crosses u[j] and linearly interpolate into `values`.
  cdf rows are ascending with cdf[:, 0] == 0 and cdf[:, -1] == 1.
  A batched binary search (log2(R) gathers of N scalars).
  '''
  R = cdf.shape[1]
  lo = torch.zeros(rows.shape, dtype=torch.int64, device=u.device)
  hi = torch.full(rows.shape, R - 1, dtype=torch.int64, device=u.device)
  for _ in range(int(np.ceil(np.log2(max(R, 2))))):
    mid = (lo + hi) // 2
    goRight = u >= cdf[rows, mid]
    lo, hi = torch.where(goRight, mid, lo), torch.where(goRight, hi, mid)
  c0, c1 = cdf[rows, lo], cdf[rows, hi]
  v0, v1 = values[lo], values[hi]
  frac = torch.where(c1 > c0, (u - c0) / (c1 - c0), torch.zeros_like(u))
  return v0 + frac * (v1 - v0)


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


def _f32(x):
  '''A python constant rounded to float32 once, as the JAX package's weakly
  typed python floats are where they meet a float32 array.'''
  return float(np.float32(x))


def fitPiecewisePoly2d(rows, cond, maxRects=24, degU=8, degC=6,
                       relTol=5e-3):
  '''Fit a FAMILY of inverse CDFs `rows` ((T, Q), each row tabulated on a
  uniform [0,1] quantile grid for conditioning value cond[t]) as bivariate
  piecewise polynomials f(u, c) over adaptive RECTANGLES in
  (quantile, scaled conditioning value): one (degU+1) x (degC+1)
  coefficient grid per rectangle in per-rect scaled coordinates. The worst
  rectangle is bisected along whichever dimension reduces its children's
  error more (u splits resolve the inverse-CDF boundary layers at u -> 0/1,
  c splits the domain-clipping layers at the edges of the incidence-angle
  range). Acceptance: 99.5th-percentile error <= relTol * range with a
  hard 6 * relTol * range cap on the max (the mean |inverse-CDF error| is
  the Wasserstein-1 distance of the sampled distribution). Returns
  ('pwpoly2d', rects, lo, hi, cMid, cHalf) with rect =
  (a, b, ca, cb, midU, halfU, midC, halfC, coeffs), or None at failure.
  The JAX package's fit, step for step.'''
  rows = np.asarray(rows, dtype=float)
  cond = np.asarray(cond, dtype=float)
  T, Q = rows.shape
  q = np.linspace(0., 1., Q)
  rng = max(np.ptp(rows), 1e-30)
  cMid = (cond.max() + cond.min()) / 2.
  cHalf = max((cond.max() - cond.min()) / 2., 1e-9)
  cS = (cond - cMid) / cHalf
  nU = 4 * (degU + 1)              # per-rect sample grids (always well
  nC = max(4 * (degC + 1), T)      # conditioned, however small the rect)

  def fitRect(a, b, ca, cb):
    midU, halfU = (a + b) / 2., max((b - a) / 2., 1e-9)
    midC, halfC = (ca + cb) / 2., max((cb - ca) / 2., 1e-9)
    us = np.linspace(a, b, nU)
    cs = np.linspace(ca, cb, nC)
    onU = np.stack([np.interp(us, q, r) for r in rows])    # (T, nU)
    seg = np.stack([[np.interp(c, cS, onU[:, i]) for i in range(nU)]
                    for c in cs])                          # (nC, nU)
    x = (us - midU) / halfU
    cc = (cs - midC) / halfC
    X = np.broadcast_to(x, (nC, nU))
    C = np.broadcast_to(cc[:, None], (nC, nU))
    cols = [(X ** i) * (C ** j)
            for i in range(degU + 1) for j in range(degC + 1)]
    A = np.stack(cols, axis=-1).reshape(-1, (degU + 1) * (degC + 1))
    y = seg.reshape(-1)
    sol, *_ = np.linalg.lstsq(A, y, rcond=None)
    res = np.abs(A @ sol - y)
    cf = sol.reshape(degU + 1, degC + 1)
    rect = (a, b, ca, cb, midU, halfU, midC, halfC,
            tuple(tuple(float(v) for v in row) for row in cf))
    return rect, float(np.quantile(res, 0.995)), float(res.max())

  # initial tiling: the classic inverse-CDF boundary-layer u splits
  rects = [fitRect(a, b, -1., 1.)
           for a, b in ((0., .03), (.03, .97), (.97, 1.))]
  tol, cap = relTol * rng, 6. * relTol * rng
  while True:
    bad = [i for i, (_r, p, m) in enumerate(rects) if p > tol or m > cap]
    if not bad:
      return ('pwpoly2d', tuple(r for r, _p, _m in rects),
              float(rows.min()), float(rows.max()),
              float(cMid), float(cHalf))
    if len(rects) >= maxRects:
      return None
    worst = max(bad, key=lambda i: rects[i][1] + rects[i][2])
    a, b, ca, cb = rects[worst][0][:4]
    # bisect along the dimension whose children fit better
    uKids = [fitRect(a, (a + b) / 2, ca, cb),
             fitRect((a + b) / 2, b, ca, cb)]
    cKids = [fitRect(a, b, ca, (ca + cb) / 2),
             fitRect(a, b, (ca + cb) / 2, cb)]
    score = lambda kids: max(p + m for _r, p, m in kids)
    kids = uKids if score(uKids) <= score(cKids) else cKids
    rects[worst:worst + 1] = kids


def fitPoly1d(vals, cond, deg=10, relTol=1e-4):
  '''Fit vals(cond) as one scaled-coordinate Horner polynomial
  ('poly1d', mid, half, coeffsAscending); collapses to ('const', v) for
  flat rows. Used for theta_in-dependent discrete (DiracDelta) event
  values / probabilities and for the phi factors of a low-rank fit. None
  at tolerance failure.'''
  vals = np.asarray(vals, dtype=float)
  cond = np.asarray(cond, dtype=float)
  rng = float(np.ptp(vals))
  scale = max(np.abs(vals).max(), 1.)
  if rng <= 1e-9 * scale:
    return ('const', float(vals[0]))
  mid = (cond.max() + cond.min()) / 2.
  half = max((cond.max() - cond.min()) / 2., 1e-9)
  s = (cond - mid) / half
  for d in range(2, deg + 1):
    c = np.polyfit(s, vals, d)
    if np.abs(np.polyval(c, s) - vals).max() <= relTol * max(rng, 1e-3):
      return ('poly1d', float(mid), float(half),
              tuple(float(x) for x in c[::-1]))
  return None


def evalPwpoly2d(spec, u, c):
  '''Bivariate piecewise Horner evaluation of a fitPiecewisePoly2d spec on
  float32 tensors: per rectangle, Horner in scaled u whose coefficients are
  Horner polynomials in the scaled conditioning value; the last rectangle
  whose closed box holds (u, s) wins, else the first; clamp to [lo, hi].'''
  _, rects, lo, hi, cMid, cHalf = spec
  s = (c - _f32(cMid)) * _f32(1.0 / cHalf)
  out = None
  for a, b, ca, cb, midU, halfU, midC, halfC, coeffs in rects:
    x = (u - _f32(midU)) * _f32(1.0 / halfU)
    cc = (s - _f32(midC)) * _f32(1.0 / halfC)
    acc = None
    for rowU in reversed(coeffs):          # ascending u powers reversed
      h = torch.full_like(u, _f32(rowU[-1]))
      for cj in reversed(rowU[:-1]):
        h = h * cc + _f32(cj)
      acc = h if acc is None else acc * x + h
    if out is None:
      out = acc
    else:
      m = ((u >= _f32(a)) & (u <= _f32(b)) & (s >= _f32(ca))
           & (s <= _f32(cb)))
      out = torch.where(m, acc, out)
  return torch.clamp(out, _f32(lo), _f32(hi))


def fitLowRankTheta(rowsT, cond, phiGrid, maxRank=3, relTol=5e-3):
  '''Low-rank separable fit of a theta|phi-COUPLED conditional inverse-CDF
  family: rowsT (Tin, M, Q) tabulates the theta inverse CDF per (incidence
  angle, phi bin). SVD over the phi axis gives
  thetaInv(u; theta_in, phi) ~= sum_k A_k(u, theta_in) * B_k(phi); each A_k
  is fitted as a pwpoly2d in (quantile, theta_in) and each B_k as a poly1d
  (or, failing that, a Fourier series) in phi. Acceptance mirrors
  fitPiecewisePoly2d: 99.5th-percentile reconstruction error
  <= relTol * range, max <= 6x. Returns ('lowrank', ((aspec, bspec), ...),
  lo, hi) or None.

  Whether a rank is accepted is decided on the fit's own float32
  evaluation, as the JAX package decides it (its evaluators on float32
  arrays), so that both packages keep the same number of components.'''
  rowsT = np.asarray(rowsT, dtype=float)
  Tin, M, Q = rowsT.shape
  rng = max(np.ptp(rowsT), 1e-30)
  tol, cap = relTol * rng, 6. * relTol * rng
  X = rowsT.transpose(1, 0, 2).reshape(M, Tin * Q)
  U, s, Vt = np.linalg.svd(X, full_matrices=False)
  q = np.linspace(0., 1., Q)
  uFlat = torch.as_tensor(np.tile(q, Tin), dtype=torch.float32)
  cFlat = torch.as_tensor(np.repeat(np.asarray(cond, float), Q),
                          dtype=torch.float32)
  phiJ = torch.as_tensor(np.asarray(phiGrid, float), dtype=torch.float32)
  comps = []
  recon = np.zeros_like(rowsT)
  for k in range(min(maxRank, len(s))):
    if s[k] <= 1e-12 * max(s[0], 1e-30):
      break
    A = (s[k] * Vt[k]).reshape(Tin, Q)
    B = U[:, k]
    aspec = fitPiecewisePoly2d(A, cond, relTol=relTol)
    bspec = fitPoly1d(B, phiGrid, deg=12, relTol=1e-3)
    if bspec is None:
      # phi components are typically PERIODIC: the trigonometric basis
      # succeeds where the polynomial one leaves percent-level error
      bspec = fitFourier(B, phiGrid, relTol=1e-3,
                         maxHarmonics=min(15, (len(phiGrid) - 1) // 2))
    if aspec is None or bspec is None:
      return None
    comps.append((aspec, bspec))
    Av = evalPwpoly2d(aspec, uFlat, cFlat).double().numpy().reshape(Tin, Q)
    # a 'const' factor enters unrounded, as the JAX evaluator returns its
    # python float
    Bv = (evalFourier(bspec, phiJ).double().numpy() if bspec[0] == 'fourier'
          else bspec[1] if bspec[0] == 'const'
          else evalPoly1d(bspec, phiJ).double().numpy()) * np.ones(M)
    recon = recon + Av[:, None, :] * Bv[None, :, None]
    err = np.abs(recon - rowsT)
    if float(np.quantile(err, 0.995)) <= tol and float(err.max()) <= cap:
      return ('lowrank', tuple(comps),
              float(rowsT.min()), float(rowsT.max()))
  return None


def fitFourier(vals, x, maxHarmonics=12, relTol=1e-3):
  '''Least-squares trigonometric fit vals(x) ~= c0 + sum_m am cos(mx) +
  bm sin(mx): the basis for the periodic phi components of a low-rank
  coupled-scatter expansion. Returns ('fourier', c0, ((a1, b1), ...)) or
  None.'''
  vals = np.asarray(vals, dtype=float)
  x = np.asarray(x, dtype=float)
  rng = max(np.ptp(vals), 1e-30)
  for Mh in range(2, maxHarmonics + 1):
    cols = [np.ones_like(x)]
    for m in range(1, Mh + 1):
      cols += [np.cos(m * x), np.sin(m * x)]
    A = np.stack(cols, axis=-1)
    sol, *_ = np.linalg.lstsq(A, vals, rcond=None)
    if np.abs(A @ sol - vals).max() <= relTol * rng:
      return ('fourier', float(sol[0]),
              tuple((float(sol[1 + 2 * m]), float(sol[2 + 2 * m]))
                    for m in range(Mh)))
  return None


def evalFourier(spec, x):
  '''Evaluate a fitFourier spec through the Chebyshev angle-addition
  recurrence: one cos / sin pair, then multiplies and adds only.'''
  _, c0, terms = spec
  c1, s1 = torch.cos(x), torch.sin(x)
  out = _f32(c0) + _f32(terms[0][0]) * c1 + _f32(terms[0][1]) * s1
  cp, sp = torch.ones_like(x), torch.zeros_like(x)
  cm, sm = c1, s1
  for m in range(2, len(terms) + 1):
    cm, cp = 2. * c1 * cm - cp, cm
    sm, sp = 2. * c1 * sm - sp, sm
    am, bm = terms[m - 1]
    out = out + _f32(am) * cm + _f32(bm) * sm
  return out


def evalLowRankTheta(spec, u, thetaIn, phi):
  '''Evaluate a fitLowRankTheta spec: the sum of its separable terms,
  clamped to the tabulated theta range.'''
  _, comps, lo, hi = spec
  out = None
  for aspec, bspec in comps:
    bv = (evalFourier(bspec, phi) if bspec[0] == 'fourier'
          else evalPoly1d(bspec, phi))
    term = evalPwpoly2d(aspec, u, thetaIn) * bv
    out = term if out is None else out + term
  return torch.clamp(out, _f32(lo), _f32(hi))


def evalPoly1d(spec, c):
  '''Evaluate a fitPoly1d spec on a tensor, or return the float32 constant
  of a 'const' spec (broadcast where it is used).'''
  if spec[0] == 'const':
    return _f32(spec[1])
  _, mid, half, coeffs = spec
  s = (c - _f32(mid)) * _f32(1.0 / half)
  acc = torch.full_like(c, _f32(coeffs[-1]))
  for cj in reversed(coeffs[:-1]):
    acc = acc * s + _f32(cj)
  return acc


def evalDiscreteEvents(disc, c, u, cont):
  '''Apply a tuple of fitted discrete (DiracDelta) scatter events
  ((cumSpec, valSpec), ...) conditioned on `c`: the event index is the
  count of cumulative probabilities below the uniform `u`; u beyond the
  final cumulative keeps the continuous draw `cont`.'''
  if not disc:
    return cont
  out = None
  prevCum = None
  for cumSpec, valSpec in disc:
    v = evalPoly1d(valSpec, c)
    if not isinstance(v, torch.Tensor):
      v = torch.full_like(u, v)
    out = v if out is None else torch.where(u > prevCum, v, out)
    prevCum = evalPoly1d(cumSpec, c)
  return torch.where(u <= prevCum, out, cont)


# arccos(x) = sqrt(1 - x) * P(x) with P smooth on [0, 1] (P(0) = pi/2,
# P(1) = sqrt(2)): the scatter conditioning angle theta_in = arccos(d . n)
# from a sqrt and a polynomial, the JAX package's form (its TPU compiler
# had no acos), so that both packages compute the same angle. The
# polynomial is fitted once at import; max error < 2e-6 rad.
def _fitAcosPoly(deg=12):
  x = np.linspace(0., 1., 4001)
  p = np.arccos(x) / np.sqrt(np.maximum(1. - x, 1e-12))
  p[-1] = np.sqrt(2.)
  return tuple(float(v) for v in np.polyfit(2. * x - 1., p, deg)[::-1])


ACOS_POLY = _fitAcosPoly()


def arccosApprox(mu):
  '''arccos for mu in [0, 1] from sqrt + polynomial only, on a float32
  tensor (the kernels' conditioning angle; see ACOS_POLY).'''
  x = torch.clamp(mu, 0., 1.)
  s = 2. * x - 1.
  acc = torch.full_like(x, _f32(ACOS_POLY[-1]))
  for c in reversed(ACOS_POLY[:-1]):
    acc = acc * s + _f32(c)
  return torch.sqrt(torch.clamp(1. - x, min=0.)) * acc
