'''
Stochastic scatter as compile-time constants (counterpart of the JAX
package's `batch_tracer.scatterConstants`, `_evalMarginalConst` and
`_scatterDrawConst`): the scene's scatter tables (models/scatter.py) fitted
as piecewise Horner polynomials, which the CUDA kernels read from their
table (ops/cuda_trace packs them) and which `scatterDrawConst` evaluates on
tensors.

Per flagged (element, kind) the constants cover:
  - phi-separable continuous marginals, either incidence-INDEPENDENT (one
    1-D 'pwpoly') or theta_in-CONDITIONED (a 'pwpoly2d' in (quantile,
    theta_in));
  - theta|phi-coupled lobes as a 'lowrank' separable expansion;
  - discrete DiracDelta events whose values and probabilities vary smoothly
    with theta_in, as 1-D polynomials over the incidence angle.

The scenes whose fits miss tolerance keep the exact gather path
(`batch_tracer._scatterDraw`), which runs in the record tracer, in both
packages; the JAX package's Pallas kernel refuses them, and so do the
port's kernels (`GATHER_ONLY_REASON`), so the runner sends them to the
record tracer.
'''

import numpy as np
import torch

from .. import hostArray
from ..distributions.device_sampler import (
    arccosApprox, evalDiscreteEvents, evalLowRankTheta, evalPwpoly,
    evalPwpoly2d, fitLowRankTheta, fitPiecewisePoly, fitPiecewisePoly2d,
    fitPoly1d)

MAX_COMBOS = 16

# the JAX package's words for the scenes its kernel refuses, and where
# the port's counterpart of its gather path belongs
GATHER_ONLY_REASON = (
    'scatter PDFs miss the in-kernel fit tolerance (phi-separable lobes and '
    'low-rank theta|phi couplings run in the kernel); the exact gather path '
    'runs in the record tracer (ROADMAP A.4, tracing/batch_tracer)')


def scatterConstants(scene):
  '''The scatter tables of `scene` (host numpy or tensors) as a nested
  tuple of entries (e, k, phiSpec, thetaSpec, phiDisc, thetaDisc), one per
  flagged (element, kind) in element-then-kind order, or None: for a scene
  without scatter, with no or more than MAX_COMBOS flagged combinations,
  or whose fits miss their tolerance.'''
  if 'scatter' not in scene:
    return None
  sc = scene['scatter']
  try:
    flags = hostArray(sc['flags'])
    phiInv = hostArray(sc['phiInv']).astype(float)
    thetaInv = hostArray(sc['thetaInv']).astype(float)
    disc = None
    if 'thetaDiscVals' in sc:
      disc = {n: hostArray(sc[n]).astype(float) for n in
              ('thetaDiscVals', 'thetaDiscCum', 'phiDiscVals',
               'phiDiscCum')}
    E, K, Tin, Q = phiInv.shape
  except Exception:
    return None
  grid = np.linspace(0., np.pi / 2, Tin)   # models/scatter.py thetaInGrid
  combos = [(e, k) for e in range(E) for k in range(K) if flags[e, k]]
  if not combos or len(combos) > MAX_COMBOS:
    return None

  def fitMarginal(rows):                      # (Tin, Q)
    tol = 1e-6 * max(np.ptp(rows), 1e-30)
    if np.allclose(rows, rows[0:1, :], atol=tol):
      return fitPiecewisePoly(rows[0])        # incidence-independent
    return fitPiecewisePoly2d(rows, grid)

  def fitDisc(cum, vals):                     # (Tin, D) each
    if cum.size == 0 or not cum.any():
      return ()
    events = []
    for d in range(cum.shape[1]):
      if d and np.allclose(cum[:, d], cum[:, d - 1]):
        continue        # forward-fill padding column (models/scatter pad)
      # cumulative probabilities only gate the branch: an absolute ~1e-3
      # tolerance; event VALUES (angles) keep the tight default
      cs = fitPoly1d(cum[:, d], grid, deg=12, relTol=1e-3)
      vs = fitPoly1d(vals[:, d], grid)
      if cs is None or vs is None:
        return None     # kinked over theta_in (e.g. TIR onset)
      events.append((cs, vs))
    return tuple(events)

  out = []
  for e, k in combos:
    rowsT = thetaInv[e, k]                    # (Tin, M, Q)
    tolT = 1e-6 * max(np.ptp(rowsT), 1e-30)
    if not np.allclose(rowsT, rowsT[:, 0:1, :], atol=tolT):
      # theta|phi coupling: low-rank separable expansion over phi
      M = rowsT.shape[1]
      phiGrid = (float(hostArray(sc['phiGridLo']))
                 + float(hostArray(sc['phiGridStep'])) * np.arange(M))
      tf = fitLowRankTheta(rowsT, grid, phiGrid)
    else:
      tf = fitMarginal(rowsT[:, 0, :])
    pf = fitMarginal(phiInv[e, k])
    if tf is None or pf is None:
      return None
    tDisc = pDisc = ()
    if disc is not None:
      tDisc = fitDisc(disc['thetaDiscCum'][e, k],
                      disc['thetaDiscVals'][e, k])
      pDisc = fitDisc(disc['phiDiscCum'][e, k], disc['phiDiscVals'][e, k])
      if tDisc is None or pDisc is None:
        return None
    out.append((e, k, pf, tf, pDisc, tDisc))
  return tuple(out)


def uniformsPerBounce(entries):
  '''Uniform rows a group of entries (the lobe's or MODIFY's) draws per
  bounce: none without entries, 2 for a continuous draw, 4 when an entry
  has discrete events (the reference's u3 / u4).'''
  if not entries:
    return 0
  return 2 + (2 if any(c[4] or c[5] for c in entries) else 0)


def splitEntries(consts):
  '''(lobe, modify) entries of `scatterConstants`: the kinds REFLECT /
  REFRACT_ENTER / REFRACT_EXIT, then MODIFY.'''
  consts = consts or ()
  return ([c for c in consts if c[1] in (0, 1, 2)],
          [c for c in consts if c[1] == 3])


def needsIncidence(consts):
  '''Whether any entry is conditioned on theta_in (then the kernels form
  the incidence angle through `arccosApprox`).'''
  return any(c[2][0] in ('pwpoly2d', 'lowrank')
             or c[3][0] in ('pwpoly2d', 'lowrank') or c[4] or c[5]
             for c in (consts or ()))


def evalMarginalConst(spec, u, thetaIn, phi=None):
  '''One fitted marginal at the uniforms `u`: 'pwpoly' in u, 'pwpoly2d' in
  (u, theta_in), 'lowrank' in (u, theta_in, phi).'''
  if spec[0] == 'pwpoly2d':
    return evalPwpoly2d(spec, u, thetaIn)
  if spec[0] == 'lowrank':
    return evalLowRankTheta(spec, u, thetaIn, phi)
  return evalPwpoly(spec, u)


def drawEntry(entry, thetaIn, u1, u2, u3=None, u4=None):
  '''(theta, phi) of one entry from its uniforms: phi from its marginal
  and discrete events, then theta conditioned on the drawn phi AFTER its
  discrete overwrite.'''
  _e, _k, phiSpec, thetaSpec, phiDisc, thetaDisc = entry
  ph = evalMarginalConst(phiSpec, u1, thetaIn)
  ph = evalDiscreteEvents(phiDisc, thetaIn, u3, ph)
  th = evalMarginalConst(thetaSpec, u2, thetaIn, ph)
  th = evalDiscreteEvents(thetaDisc, thetaIn, u4, th)
  return th, ph


def scatterDrawConst(consts, elemIdx, kind, thetaIn, u1, u2, u3, u4):
  '''(thetaOut, phiOut) for every ray from the entries whose element and
  kind match the ray's (0 where none does).'''
  phiOut = torch.zeros_like(u1)
  thetaOut = torch.zeros_like(u2)
  for entry in consts:
    m = (elemIdx == entry[0]) & (kind == entry[1])
    th, ph = drawEntry(entry, thetaIn, u1, u2, u3, u4)
    phiOut = torch.where(m, ph, phiOut)
    thetaOut = torch.where(m, th, thetaOut)
  return thetaOut, phiOut


def incidenceAngle(dDotN):
  '''The conditioning angle theta_in = arccos(clamp(d . n, 0, 1)), n the
  normal on the side the ray travels to.'''
  return arccosApprox(torch.clamp(dDotN, 0., 1.))
