'''Conservative per-bounce surface reachability ("beam culling", ROADMAP B12).

The port's own copy of the JAX package's ops/beam_cull.py (numpy only; no
part of the JAX package is imported). From the source's emission envelope it
works out, for every bounce, the surface rows that some ray can hit there:
the trace kernels then sweep only those rows on that bounce
(`cuda_trace._cullSets`, the kernels' cull block). A row is dropped only
when no physical ray can reach it, so the culled sweep finds the same winner
as the full one.

A *beam* over-approximates a set of rays: every ray's origin lies within
``rO`` of ``o``, its direction within ``alpha`` of ``axis``, and it travels
in medium ``medium`` (-1 = vacuum, else a lens element id, the kernels'
medium model). Bounce k's set is every row reachable by some bounce-k beam
(a bounding sphere fattened by the beam's origin radius against its
direction cone, `_reachable`); bounce k+1's beams are conservative images of
each (beam, reachable row) interaction under the kernels' physics:

  * ABSORBER ends the beam (no outgoing beam): housings and detectors stop
    propagation, so late bounces sweep only what can still be lit.
  * VACUUM (and a straight mu == 1 refraction) leaves the ray unchanged:
    the incoming beam itself continues.
  * MIRROR reflects the cone about the row's normal-cone axis, widened by
    twice the normal cone's half-angle.
  * LENS refracts: the transmitted direction lies within
    asin(min(1, mu_max * sin(theta_i_max))) of the continuation normal
    (Snell; mu_max over the dispersion fit's wavelength range), plus the
    normal cone's half-angle; a TIR beam (the reflected cone, old medium) is
    added unless mu_max * sin(theta_i_max) < 1 rules it out.
  * GRATING orders, stochastic scatter and any row without a normal cone or
    bounding sphere make the NEXT bounce "full" (no cull from there on).

Every uncertainty (direction spread, normal spread, incidence range,
dispersion) only ever widens a cone.
'''

import numpy as np

from ..geometry import surfaces as _GS
from ..tracing.element_table import MIRROR, LENS, GRATING, ABSORBER, VACUUM

# slack (radians) added to every cone widening; reach tests add their own
_MARGIN = 2e-3
_BEAM_CAP = 256          # propagation gives up past this many live beams


class Beam:
  __slots__ = ('o', 'rO', 'axis', 'alpha', 'medium')

  def __init__(self, o, rO, axis, alpha, medium):
    self.o = np.asarray(o, float)
    self.rO = float(rO)
    self.axis = _unit(np.asarray(axis, float))
    self.alpha = float(min(alpha, np.pi))
    self.medium = int(medium)


def _unit(v):
  n = np.linalg.norm(v)
  return v / n if n > 1e-30 else np.array([0., 0., 1.])


def _angle(a, b):
  return float(np.arccos(np.clip(float(np.dot(a, b)), -1., 1.)))


def _reflect(d, n):
  return d - 2. * float(np.dot(d, n)) * n


def _mergeSpheres(s1, s2):
  '''Smallest sphere (center, radius) containing both (center, radius).'''
  o1, r1 = s1
  o2, r2 = s2
  d = float(np.linalg.norm(o2 - o1))
  if d + r2 <= r1:
    return o1, r1
  if d + r1 <= r2:
    return o2, r2
  r = 0.5 * (d + r1 + r2)
  t = (r - r1) / max(d, 1e-12)
  return o1 + (o2 - o1) * t, r


def _mergeCones(c1, c2):
  '''Smallest cone containing both (axis, halfAngle) cones (slerp form).'''
  a1, h1 = c1
  a2, h2 = c2
  g = _angle(a1, a2)
  if h1 >= g + h2:
    return c1
  if h2 >= g + h1:
    return c2
  h = 0.5 * (g + h1 + h2)
  if h >= np.pi:
    return (a1, np.pi)
  # rotate a1 toward a2 by (h - h1) along the great circle
  t = (h - h1) / max(g, 1e-12)
  perp = _unit(a2 - a1 * float(np.dot(a1, a2)))
  ang = t * g
  return (_unit(a1 * np.cos(ang) + perp * np.sin(ang)), h)


def _rowRotT(row):
  '''World vector of a local direction: local = R world => world = R^T local.'''
  if row.get('ident'):
    return np.eye(3)
  return np.array([[row['r00'], row['r01'], row['r02']],
                   [row['r10'], row['r11'], row['r12']],
                   [row['r20'], row['r21'], row['r22']]]).T


def normalCone(row):
  '''(axis (3,), halfAngle) cone containing every ORIENTED world normal of
  the surface patch (n_o = orient * R^T n_local, the kernels' convention),
  or None when no sound bound is computable for the kind.

  PLANE / TRIANGLE are exact (half-angle 0). SPHERE uses the z-band trim:
  local normals have z-component in [trim1, trim2] / radius, an annulus on
  the unit sphere whose smallest enclosing cone is around +-z. ASPHERE
  bounds the meridional slope with absolute-value coefficients at the rim
  radius (an upper bound for the polynomial terms). Cylinders, cones, tori
  and quadrics span a full azimuth of normals: no cone tighter than a
  hemisphere exists, so they return None.'''
  kind = row['kind']
  orient = float(row.get('orient', 1.))
  RT = _rowRotT(row)
  if kind == _GS.PLANE:
    return (orient * RT @ np.array([0., 0., 1.]), 0.)
  if kind == _GS.TRIANGLE:
    if 'triN' not in row:
      return None
    return (orient * RT @ np.asarray(row['triN'], float), 0.)
  if kind == _GS.SPHERE:
    if row.get('trim0') == 2. or not np.isfinite(row['p0']):
      return None                     # bitmap trim: z band unknown
    R = float(row['p0'])
    if R <= 0:
      return None
    t1, t2 = row['_rawTrim']
    z1 = float(np.clip(t1, -R, R)) / R
    z2 = float(np.clip(min(t2, R), -R, R)) / R
    thLo = float(np.arccos(np.clip(z2, -1., 1.)))
    thHi = float(np.arccos(np.clip(z1, -1., 1.)))
    zw = RT @ np.array([0., 0., 1.])
    # enclosing cone around +z (half thHi) or -z (half pi - thLo)
    if thHi <= np.pi - thLo:
      return (orient * zw, thHi + _MARGIN)
    return (orient * -zw, np.pi - thLo + _MARGIN)
  if kind == _GS.ASPHERE:
    t2 = row['_rawTrim'][1]
    if not np.isfinite(t2):
      return None
    c, k = float(row['p0']), float(row['p1'])
    r = float(t2)
    root = 1. - (1. + k) * c * c * r * r
    if root <= 0.05:
      return None
    # |dz/dr| <= |c| r / sqrt(root) + 4|A4| r^3 + 6|A6| r^5 + 8|A8| r^7
    # (each term's modulus is nondecreasing in r: a true bound at the rim)
    slope = (abs(c) * r / np.sqrt(root) + 4. * abs(row['p2']) * r ** 3
             + 6. * abs(row['p3']) * r ** 5 + 8. * abs(row['p4']) * r ** 7)
    zw = RT @ np.array([0., 0., 1.])
    return (orient * zw, float(np.arctan(slope)) + _MARGIN)
  return None


def _reachable(beam, row, boundingSphere):
  '''Can some ray of `beam` hit `row`? The row's bounding sphere grown by
  the beam's origin radius against the direction cone (the test of
  `cuda_trace._firstBounceSurfs`).'''
  bs = boundingSphere(row)
  if bs is None:
    return True
  cw, rho = bs
  rho = rho + beam.rO
  d = cw - beam.o
  dist = float(np.linalg.norm(d))
  if dist <= rho:
    return True
  if beam.alpha >= np.pi - 1e-9:
    return True
  beta = _angle(d / dist, beam.axis)
  return beta <= beam.alpha + float(np.arcsin(min(rho / dist, 1.))) + 1e-6


def _nRange(er):
  '''(min, max) refractive index over the element's dispersion fit (the
  kernels evaluate it over the scaled wavelength in [-1, 1]).'''
  poly = er.get('nPoly')
  if poly is None:
    n = float(er['n'])
    return n, n
  _mid, _half, coeffs = poly
  s = np.linspace(-1., 1., 257)
  vals = np.polyval(list(reversed(coeffs)), s)
  lo, hi = float(vals.min()), float(vals.max())
  pad = 0.02 * max(hi - lo, 1e-3)     # grid + fit slack
  return lo - pad, hi + pad


_FULL = 'full'


def _bandCone(zLo, zHi, zAxis):
  '''Smallest cone around +-zAxis containing every unit vector whose
  zAxis-component lies in [zLo, zHi].'''
  zLo = float(np.clip(zLo, -1., 1.))
  zHi = float(np.clip(zHi, -1., 1.))
  thLo = float(np.arccos(zHi))                # nearest angle to +z
  thHi = float(np.arccos(zLo))                # farthest
  if thHi <= np.pi - thLo:
    return (zAxis, thHi + _MARGIN)
  return (-zAxis, np.pi - thLo + _MARGIN)


def _cylinderInteract(beam, row, e, er, elemRows, o2, rO2, opt):
  '''Cylinder barrels (full-azimuth normals, n . z == 0 exactly): no normal
  cone exists, but the local z-component of the direction is kept by
  reflection (r_z = d_z) and scaled by exactly mu under refraction
  (r_z = mu d_z), so the outgoing directions lie in an exact z-angle band.
  Azimuth is unbounded (the barrel wraps 2 pi); the band's enclosing cone
  keeps propagation alive through lens barrels.'''
  if beam.alpha >= np.pi - 1e-9:
    return _FULL
  zAxis = _rowRotT(row) @ np.array([0., 0., 1.])
  thA = _angle(beam.axis, zAxis)
  zInLo = float(np.cos(min(thA + beam.alpha, np.pi)))
  zInHi = float(np.cos(max(thA - beam.alpha, 0.)))
  if opt == float(MIRROR):
    ax, al = _bandCone(zInLo, zInHi, zAxis)
    if al >= np.pi:
      return _FULL
    return [Beam(o2, rO2, ax, al, beam.medium)]
  # LENS: entering and exiting cases, like the generic path but with the
  # exact z-band transfer; TIR keeps the incoming band
  if beam.medium < 0:
    n1lo, n1hi = 1., 1.
  else:
    n1lo, n1hi = _nRange(elemRows[beam.medium])
  out = []
  for entering in (True, False):
    n2lo, n2hi = _nRange(er) if entering else (1., 1.)
    muHi = n1hi / max(n2lo, 1e-6)
    muLo = n1lo / max(n2hi, 1e-6)
    newMed = e if entering else (-1 if beam.medium == e else beam.medium)
    if muLo == 1. and muHi == 1.:
      out.append(Beam(beam.o, beam.rO, beam.axis, beam.alpha, newMed))
      continue
    zs = [m * z for m in (muLo, muHi) for z in (zInLo, zInHi)]
    zRefLo, zRefHi = min(zs + [zInLo]), max(zs + [zInHi])  # refract + TIR
    ax, al = _bandCone(zRefLo, zRefHi, zAxis)
    if al >= np.pi:
      return _FULL
    out.append(Beam(o2, rO2, ax, al, newMed))
    if muHi > 1.:
      out.append(Beam(o2, rO2, ax, al, beam.medium))   # TIR, old medium
  return out


def _interact(beam, row, elemRows, scatterElems, boundingSphere):
  '''Conservative outgoing beams of `beam` interacting with `row`: a list
  of Beams, or _FULL when the outgoing directions cannot be bounded (the
  caller stops culling from the next bounce on).'''
  e = int(row['elemF'])
  er = elemRows[e]
  opt = float(er['optF'])
  if opt == float(ABSORBER):
    return []
  if opt == float(VACUUM):
    # pass-through: the continuing ray IS the incoming ray
    return [beam]
  if e in scatterElems:
    return _FULL
  if opt == float(GRATING):
    return _FULL
  bs = boundingSphere(row)
  if bs is None:
    return _FULL
  o2, rO2 = bs
  if row['kind'] == _GS.CYLINDER and opt in (float(MIRROR), float(LENS)):
    return _cylinderInteract(beam, row, e, er, elemRows, o2, rO2, opt)
  nc = normalCone(row)
  if nc is None:
    return _FULL
  nAxis, nAlpha = nc
  if opt == float(MIRROR):
    alpha = beam.alpha + 2. * nAlpha + _MARGIN
    if alpha >= np.pi:
      return _FULL
    return [Beam(o2, rO2, _reflect(beam.axis, nAxis), alpha, beam.medium)]
  if opt != float(LENS):
    return _FULL
  # ---- lens refraction with the kernels' medium model ----
  gamma = _angle(beam.axis, nAxis)
  spread = beam.alpha + nAlpha + _MARGIN
  canEnter = gamma + spread > np.pi / 2.   # some d with d . n_o < 0
  canExit = gamma - spread < np.pi / 2.    # some d with d . n_o > 0
  # incidence angle from the normal LINE over the whole beam
  lo = max(gamma - spread, 0.)
  hi = min(gamma + spread, np.pi)
  if lo <= np.pi / 2. <= hi:
    thetaI = np.pi / 2.
  else:
    thetaI = max(min(lo, np.pi - lo), min(hi, np.pi - hi))
  if beam.medium < 0:
    n1lo, n1hi = 1., 1.
  else:
    n1lo, n1hi = _nRange(elemRows[beam.medium])
  out = []
  for entering in (True, False):
    if not (canEnter if entering else canExit):
      continue
    n2lo, n2hi = _nRange(er) if entering else (1., 1.)
    muHi = n1hi / max(n2lo, 1e-6)
    muLo = n1lo / max(n2hi, 1e-6)
    if entering:
      newMed = e
      contAxis = -nAxis
    else:
      newMed = -1 if beam.medium == e else beam.medium
      contAxis = nAxis
    if muLo == 1. and muHi == 1.:
      # exact straight pass (mu == 1, e.g. a vacuum-side ray meeting an
      # exit-oriented face): the continuing ray IS the incoming ray
      out.append(Beam(beam.o, beam.rO, beam.axis, beam.alpha, newMed))
      continue
    sinOut = muHi * float(np.sin(thetaI))
    thetaOut = np.pi / 2. if sinOut >= 1. else float(np.arcsin(sinOut))
    alphaOut = min(thetaOut + nAlpha + _MARGIN, np.pi)
    if alphaOut >= np.pi:
      return _FULL
    out.append(Beam(o2, rO2, contAxis, alphaOut, newMed))
    if muHi > 1. and sinOut >= 1. - 1e-6:
      # TIR not ruled out: add the reflected beam in the old medium
      alphaR = beam.alpha + 2. * nAlpha + _MARGIN
      if alphaR >= np.pi:
        return _FULL
      out.append(Beam(o2, rO2, _reflect(beam.axis, nAxis), alphaR,
                      beam.medium))
  return out


def propagateBounceSets(surfRows, elemRows, scatterConsts, bound, nBounces,
                        allowed=None, unsafeAfterBounce0=False,
                        boundingSphere=None):
  '''Per-bounce candidate row sets from the source's emission envelope.

  Returns a list of length `nBounces`; entry k is a sorted list of indices
  into `surfRows` that can be the bounce-k hit, or None meaning "no cull:
  sweep everything" (propagation lost its bound at some earlier bounce).

  bound: (originCenter, axis, cosAlpha, originRadius), the contract of
  `PointSource.emissionBound`. allowed: optional iterable of row indices
  the source's mask admits (the others are invisible to rays and to the
  propagation). unsafeAfterBounce0: set when table geometry (the triangle
  and surface tables, which this analysis cannot see) holds an element that
  CHANGES directions (mirror, lens, grating, scatter): bounce 0 keeps its
  set, every later bounce is full. Absorbing or vacuum table geometry is
  safe: absorption only removes rays, pass-through keeps the incoming
  beam's reach. boundingSphere: row -> (center, radius) | None (by default
  `cuda_trace._boundingSphere`).'''
  if boundingSphere is None:
    from .cuda_trace import _boundingSphere as boundingSphere
  idxs = (sorted(set(allowed)) if allowed is not None
          else list(range(len(surfRows))))
  o, axis, cosA, rO = bound
  alpha0 = float(np.arccos(np.clip(float(cosA), -1., 1.)))
  beams = [Beam(o, rO, axis, alpha0, -1)]
  scatterElems = {int(c[0]) for c in (scatterConsts or ())}
  sets = []
  for k in range(nBounces):
    if beams is None:
      sets.append(None)
      continue
    reachOf = [(b, [s for s in idxs if _reachable(b, surfRows[s],
                                                  boundingSphere)])
               for b in beams]
    setK = sorted({s for _b, r in reachOf for s in r})
    sets.append(setK)
    if k == nBounces - 1:
      break
    if unsafeAfterBounce0:
      beams = None
      continue
    # ---- propagate: outgoing beams merged per (surface, medium) ----
    merged = {}
    passThrough = []
    gaveUp = False
    for b, reach in reachOf:
      for s in reach:
        res = _interact(b, surfRows[s], elemRows, scatterElems,
                        boundingSphere)
        if res == _FULL:
          gaveUp = True
          break
        for nb in res:
          if nb is b:
            if not any(nb is p for p in passThrough):
              passThrough.append(nb)
            continue
          key = (s, nb.medium)
          if key in merged:
            prev = merged[key]
            ax, al = _mergeCones((prev.axis, prev.alpha),
                                 (nb.axis, nb.alpha))
            merged[key] = Beam(*_mergeSpheres((prev.o, prev.rO),
                                              (nb.o, nb.rO)),
                               ax, al, nb.medium)
          else:
            merged[key] = nb
      if gaveUp:
        break
    if gaveUp:
      beams = None
      continue
    beams = list(merged.values()) + passThrough
    if len(beams) > _BEAM_CAP:
      beams = None
  return sets
