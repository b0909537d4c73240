'''
Analytic surface tables — host-side scene geometry of the port (counterpart
of the JAX package's geometry/surfaces.py, same encoding and column layout).

Surface encoding
================
kind (int32):
  0 PLANE     local z=0 plane.
  1 SPHERE    centered at local origin, radius params[0] (>0).
  2 CYLINDER  axis = local z, radius params[0].
  3 ASPHERE   sag surface z = c*r^2/(1+sqrt(1-(1+k)*c^2*r^2)) + a4 r^4 +
              a6 r^6 + a8 r^8 with c=params[0] (curvature, 1/R), k=params[1],
              a4..a8 = params[2:5]. An exact conic (a4 = a6 = a8 = 0) is
              rewritten as a QUADRIC by `_conicAsQuadric`.
  4 TRIANGLE  vertices in params[0:9] (local frame usually identity).
  5 CONE      axis = local z, radius(z) = params[0] + z * params[1]
              (params[1] = tan of the semi-angle).
  6 QUADRIC   principal-axis quadric f(p) = qa x^2 + qb y^2 + qc z^2 +
              qz z + q0 = 0 with (qa, qb, qc, qz, q0) = params[0:5].
  7 TORUS     tube radius params[1] around the circle of radius params[0]
              in the local z=0 plane (exact quartic intersection).

trim (float32[6]): per-kind trim window:
  PLANE:    trim[0] shape flag (0=annulus, 1=rectangle);
            annulus: r in [trim[1], trim[2]]; rect: |x|<=trim[1], |y|<=trim[2]
  SPHERE:   z in [trim[1], trim[2]] (cap/zone selection)
  CYLINDER: z in [trim[1], trim[2]]
  ASPHERE:  r in [trim[1], trim[2]]
  CONE:     z in [trim[1], trim[2]]
  QUADRIC:  z in [trim[1], trim[2]]
  TORUS:    tube angle v = atan2(z, sqrt(x^2+y^2) - R) in [trim[1], trim[2]]
  TRIANGLE: unused (barycentric test is the trim)

Bitmap trims: trim[0] == 2 selects a per-face UV occupancy bitmap instead
of the closed-form window (a surface dict's `trimBitmap`: `mask`, v-major,
and `u0`, `v0`, `invDu`, `invDv`). trim[1:5] = (u0, v0, 1/du, 1/dv) map the
kind's UV chart onto bitmap pixels: plane (x, y); sphere / cylinder / cone
/ quadric (azimuth, z); asphere (azimuth, r); torus (azimuth, tube angle
v); the azimuth is `chartAtan2(y, x)`. `buildSurfaceTable` packs the
bitmaps into one zero-padded (nBitmaps, R, R) uint8 stack `trimMasks` with
a per-surface row index `trimMaskIdx`.

Trim-primitive trims: trim[0] == 3 (band/annulus base, trim[1:3] as the
trim[0] == 0 window) and trim[0] == 4 (rect base, plane only, trim[1:3] as
the trim[0] == 1 window) combine the closed-form base with a short list of
primitives (a surface dict's `trimPrims`: `holes`, rows of (flag, cx, cy,
p0, p1, cosA, sinA)): occupied = (base OR any add-prim) AND NOT any
hole-prim, with flag = shape + 10*isAdd + 20*isInverted; shapes 1 rotated
rectangle (half-extents p0, p1), 2 disc (radius^2 in p0), 3 half-plane, 4
poly2, 5 general conic (payload A, B, C, D, E, F), 6 half-space on the full
local point; flag 0 = inactive. They are packed into one zero-padded
(S, maxHoles, 7) float32 stack `trimPrims`.

orient (float32, +1/-1): multiplies the canonical normal to yield the
*outward-of-solid* normal, which defines the entering/exiting decision.
Canonical normals: plane +z, sphere radially out, cylinder radially out,
asphere grad(z - sag(r)) (points to +z side), triangle right-handed
winding, cone radial tipped by -tanA, quadric +grad f, torus away from the
tube's centre circle.

The intersection maths itself lives with the kernels and their plain
PyTorch version (ops/cuda_trace.py, csrc/trace_common.cuh).
'''

import numpy as np
import torch

from . import transforms

PLANE, SPHERE, CYLINDER, ASPHERE, TRIANGLE, CONE, QUADRIC, TORUS = \
    0, 1, 2, 3, 4, 5, 6, 7
N_PARAMS, N_TRIM = 9, 6
_KIND_NAMES = {0: 'plane', 1: 'sphere', 2: 'cylinder', 3: 'asphere',
               4: 'triangle', 5: 'cone', 6: 'quadric', 7: 'torus'}
KIND_CODES = {name: code for code, name in _KIND_NAMES.items()}
# the kinds and trim flags of the first slices: scenes of only these run
# the kernels' instances without the other kinds' code
BASIC_KINDS = (PLANE, SPHERE, CYLINDER)
BASIC_TRIMS = (0., 1.)


# ----------------------------------------------------- host-side constructors

def _surf(kind, params, trim, transform, elem, orient):
  p = np.zeros(N_PARAMS)
  p[:len(params)] = params
  t = np.zeros(N_TRIM)
  t[:len(trim)] = trim
  return dict(kind=kind, params=p, trim=t,
              transform=np.asarray(transform, dtype=float),
              elem=elem, orient=float(orient))


def plane(transform, elem, radius=None, innerRadius=0., halfExtents=None,
          orient=+1):
  '''Disc/annulus (radius given) or rectangle (halfExtents given) in the
  local z=0 plane.'''
  if halfExtents is not None:
    trim = (1., halfExtents[0], halfExtents[1])
  else:
    trim = (0., innerRadius, np.inf if radius is None else radius)
  return _surf(PLANE, (), trim, transform, elem, orient)


def sphere(transform, elem, radius, zRange=None, orient=+1):
  '''Full sphere or z-trimmed zone/cap of radius `radius` centered at the
  local origin.'''
  if zRange is None:
    zRange = (-radius, radius)
  return _surf(SPHERE, (radius,), (0., zRange[0], zRange[1]),
               transform, elem, orient)


def cylinder(transform, elem, radius, zRange, orient=+1):
  return _surf(CYLINDER, (radius,), (0., zRange[0], zRange[1]),
               transform, elem, orient)


def asphere(transform, elem, curvature, conic=0., coeffs=(0., 0., 0.),
            rMax=np.inf, rMin=0., orient=+1):
  '''Even asphere sag surface; curvature = 1/R at the vertex.'''
  a = tuple(coeffs) + (0.,) * (3 - len(coeffs))
  return _surf(ASPHERE, (curvature, conic) + a, (0., rMin, rMax),
               transform, elem, orient)


def triangle(v0, v1, v2, elem, orient=+1):
  return _surf(TRIANGLE, tuple(v0) + tuple(v1) + tuple(v2), (),
               np.eye(4), elem, orient)


def cone(transform, elem, radius, tanAngle, zRange, orient=+1):
  '''Cone of local radius(z) = radius + z * tanAngle.'''
  return _surf(CONE, (radius, tanAngle), (0., zRange[0], zRange[1]),
               transform, elem, orient)


def quadric(transform, elem, coeffs, zRange, orient=+1):
  '''Principal-axis quadric qa x^2 + qb y^2 + qc z^2 + qz z + q0 = 0 with
  coeffs = (qa, qb, qc, qz, q0), trimmed to z in zRange. Canonical normal =
  +grad f; orient flips it to outward-of-solid.'''
  qa, qb, qc, qz, q0 = coeffs
  return _surf(QUADRIC, (qa, qb, qc, qz, q0), (0., zRange[0], zRange[1]),
               transform, elem, orient)


def torus(transform, elem, majorRadius, minorRadius, vRange=None, orient=+1):
  '''Torus around the local z axis: tube of radius `minorRadius` swept
  along the circle of radius `majorRadius` in the z=0 plane. The trim band
  is the TUBE angle v = atan2(z, sqrt(x^2+y^2) - majorRadius) in (-pi, pi]:
  v = 0 is the outer equator, +/-pi the inner equator, +pi/2 the top
  circle. vRange None keeps the full tube. Requires majorRadius >
  minorRadius. orient +1 = outward of the solid tube.'''
  if vRange is None:
    vRange = (-3.15, 3.15)
  return _surf(TORUS, (majorRadius, minorRadius),
               (0., vRange[0], vRange[1]), transform, elem, orient)


def _conicAsQuadric(s):
  '''Rewrite an exact-conic ASPHERE (a4 = a6 = a8 = 0) as a QUADRIC row,
  the JAX package's rewrite step for step.

  The conic sag z = c r^2 / (1 + sqrt(1 - (1+k) c^2 r^2)) satisfies the
  principal-axis quadric -c x^2 - c y^2 - c (1+k) z^2 + 2 z = 0 exactly, so
  the Newton solve collapses to one closed-form quadratic. The radial trim
  r in [trim1, trim2] maps to the z band [sag(r1), sag(r2)], clamped to the
  branch apex for k > -1 so the far sheet of a closed ellipsoid stays
  excluded; a k <= -1 face with an unbounded rMax gets a one-sided infinite
  z band. `orient` carries over. Bitmap-trimmed faces keep the ASPHERE
  (azimuth, r) chart.'''
  if s['kind'] != ASPHERE or 'trimBitmap' in s:
    return s
  p = np.asarray(s['params'], dtype=float)
  c, k = float(p[0]), float(p[1])
  if abs(c) < 1e-12 or np.any(p[2:5] != 0.):
    return s
  trim = np.array(s['trim'], dtype=float)
  if trim[0] == 2.:
    return s
  r1, r2 = float(trim[1]), float(trim[2])
  if k > -1.:
    rNat = 1. / (abs(c) * np.sqrt(1. + k))
    r1, r2 = min(r1, rNat), min(r2, rNat)

  def sag(r):
    q = max(1. - (1. + k) * c * c * r * r, 0.)
    return c * r * r / (1. + np.sqrt(q))
  out = dict(s)
  out['kind'] = QUADRIC
  q = np.zeros(N_PARAMS)
  q[:5] = (-c, -c, -c * (1. + k), 2., 0.)
  out['params'] = q
  if np.isfinite(r2):
    trim[1], trim[2] = sorted((sag(r1), sag(r2)))
  else:
    if not np.isfinite(r1):
      return s
    zNear = sag(r1)
    trim[1], trim[2] = (zNear, np.inf) if c > 0 else (-np.inf, zNear)
  out['trim'] = trim
  return out


def buildSurfaceTable(surfs, dtype=np.float32):
  '''Pack a list of surface dicts into a SoA table of host numpy arrays
  (scene compilation is host-side; Scene.compile moves the table to the
  requested device in one go).

  Exact-conic aspheres become quadrics first (`_conicAsQuadric`), then the
  surfaces are SORTED BY KIND like the reference's table, so surface
  indices — and with them the lowest-index tie-break of the nearest-hit
  search — agree between the two packages. Bitmap trims add `trimMasks`
  (nBitmaps, R, R) uint8 (zero-padded to the largest bitmap) and
  `trimMaskIdx` (S,) int32, and set the face's trim row to (2, u0, v0,
  invDu, invDv, 0); trim primitives add `trimPrims` (S, maxHoles, 7)
  float32 (zero rows: inactive).'''
  if not surfs:
    raise ValueError('scene contains no surfaces')
  surfs = [_conicAsQuadric(s) for s in surfs]
  surfs = sorted(surfs, key=lambda s: s['kind'])
  primSurfs = [(i, s) for i, s in enumerate(surfs) if 'trimPrims' in s]
  primStack = None
  if primSurfs:
    maxH = max(len(s['trimPrims']['holes']) for _i, s in primSurfs)
    primStack = np.zeros((len(surfs), maxH, 7), dtype=np.float32)
    for i, s in primSurfs:
      for h, hole in enumerate(s['trimPrims']['holes']):
        primStack[i, h, :len(hole)] = hole
  bitmapSurfs = [(i, s) for i, s in enumerate(surfs) if 'trimBitmap' in s]
  maskStack = maskIdx = None
  if bitmapSurfs:
    res = max(s['trimBitmap']['mask'].shape[0] for _i, s in bitmapSurfs)
    maskStack = np.zeros((len(bitmapSurfs), res, res), dtype=np.uint8)
    maskIdx = np.zeros(len(surfs), dtype=np.int32)
    for row, (i, s) in enumerate(bitmapSurfs):
      bm = s['trimBitmap']
      m = bm['mask']
      maskStack[row, :m.shape[0], :m.shape[1]] = m
      maskIdx[i] = row
      s['trim'] = np.array([2., bm['u0'], bm['v0'], bm['invDu'],
                            bm['invDv'], 0.])
  mats = np.stack([s['transform'] for s in surfs])
  matsInv = np.stack([np.linalg.inv(m) for m in mats])
  # Snap world->local rotations onto exact signed-permutation groups, as
  # the reference does; the frame ORIGIN is held fixed and both transform
  # directions are rebuilt from the snapped rotation so they stay exact
  # inverses.
  snapped, _gids = transforms.snapSignedPermGroups(matsInv[:, :3, :3])
  for i in range(len(surfs)):
    tl = mats[i, :3, 3]                      # frame origin in world: keep
    matsInv[i, :3, :3] = snapped[i]
    matsInv[i, :3, 3] = -snapped[i] @ tl
    mats[i, :3, :3] = snapped[i].T
  w2lRot, w2lOff = transforms.rotRowsOffsets(matsInv, dtype=np.float32)
  l2wRot, l2wOff = transforms.rotRowsOffsets(mats, dtype=np.float32)
  npDtype = np.dtype(dtype)
  table = dict(
      kind=np.asarray([s['kind'] for s in surfs], dtype=np.int32),
      params=np.stack([s['params'] for s in surfs]).astype(npDtype),
      trim=np.stack([s['trim'] for s in surfs]).astype(npDtype),
      w2lRot=np.asarray(w2lRot, dtype=npDtype),
      w2lOff=np.asarray(w2lOff, dtype=npDtype),
      l2wRot=np.asarray(l2wRot, dtype=npDtype),
      l2wOff=np.asarray(l2wOff, dtype=npDtype),
      elem=np.asarray([s['elem'] for s in surfs], dtype=np.int32),
      orient=np.asarray([s['orient'] for s in surfs], dtype=npDtype),
  )
  if maskStack is not None:
    table['trimMasks'] = maskStack
    table['trimMaskIdx'] = maskIdx
  if primStack is not None:
    table['trimPrims'] = primStack
  # packed per-surface row, the reference's layout:
  # w2lRot (9, row-major), w2lOff (3), orient, elem, kind, params (9)
  rotFlat = np.asarray(matsInv[:, :3, :3].reshape(len(surfs), 9))
  packed = np.concatenate([
      rotFlat,
      np.asarray(matsInv[:, :3, 3]),
      np.asarray([[s['orient']] for s in surfs]),
      np.asarray([[float(s['elem'])] for s in surfs]),
      np.asarray([[float(s['kind'])] for s in surfs]),
      np.stack([s['params'] for s in surfs]),
  ], axis=1)
  table['packed'] = packed.astype(npDtype)
  return table


# column offsets in table['packed']
PACKED_ROT, PACKED_OFF, PACKED_ORIENT = 0, 9, 12
PACKED_ELEM, PACKED_KIND, PACKED_PARAMS = 13, 14, 15


def chartAtan2(y, x):
  '''The reference's branchless polynomial atan2 (octant and half-angle
  reduction, then a 4-term minimax polynomial) on float32 torch tensors,
  operation for operation: it sets the bitmap trims' azimuth pixels and the
  torus's tube angle, so both packages' pixel indices agree bit for bit
  (the kernels' `chartAtan2` repeats it).'''
  ax, ay = torch.abs(x), torch.abs(y)
  hi = torch.maximum(ax, ay)
  lo = torch.minimum(ax, ay)
  a = lo / torch.clamp(hi, min=1e-30)
  big = a > 0.41421356237309503     # tan(pi/8): half-angle reduction
  aa = torch.where(big, (a - 1.) / (a + 1.), a)
  z = aa * aa
  p = ((8.05374449538e-2 * z - 1.38776856032e-1) * z
       + 1.99777106478e-1) * z - 3.33329491539e-1
  p = p * z * aa + aa
  p = torch.where(big, p + 0.7853981633974483, p)
  p = torch.where(ay > ax, 1.5707963267948966 - p, p)
  p = torch.where(x < 0, np.pi - p, p)
  return torch.where(y < 0, -p, p)


# -------------------------------------------- intersection and normals (torch)
#
# The record tracer's sweep (tracing/batch_tracer.allDistancesBatch) tests
# every surface of one kind against every ray at once: per-surface values
# are (S, K) tensors whose columns broadcast as (S, 1) against (S, N) ray
# tensors in the surfaces' local frames, the counterpart of the JAX
# package's vmap over surfaces and rays. Each intersector returns (S, N)
# distances, +inf where a ray misses.

_BIG = float('inf')


def _col(x, i):
  '''Column `i` of a per-surface (S, K) tensor as (S, 1).'''
  return x[:, i:i + 1]


def _full(like, value):
  return torch.full_like(like, float(value))


def sqrtPositive(x):
  '''sqrt(x) where x > 0, else 0, with a zero gradient where x <= 0. The
  double-where guard of the JAX package (`where(ok, sqrt(where(ok, x, 1)),
  0)`) with `ok` strict: a value that cancels to exactly 0 (a dead ray
  grazing a surface far away) would otherwise send sqrt'(0) = inf times a
  zero cotangent, NaN, into every gradient of tracing/diff.py. The values
  are the plain guard's, bit for bit.'''
  pos = x > 0
  return torch.where(pos, torch.sqrt(torch.where(pos, x, torch.ones_like(x))),
                     torch.zeros_like(x))


def quadRoots(b, c):
  '''The reference's stable roots of t^2 + b t + c (`_quadraticRoots` with
  a = 1), sorted; +inf where there are none. Shared by the quartic below
  and the kernels' plain versions (NaN-ignoring min / max, as in CUDA).'''
  inf = _full(b, _BIG)
  disc = b * b - 4. * c
  ok = disc >= 0
  q = -0.5 * (b + torch.sign(b + 1e-30) * sqrtPositive(disc))
  qS = torch.where(torch.abs(q) < 1e-20, _full(q, 1e-20), q)
  t2 = c / qS
  lo, hi = torch.fmin(q, t2), torch.fmax(q, t2)
  return torch.where(ok, lo, inf), torch.where(ok, hi, inf)


def quadraticRoots(a, b, c):
  '''Numerically stable roots of a t^2 + b t + c, sorted; +inf where there
  are none (the reference's `_quadraticRoots`).'''
  inf = _full(b, _BIG)
  disc = b * b - 4 * a * c
  ok = disc >= 0
  q = -0.5 * (b + torch.sign(b + 1e-30) * sqrtPositive(disc))
  aSafe = torch.where(torch.abs(a) < 1e-20, _full(a, 1e-20), a)
  t1 = q / aSafe
  qSafe = torch.where(torch.abs(q) < 1e-20, _full(q, 1e-20), q)
  t2 = c / qSafe
  lo, hi = torch.minimum(t1, t2), torch.maximum(t1, t2)
  return torch.where(ok, lo, inf), torch.where(ok, hi, inf)


def _pickRoot(t1, t2, valid1, valid2):
  '''Smallest valid root, else +inf.'''
  return torch.minimum(torch.where(valid1, t1, _full(t1, _BIG)),
                       torch.where(valid2, t2, _full(t2, _BIG)))


def cubicLargestRoot(B, C, D):
  '''Largest real root of S^3 + B S^2 + C S + D by 28 damped Newton steps
  from above the Cauchy bound (the reference's `_cubicLargestRoot`; the
  kernels' plain versions call it too).'''
  S = 1. + torch.fmax(torch.abs(B), torch.fmax(torch.abs(C), torch.abs(D)))
  for _ in range(28):
    f = ((S + B) * S + C) * S + D
    fp = (3. * S + 2. * B) * S + C
    fp = torch.where(torch.abs(fp) < 1e-20, _full(fp, 1e-20), fp)
    step = f / fp
    lim = torch.abs(S) + 1.
    S = S - torch.fmin(torch.fmax(step, -torch.abs(S) - 1.), lim)
  return S


def quarticSmallestRoot(b, c, d, e, tMin, validFn):
  '''Smallest root t > tMin of t^4 + b t^3 + c t^2 + d t + e with
  validFn(t), else +inf: the reference's `_quarticSmallestRoot` (Ferrari
  through the resolvent cubic, each candidate polished by three Newton
  steps), every power written as products.'''
  inf = _full(b, _BIG)
  four, eight = _full(b, 4.), _full(b, 8.)
  b4 = b / four
  bb = b * b
  p = c - 3. * b * b / eight
  q = d - b * c / _full(b, 2.) + b * bb / eight
  r = (e - b * d / four + bb * c / _full(b, 16.)
       - 3. * (bb * bb) / _full(b, 256.))
  S = torch.fmax(cubicLargestRoot(2. * p, p * p - 4. * r, -q * q),
                 torch.zeros_like(p))
  biquad = S < 1e-10 * (1. + torch.abs(p))
  one = _full(S, 1.)
  s = torch.sqrt(torch.where(biquad, one, S))
  sSafe = torch.where(biquad, one, s)
  A = 0.5 * (p + S - q / sSafe)
  Bb = 0.5 * (p + S + q / sSafe)
  y1, y2 = quadRoots(p, r)
  zero = torch.zeros_like(S)
  A = torch.where(biquad, torch.where(y1 < inf, -y1, zero), A)
  Bb = torch.where(biquad, torch.where(y2 < inf, -y2, zero), Bb)
  sQ = torch.where(biquad, zero, s)
  u1, u2 = quadRoots(sQ, A)
  u3, u4 = quadRoots(-sQ, Bb)
  tBest = inf
  for u in (u1, u2, u3, u4):
    t = torch.where(u < inf, u - b4, inf)
    for _ in range(3):
      f = (((t + b) * t + c) * t + d) * t + e
      fp = ((4. * t + 3. * b) * t + 2. * c) * t + d
      fp = torch.where(torch.abs(fp) < 1e-20, _full(fp, 1e-20), fp)
      t = torch.where(t < inf, t - f / fp, t)
    ok = (t > tMin) & (t < inf) & validFn(t)
    tBest = torch.fmin(tBest, torch.where(ok, t, inf))
  return tBest


def primInside(shape, x, y, z, cx, cy, p0, p1, ca, sa):
  '''Whether the local point (x, y, z) lies inside one trim primitive of
  payload (cx, cy, p0, p1, ca, sa): shape 1 rotated rectangle, 2 disc, 3
  half-plane, 4 poly2, 5 general conic (payload A..F), 6 half-space. A
  python `shape` evaluates its own formula; a tensor of shapes selects per
  element, as the reference's where-chain does.'''
  dxp, dyp = x - cx, y - cy

  def rotated():
    return ca * dxp + sa * dyp, -sa * dxp + ca * dyp

  def rect():
    xr, yr = rotated()
    return (torch.abs(xr) <= p0) & (torch.abs(yr) <= p1)

  def poly():
    xr, yr = rotated()
    return yr <= p0 * xr * xr + p1 * xr

  shapes = (rect,
            lambda: dxp * dxp + dyp * dyp <= p0,
            lambda: dxp * p0 + dyp * p1 >= 0,
            poly,
            lambda: (cx * x * x + cy * x * y + p0 * y * y + p1 * x + ca * y
                     + sa) <= 0.,
            lambda: x * cx + y * cy + z * p0 >= p1)
  if not isinstance(shape, torch.Tensor):
    return shapes[sum(shape > t for t in (1.5, 2.5, 3.5, 4.5, 5.5))]()
  out = shapes[0]()
  for k, threshold in enumerate((1.5, 2.5, 3.5, 4.5, 5.5)):
    out = torch.where(shape > threshold, shapes[k + 1](), out)
  return out


def _maskLookup(trim, mask, u, v):
  '''Bitmap trim sample: (u, v) chart coordinates onto each surface's
  (R, R) occupancy bitmap (v-major; `mask` is (S, R, R)), with the
  conservative clip at the window border.'''
  R = mask.shape[-1]
  pu = (u - _col(trim, 1)) * _col(trim, 3)
  pv = (v - _col(trim, 2)) * _col(trim, 4)

  def pixel(x):
    x = torch.nan_to_num(torch.floor(x), nan=0., posinf=R - 1., neginf=0.)
    return torch.clamp(x, 0, R - 1).to(torch.int64)

  inWindow = (pu >= 0) & (pu < R) & (pv >= 0) & (pv < R)
  rows = torch.arange(mask.shape[0], device=u.device)[:, None]
  return inWindow & (mask[rows, pixel(pv), pixel(pu)] > 0)


def _applyPrims(prims, x, y, z, baseOk):
  '''Boolean-cut trim algebra over each surface's (H, 7) primitive rows
  (flag, cx, cy, p0, p1, cosA, sinA), flag = shape + 10*isAdd +
  20*isInverted, 0 inactive: occupied = (base OR any add-prim) AND NOT any
  hole-prim (the reference's `_applyPrims`).'''
  addHit = torch.zeros_like(baseOk)
  holeHit = torch.zeros_like(baseOk)
  for h in range(prims.shape[1]):
    row = prims[:, h, :]
    flag = _col(row, 0)
    isInv = flag > 15.5
    rem = flag - torch.where(isInv, 20., 0.)
    isAdd = rem > 5.5
    shape = rem - torch.where(isAdd, 10., 0.)
    inP = primInside(shape, x, y, z, *(_col(row, i) for i in range(1, 7)))
    inP = (inP != isInv) & (flag > 0.5)
    addHit = addHit | (inP & isAdd)
    holeHit = holeHit | (inP & ~isAdd)
  return (baseOk | addHit) & ~holeHit


def _trimBandOk(trim, mask, p, v, prims=None):
  '''Shared trim of the axis-symmetric kinds: the band trim[1] <= v <=
  trim[2]; the UV bitmap when trim[0] == 2 (u = azimuth); the band with
  hole primitives when trim[0] == 3.'''
  band = (_col(trim, 1) <= v) & (v <= _col(trim, 2))
  if prims is not None:
    band = torch.where(_col(trim, 0) > 2.5,
                       _applyPrims(prims, p[0], p[1], p[2], band), band)
  if mask is None:
    return band
  u = chartAtan2(p[1], p[0])
  return torch.where(_col(trim, 0) == 2., _maskLookup(trim, mask, u, v),
                     band)


def _trimPlane(trim, p, mask=None, prims=None):
  t0 = _col(trim, 0)
  isRect = (t0 == 1.) | (t0 == 4.)
  rect = (torch.abs(p[0]) <= _col(trim, 1)) & (torch.abs(p[1]) <= _col(trim, 2))
  r = torch.sqrt(p[0] * p[0] + p[1] * p[1])
  ring = (_col(trim, 1) <= r) & (r <= _col(trim, 2))
  closed = torch.where(isRect, rect, ring)
  if prims is not None:
    closed = torch.where(t0 > 2.5,
                         _applyPrims(prims, p[0], p[1], p[2], closed), closed)
  if mask is None:
    return closed
  return torch.where(t0 == 2., _maskLookup(trim, mask, p[0], p[1]), closed)


def _at(o, d, t):
  return tuple(oi + t * di for oi, di in zip(o, d))


def _dot(a, b):
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _intersectPlane(params, trim, o, d, tMin, mask=None, prims=None):
  dz = torch.where(torch.abs(d[2]) < 1e-12, _full(d[2], 1e-12), d[2])
  t = -o[2] / dz
  ok = (t > tMin) & _trimPlane(trim, _at(o, d, t), mask, prims)
  return torch.where(ok, t, _full(t, _BIG))


def _bandRoots(t1, t2, o, d, trim, tMin, mask, prims, extraOk=None):
  '''The smallest of two roots that lies past tMin and within the band
  trim on local z (and `extraOk`).'''
  def ok(t):
    p = _at(o, d, t)
    good = (t > tMin) & _trimBandOk(trim, mask, p, p[2], prims)
    return good if extraOk is None else good & extraOk(t)
  return _pickRoot(t1, t2, ok(t1), ok(t2))


def _intersectSphere(params, trim, o, d, tMin, mask=None, prims=None):
  R = _col(params, 0)
  b = 2 * _dot(o, d)
  c = _dot(o, o) - R * R
  t1, t2 = quadraticRoots(_dot(d, d), b, c)
  return _bandRoots(t1, t2, o, d, trim, tMin, mask, prims)


def _intersectCylinder(params, trim, o, d, tMin, mask=None, prims=None):
  R = _col(params, 0)
  a = d[0] * d[0] + d[1] * d[1]
  b = 2 * (o[0] * d[0] + o[1] * d[1])
  c = o[0] * o[0] + o[1] * o[1] - R * R
  t1, t2 = quadraticRoots(a, b, c)
  return _bandRoots(t1, t2, o, d, trim, tMin, mask, prims)


def _intersectCone(params, trim, o, d, tMin, mask=None, prims=None):
  '''Cone |(x, y)| = r0 + z*tanA; only the nappe with w >= 0 is surface.'''
  r0, tanA = _col(params, 0), _col(params, 1)
  w0 = r0 + o[2] * tanA
  wd = d[2] * tanA
  a = d[0] * d[0] + d[1] * d[1] - wd * wd
  b = 2 * (o[0] * d[0] + o[1] * d[1] - w0 * wd)
  c = o[0] * o[0] + o[1] * o[1] - w0 * w0
  t1, t2 = quadraticRoots(a, b, c)
  return _bandRoots(t1, t2, o, d, trim, tMin, mask, prims,
                    lambda t: w0 + t * wd >= 0)


def _sag(params, r2):
  c, k = _col(params, 0), _col(params, 1)
  a4, a6, a8 = _col(params, 2), _col(params, 3), _col(params, 4)
  root = torch.sqrt(torch.clamp(1 - (1 + k) * c * c * r2, min=1e-12))
  return c * r2 / (1 + root) + r2 * r2 * (a4 + r2 * (a6 + r2 * a8))


def _sagPrimeOverR(params, r2):
  '''d(sag)/dr / r, well defined at r = 0.'''
  c, k = _col(params, 0), _col(params, 1)
  a4, a6, a8 = _col(params, 2), _col(params, 3), _col(params, 4)
  root = torch.sqrt(torch.clamp(1 - (1 + k) * c * c * r2, min=1e-12))
  base = c * (2 / (1 + root)
              + (1 + k) * c * c * r2 / (root * ((1 + root) * (1 + root))))
  return base + 4 * a4 * r2 + 6 * a6 * r2 * r2 + 8 * a8 * (r2 * r2 * r2)


def _signed(x, eps):
  return torch.sign(x + 1e-30) * eps


def _intersectAsphere(params, trim, o, d, tMin, mask=None, prims=None):
  '''24 Newton steps on f(t) = z(t) - sag(r(t)) from the vertex tangent
  plane or the osculating sphere, then the residual gate and the r-band
  trim (the reference's `_intersectAsphere`).'''
  c = _col(params, 0)
  dz = torch.where(torch.abs(d[2]) < 1e-9, _signed(d[2], 1e-9), d[2])
  t0Plane = -o[2] / dz
  R = 1. / torch.where(torch.abs(c) < 1e-12, _full(c, 1e-12), c)
  oc = (o[0] - 0. * R, o[1] - 0. * R, o[2] - R)
  b = 2 * _dot(oc, d)
  cc = _dot(oc, oc) - R * R
  s1, s2 = quadraticRoots(_dot(d, d), b, cc)
  sSphere = _pickRoot(s1, s2, s1 > tMin, s2 > tMin)
  t = torch.where(torch.isfinite(t0Plane) & (torch.abs(c) < 1e-12), t0Plane,
                  torch.where(torch.isfinite(sSphere), sSphere, t0Plane))
  t = torch.clamp(t, min=0.)
  for _ in range(24):
    p = _at(o, d, t)
    r2 = p[0] * p[0] + p[1] * p[1]
    f = p[2] - _sag(params, r2)
    g = _sagPrimeOverR(params, r2)
    slope = -g * p[0] * d[0] + -g * p[1] * d[1] + 1. * d[2]
    slope = torch.where(torch.abs(slope) < 1e-12, _signed(slope, 1e-12),
                        slope)
    t = t - f / slope
  p = _at(o, d, t)
  r2 = p[0] * p[0] + p[1] * p[1]
  resid = torch.abs(p[2] - _sag(params, r2))
  ok = ((t > tMin) & (resid < 1e-4)
        & _trimBandOk(trim, mask, p, torch.sqrt(r2), prims)
        & torch.isfinite(t))
  return torch.where(ok, t, _full(t, _BIG))


def _intersectQuadric(params, trim, o, d, tMin, mask=None, prims=None):
  '''f(o + t d) = 0 is an exact quadratic in t; a ~ 0 with b != 0 keeps
  the single linear root -c / b.'''
  qa, qb, qc, qz, q0 = (_col(params, i) for i in range(5))
  a = qa * d[0] * d[0] + qb * d[1] * d[1] + qc * d[2] * d[2]
  b = 2 * (qa * o[0] * d[0] + qb * o[1] * d[1] + qc * o[2] * d[2]) \
      + qz * d[2]
  c = (qa * o[0] * o[0] + qb * o[1] * o[1] + qc * o[2] * o[2]
       + qz * o[2] + q0)
  t1, t2 = quadraticRoots(a, b, c)
  linT = -c / torch.where(torch.abs(b) < 1e-20, _full(b, 1e-20), b)
  isLin = (torch.abs(a) < 1e-14 * (torch.abs(b) + 1e-20)) \
      & (torch.abs(b) > 1e-20)
  t1 = torch.where(isLin, linT, t1)
  t2 = torch.where(isLin, _full(t2, _BIG), t2)
  return _bandRoots(t1, t2, o, d, trim, tMin, mask, prims)


def _intersectTorus(params, trim, o, d, tMin, mask=None, prims=None):
  '''Ray-torus intersection: the ray re-anchored at its closest approach to
  the centre and scaled by R, the quartic's smallest valid root (residual
  gate and tube-angle trim), mapped back (the reference's
  `_intersectTorus`).'''
  R, r = _col(params, 0), _col(params, 1)
  dd = _dot(d, d)
  tMid = -_dot(o, d) / torch.where(dd < 1e-20, _full(dd, 1e-20), dd)
  oS = tuple(x / R for x in _at(o, d, tMid))
  sdd = torch.sqrt(dd)
  dS = tuple(x / sdd for x in d)
  rr = r / R
  K = _dot(oS, oS) + 1. - rr * rr
  bq = 2. * _dot(oS, dS)
  exy = dS[0] * dS[0] + dS[1] * dS[1]
  fxy = oS[0] * dS[0] + oS[1] * dS[1]
  gxy = oS[0] * oS[0] + oS[1] * oS[1]
  b = 2. * bq
  c = bq * bq + 2. * K - 4. * exy
  dL = 2. * bq * K - 8. * fxy
  e = K * K - 4. * gxy

  def valid(tau):
    pt = _at(o, d, tMid + tau * R / sdd)
    sxy = torch.sqrt(pt[0] * pt[0] + pt[1] * pt[1])
    g = (sxy - R) * (sxy - R) + pt[2] * pt[2] - r * r
    v = chartAtan2(pt[2], sxy - R)
    return (torch.abs(g) < 2e-3 * r * r + 1e-6 * R * R) \
        & _trimBandOk(trim, mask, pt, v, prims)

  tauMin = (tMin - tMid) * sdd / R
  tau = quarticSmallestRoot(b, c, dL, e, tauMin, valid)
  t = tMid + tau * R / sdd
  return torch.where(tau < _BIG, t, _full(t, _BIG))


def _intersectTriangle(params, trim, o, d, tMin, mask=None, prims=None):
  '''Moeller-Trumbore.'''
  v0 = tuple(_col(params, i) for i in range(3))
  e1 = tuple(_col(params, 3 + i) - v0[i] for i in range(3))
  e2 = tuple(_col(params, 6 + i) - v0[i] for i in range(3))
  pvec = _cross(d, e2)
  det = _dot(e1, pvec)
  detSafe = torch.where(torch.abs(det) < 1e-12, _full(det, 1e-12), det)
  tvec = tuple(o[i] - v0[i] for i in range(3))
  u = _dot(tvec, pvec) / detSafe
  qvec = _cross(tvec, e1)
  v = _dot(d, qvec) / detSafe
  t = _dot(e2, qvec) / detSafe
  ok = ((torch.abs(det) > 1e-12) & (u >= 0) & (v >= 0) & (u + v <= 1)
        & (t > tMin))
  return torch.where(ok, t, _full(t, _BIG))


def _cross(a, b):
  return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
          a[0] * b[1] - a[1] * b[0])


KIND_INTERSECTORS = {
    'plane': _intersectPlane, 'sphere': _intersectSphere,
    'cylinder': _intersectCylinder, 'asphere': _intersectAsphere,
    'triangle': _intersectTriangle, 'cone': _intersectCone,
    'quadric': _intersectQuadric, 'torus': _intersectTorus}


def byKind(table, device='cpu'):
  '''The split of the (kind-sorted) surface table that the record tracer's
  sweep reads: {kind name: dict(params, trim, w2lRot, w2lOff[, mask,
  trimPrims])} of float32 tensors on `device`, one entry per kind present,
  in kind-code order. `mask` is each bitmap surface's own (R, R) bitmap
  (`trimMasks[trimMaskIdx]`), present where the kind has a bitmap trim;
  `trimPrims` where it has primitive trims.'''
  def host(key):
    x = table[key]
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)

  kinds, trim = host('kind'), host('trim')
  out = {}
  for kind in sorted(set(kinds.tolist())):
    sel = np.nonzero(kinds == kind)[0]
    sl = slice(int(sel[0]), int(sel[-1]) + 1)
    sub = {k: torch.as_tensor(host(k)[sl], dtype=torch.float32,
                              device=device)
           for k in ('params', 'trim', 'w2lRot', 'w2lOff')}
    if 'trimMasks' in table and (trim[sl, 0] == 2.).any():
      sub['mask'] = torch.as_tensor(
          host('trimMasks')[host('trimMaskIdx')[sl]], device=device)
    if 'trimPrims' in table and (trim[sl, 0] > 2.5).any():
      sub['trimPrims'] = torch.as_tensor(host('trimPrims')[sl],
                                         dtype=torch.float32, device=device)
    out[_KIND_NAMES[kind]] = sub
  return out


def intersectLocal(kind, params, trim, o, d, tMin, mask=None, prims=None):
  '''Nearest valid intersection parameter t of local-frame rays `o`, `d`
  ((N, 3) tensors) with ONE surface of code `kind` (params (9,), trim (6,);
  a bitmap `mask` (R, R), primitive rows `prims` (H, 7)); +inf where there
  is none.'''
  fn = KIND_INTERSECTORS[_KIND_NAMES[int(kind)]]
  t = fn(params.reshape(1, -1), trim.reshape(1, -1),
         tuple(o[:, i][None] for i in range(3)),
         tuple(d[:, i][None] for i in range(3)), tMin,
         mask=None if mask is None else mask[None],
         prims=None if prims is None else prims[None])
  return t[0]


def _normalize(x, y, z, eps=1e-20):
  inv = torch.rsqrt(x * x + y * y + z * z + eps)
  return x * inv, y * inv, z * inv


def normalLocal(kind, params, x, y, z):
  '''Canonical (un-oriented) unit normals at local points (x, y, z), per
  ray: `kind` (N,) surface codes, `params` (N, 9): the reference's
  `normalLocal`, selected per kind as the JAX package's batched
  `batch_tracer._localNormal` does. Returns (nx, ny, nz).'''
  P = [params[:, i] for i in range(9)]
  # sphere
  sx, sy, sz = _normalize(x, y, z)
  # cylinder
  cx, cy, _ = _normalize(x, y, torch.zeros_like(z))
  # asphere
  r2 = x * x + y * y
  c, k = P[0], P[1]
  root = torch.sqrt(torch.clamp(1 - (1 + k) * c * c * r2, min=1e-12))
  g = (c * (2 / (1 + root)
            + (1 + k) * c * c * r2 / (root * ((1 + root) * (1 + root))))
       + 4 * P[2] * r2 + 6 * P[3] * r2 * r2 + 8 * P[4] * (r2 * r2 * r2))
  ax, ay, az = _normalize(-g * x, -g * y, torch.ones_like(z))
  # triangle
  e1 = (P[3] - P[0], P[4] - P[1], P[5] - P[2])
  e2 = (P[6] - P[0], P[7] - P[1], P[8] - P[2])
  tx, ty, tz = _normalize(*_cross(e1, e2))
  # cone: radial out, tipped by -tanAngle along z
  r = sqrtPositive(r2)
  rSafe = torch.where(r < 1e-12, _full(r, 1e-12), r)
  kx, ky, kz = _normalize(x / rSafe, y / rSafe, -P[1] * torch.ones_like(z))
  # quadric: grad f
  qx, qy, qz = _normalize(2 * P[0] * x, 2 * P[1] * y, 2 * P[2] * z + P[3])
  # torus: (p - tube-circle centre) / r
  toScale = P[0] / rSafe
  ox, oy, oz = _normalize(x * (1. - toScale), y * (1. - toScale), z)
  zero, one = torch.zeros_like(x), torch.ones_like(x)
  byCode = {SPHERE: (sx, sy, sz), CYLINDER: (cx, cy, zero),
            ASPHERE: (ax, ay, az), TRIANGLE: (tx, ty, tz),
            CONE: (kx, ky, kz), QUADRIC: (qx, qy, qz), TORUS: (ox, oy, oz)}
  out = [zero, zero, one]                 # plane: +z
  for code in (TORUS, QUADRIC, CONE, TRIANGLE, ASPHERE, CYLINDER, SPHERE):
    m = kind == code
    out = [torch.where(m, v, o) for v, o in zip(byCode[code], out)]
  return tuple(out)
