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
  import torch
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
