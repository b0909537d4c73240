'''
Analytic surface tables — host-side scene geometry of the port (counterpart
of the JAX package's geometry/surfaces.py, same encoding and column layout).

This slice carries the kinds and trims of the main path only:

kind (int32):
  0 PLANE     local z=0 plane.
  1 SPHERE    centered at local origin, radius params[0] (>0).
  2 CYLINDER  axis = local z, radius params[0].
The other kind codes (asphere, triangle, cone, quadric, torus) are reserved
with the reference's numbering; their constructors are not ported yet and
`buildSurfaceTable` refuses them.

trim (float32[6]): per-kind trim window:
  PLANE:    trim[0] shape flag (0=annulus, 1=rectangle);
            annulus: r in [trim[1], trim[2]]; rect: |x|<=trim[1], |y|<=trim[2]
  SPHERE:   z in [trim[1], trim[2]] (cap/zone selection)
  CYLINDER: z in [trim[1], trim[2]]
Bitmap trims (trim[0] == 2) and hole-primitive trims (3, 4) are not ported
yet.

orient (float32, +1/-1): multiplies the canonical normal to yield the
*outward-of-solid* normal, which defines the entering/exiting decision.
Canonical normals: plane +z, sphere radially out, cylinder radially out.

The intersection maths itself lives with the kernel and its plain PyTorch
version (ops/cuda_trace.py, csrc/trace_kernel.cu).
'''

import numpy as np

from . import transforms

PLANE, SPHERE, CYLINDER, ASPHERE, TRIANGLE, CONE, QUADRIC, TORUS = \
    0, 1, 2, 3, 4, 5, 6, 7
N_PARAMS, N_TRIM = 9, 6
_KIND_NAMES = {0: 'plane', 1: 'sphere', 2: 'cylinder', 3: 'asphere',
               4: 'triangle', 5: 'cone', 6: 'quadric', 7: 'torus'}
PORTED_KINDS = (PLANE, SPHERE, CYLINDER)


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


def buildSurfaceTable(surfs, dtype=np.float32):
  '''Pack a list of surface dicts into a SoA table of host numpy arrays
  (scene compilation is host-side; Scene.compile moves the table to the
  requested device in one go).

  Surfaces are SORTED BY KIND like the reference's table, so surface
  indices — and with them the lowest-index tie-break of the nearest-hit
  search — agree between the two packages.'''
  if not surfs:
    raise ValueError('scene contains no surfaces')
  for s in surfs:
    if s['kind'] not in PORTED_KINDS:
      raise NotImplementedError(
          f'surface kind {_KIND_NAMES.get(s["kind"], s["kind"])!r} is not '
          f'ported yet (plane, sphere and cylinder are)')
    if 'trimBitmap' in s or 'trimPrims' in s or s['trim'][0] not in (0., 1.):
      raise NotImplementedError(
          'bitmap and hole-primitive trims are not ported yet (window, '
          'annulus and z-band trims are)')
  surfs = sorted(surfs, key=lambda s: s['kind'])
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
