'''
The record tracer's bounce, column-SoA (counterpart of the JAX package's
tracing/batch_tracer.py, which is plain XLA; this is plain PyTorch on an
explicit device).

Ray state lives in (N,) component columns; all per-hit surface data arrives
through ONE packed-row gather (`surfaces['packed'][idx]`), element data
through one more; rigid transforms apply as column multiply-adds, and the
local-to-world rotation is the transpose of the packed world-to-local one.
The sweep tests every surface of one kind against every ray at once
((S_k, N) tensors, `geometry/surfaces.KIND_INTERSECTORS`), in ray chunks
that bound the size of its temporaries.

The physics is the reference's (freecad_elements/ray.py:36-281, see
tracing/tracer.py): nearest hit with its tie rule (the lowest surface index
wins on equal distances), Mirror, Lens (Snell with total internal
reflection and medium tracking), Ludwig-1970 gratings, Absorber, Vacuum,
Beer-Lambert absorption, n(lambda) by linear interpolation, surface and
sequential-stage masks, and stochastic scatter on the exact gather path
(`_scatterDraw`), as the reference's record tracer draws it (the fitted
constants of `tracing/scatter.scatterConstants` serve the kernels). Random
draws come from an explicit torch.Generator.
'''

import numpy as np
import torch

from .. import hostArray
from ..geometry import surfaces as S
from ..geometry.surfaces import (PACKED_ROT, PACKED_OFF, PACKED_ORIENT,
                                 PACKED_ELEM, PACKED_KIND, PACKED_PARAMS)
from .element_table import (MIRROR, LENS, GRATING, ABSORBER, VACUUM,
                            VACUUM_MEDIUM, GRATING_REFLECTION, EP_OPTTYPE,
                            EP_REFRINDEX, EP_REFLECTIVITY, EP_ABSLENGTH,
                            EP_GRATTYPE, EP_GRATLPM, EP_GRATDIRX, EP_GRATDIRY,
                            EP_GRATDIRZ, EP_GRATORDER, EP_RECORDHITS)

# the sweep's temporaries hold at most this many (surface, ray) elements
# each; larger sweeps go through the rays in chunks
SWEEP_CHUNK_ELEMENTS = 1 << 22


def prepareScene(scene, device='cpu'):
  '''The tensors the record tracer reads, from a compiled scene (the host
  dict of `Scene.compile(device=None)`, or the JAX package's tables carried
  over as numpy): `surfaces` (`byKind`, `packed`, `elem`, and the per-surface
  `kind`, `params`, `orient`, `w2lRot`, `w2lOff` that `intersect.hitNormal`
  reads), `elements` (`packed` and, for dispersive glass, `nLambda`,
  `nTable`, `hasDispersion`), `seqMask`, `surfMask`, `scatter` and
  `powerTol`, on `device`. A prepared scene passes through unchanged.'''
  if scene.get('_prepared'):
    return scene
  dev = torch.device(device)
  f32 = lambda x: torch.as_tensor(hostArray(x), dtype=torch.float32,
                                  device=dev)
  surf = scene['surfaces']
  rot = hostArray(surf['packed'])[:, PACKED_ROT:PACKED_ROT + 9]
  surfaces = dict(
      byKind=S.byKind(surf, dev),
      packed=f32(surf['packed']),
      elem=torch.as_tensor(hostArray(surf['packed'])[:, PACKED_ELEM]
                           .astype(np.int64), device=dev),
      kind=torch.as_tensor(hostArray(surf['kind']).astype(np.int64),
                           device=dev),
      params=f32(hostArray(surf['packed'])[:, PACKED_PARAMS:]),
      orient=f32(hostArray(surf['packed'])[:, PACKED_ORIENT]),
      w2lRot=f32(rot.reshape(-1, 3, 3)),
      w2lOff=f32(hostArray(surf['packed'])[:, PACKED_OFF:PACKED_OFF + 3]))
  el = scene['elements']
  elements = dict(packed=f32(el['packed']),
                  _hostOptType=hostArray(el['packed'])[:, EP_OPTTYPE]
                  .astype(np.int64))
  if 'nTable' in el:
    elements.update(nLambda=f32(el['nLambda']), nTable=f32(el['nTable']),
                    hasDispersion=torch.as_tensor(
                        hostArray(el['hasDispersion']).astype(bool),
                        device=dev))
  out = dict(_prepared=True, surfaces=surfaces, elements=elements,
             powerTol=float(scene.get('powerTol', 1e-6)))
  for key in ('seqMask', 'surfMask'):
    if scene.get(key) is not None:
      out[key] = torch.as_tensor(hostArray(scene[key]).astype(bool),
                                 device=dev)
  if 'scatter' in scene:
    sc = {}
    for k, v in scene['scatter'].items():
      a = hostArray(v)
      sc[k] = torch.as_tensor(a.astype(bool) if k == 'flags'
                              else a.astype(np.float32), device=dev)
    if 'phiInvPairs' not in sc:
      for name in ('phiInv', 'thetaInv'):
        a = hostArray(scene['scatter'][name]).astype(np.float32)
        sc[name + 'Pairs'] = torch.as_tensor(
            np.stack([a[..., :-1], a[..., 1:]], -1).reshape(-1, 2),
            device=dev)
    out['scatter'] = sc
  return out


def _dot3(ax, ay, az, bx, by, bz):
  return ax * bx + ay * by + az * bz


def _cross3(ax, ay, az, bx, by, bz):
  return (ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx)


def _norm3(ax, ay, az, eps=1e-20):
  inv = torch.rsqrt(ax * ax + ay * ay + az * az + eps)
  return ax * inv, ay * inv, az * inv


def allDistancesBatch(table, ox, oy, oz, dx, dy, dz, tMin, seqAllowed=None):
  '''(S, N) distance matrix, surface-major, from a per-kind sweep: each
  surface's world-to-local transform is applied as broadcast scalars.
  `table` is a prepared scene's `surfaces` (it reads `byKind`);
  `seqAllowed` (bool, (S, N) or (S, 1)) masks surfaces per ray.'''
  parts = []
  N = ox.shape[0]
  for name in sorted(table['byKind'], key=S.KIND_CODES.get):
    sub = table['byKind'][name]
    fn = S.KIND_INTERSECTORS[name]
    rot, off = sub['w2lRot'], sub['w2lOff']
    Sk = rot.shape[0]
    r = [[rot[:, i, j:j + 1] for j in range(3)] for i in range(3)]
    of = [off[:, i:i + 1] for i in range(3)]
    chunk = max(1, SWEEP_CHUNK_ELEMENTS // Sk)
    pieces = []
    for a in range(0, N, chunk):
      x, y, z = ox[a:a + chunk][None], oy[a:a + chunk][None], \
          oz[a:a + chunk][None]
      u, v, w = dx[a:a + chunk][None], dy[a:a + chunk][None], \
          dz[a:a + chunk][None]
      lo = tuple(r[i][0] * x + r[i][1] * y + r[i][2] * z + of[i]
                 for i in range(3))
      ld = tuple(r[i][0] * u + r[i][1] * v + r[i][2] * w for i in range(3))
      pieces.append(fn(sub['params'], sub['trim'], lo, ld, tMin,
                       mask=sub.get('mask'), prims=sub.get('trimPrims')))
    parts.append(torch.cat(pieces, 1) if len(pieces) > 1 else pieces[0])
  t = torch.cat(parts) if len(parts) > 1 else parts[0]
  if seqAllowed is not None:
    t = torch.where(seqAllowed, t, torch.full_like(t, float('inf')))
  return t


def selectNearestBatch(t, elem, medium, distTol, maxRayLength):
  '''The reference's tie rule (ray.py:388-401) on a (S, N) distance
  matrix: clip to maxRayLength; among the hits within [tMin, tMin +
  2*distTol] prefer the closest whose element is not the ray's medium,
  else the closest overall; equal distances go to the lowest surface index
  (torch.argmin returns the first minimum). Returns (idx, tHit, hasHit).'''
  inf = torch.full_like(t, float('inf'))
  t = torch.where(t <= maxRayLength, t, inf)
  tMin = torch.amin(t, 0)
  valid = torch.isfinite(t)
  prefer = valid & (t <= tMin[None, :] + 2 * distTol) \
      & (elem[:, None] != medium[None, :])
  hasPrefer = prefer.any(0)
  tPref = torch.where(prefer, t, inf)
  idx = torch.where(hasPrefer, torch.argmin(tPref, 0), torch.argmin(t, 0))
  hasHit = torch.isfinite(tMin)
  tHit = torch.where(hasPrefer, torch.amin(tPref, 0), tMin)
  return idx, torch.where(hasHit, tHit, torch.full_like(tHit, float('inf'))), \
      hasHit


def interpRows(x, xp, fp):
  '''jnp.interp of each ray's wavelength `x` (N,) on the shared grid `xp`
  (L,) through its own row of `fp` (N, L), in jnp.interp's formula
  (constant beyond the ends).'''
  L = xp.shape[0]
  i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True), 1,
                  L - 1)
  lo = fp.gather(1, (i - 1)[:, None])[:, 0]
  hi = fp.gather(1, i[:, None])[:, 0]
  dxp = xp[i] - xp[i - 1]
  delta = x - xp[i - 1]
  dx0 = torch.abs(dxp) <= float(np.spacing(np.finfo(np.float32).eps))
  f = torch.where(dx0, lo,
                  lo + (delta / torch.where(dx0, torch.ones_like(dxp), dxp))
                  * (hi - lo))
  f = torch.where(x < xp[0], fp[:, 0], f)
  return torch.where(x > xp[-1], fp[:, -1], f)


def _rot3(vx, vy, vz, ax, ay, az, angle):
  '''Rodrigues rotation of column vectors v about unit axes a.'''
  c, s = torch.cos(angle), torch.sin(angle)
  cx, cy, cz = _cross3(ax, ay, az, vx, vy, vz)
  dot = ax * vx + ay * vy + az * vz
  return (vx * c + cx * s + ax * dot * (1 - c),
          vy * c + cy * s + ay * dot * (1 - c),
          vz * c + cz * s + az * dot * (1 - c))


def _discrete(sc, name, base, u, cont):
  '''A discrete (DiracDelta) event drawn by `u` over the events of table
  row `base`, else the continuous draw `cont`.'''
  D = sc[name + 'Vals'].shape[-1]
  cumF = sc[name + 'Cum'].reshape(-1, D)[base]
  valF = sc[name + 'Vals'].reshape(-1, D)[base]
  dIdx = torch.clamp((u[:, None] > cumF).sum(1), 0, D - 1)
  return torch.where(u <= cumF[:, D - 1],
                     valF.gather(1, dIdx[:, None])[:, 0], cont)


def _scatterDraw(sc, elemIdx, kind, tinIdx, u1, u2, u3, u4):
  '''Draw (thetaOut, phiOut) from the stacked conditional scatter tables
  (models/scatter.py): phi from its marginal, theta conditioned on the
  drawn phi, each by linear interpolation in its inverse CDF through one
  gather of (lo, hi) pair rows.'''
  E, K, Tin, Q = sc['phiInv'].shape
  M = sc['thetaInv'].shape[3]
  base = (elemIdx * K + kind) * Tin + tinIdx

  pos = u1 * (Q - 1)
  j = torch.clamp(pos.to(torch.int64), 0, Q - 2)
  frac = pos - j
  pairP = sc['phiInvPairs'][base * (Q - 1) + j]
  phiOut = pairP[:, 0] + frac * (pairP[:, 1] - pairP[:, 0])
  if 'phiDiscVals' in sc:
    phiOut = _discrete(sc, 'phiDisc', base, u3, phiOut)

  phiIdx = torch.clamp(torch.round(
      (phiOut - sc['phiGridLo']) / sc['phiGridStep']).to(torch.int64),
      0, M - 1)
  pos2 = u2 * (Q - 1)
  j2 = torch.clamp(pos2.to(torch.int64), 0, Q - 2)
  frac2 = pos2 - j2
  pairT = sc['thetaInvPairs'][(base * M + phiIdx) * (Q - 1) + j2]
  thetaOut = pairT[:, 0] + frac2 * (pairT[:, 1] - pairT[:, 0])
  if 'thetaDiscVals' in sc:
    thetaOut = _discrete(sc, 'thetaDisc', base, u4, thetaOut)
  return thetaOut, phiOut


def bounceBatch(scene, distTol, maxRayLength, o, d, power, wl, medium, seq,
                alive, generator=None):
  '''One bounce for the whole batch: returns (newState, records), state
  (o (N, 3), d (N, 3), power, wl, medium int64, seq int64, alive bool),
  records of column fields plus the local hit coordinates (plx, ply).
  `scene` is prepared (`prepareScene`); `generator` (a torch.Generator on
  the rays' device) draws the scatter uniforms, and scatter is skipped
  without one. A scene without a grating (the element types `prepareScene`
  keeps on the host) skips the grating formulas.'''
  surf = scene['surfaces']
  elements = scene['elements']
  N = o.shape[0]
  ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
  dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
  inf = float('inf')

  seqAllowed = scene.get('surfMask')
  if seqAllowed is not None:
    seqAllowed = seqAllowed[:, None]
  if 'seqMask' in scene:
    seqMask = scene['seqMask']
    q = torch.clamp(seq, 0, seqMask.shape[0] - 1)
    allowed = seqMask[q].T                          # (S, N)
    seqAllowed = allowed if seqAllowed is None else (allowed & seqAllowed)

  t = allDistancesBatch(surf, ox, oy, oz, dx, dy, dz, distTol, seqAllowed)
  idx, tHit, hasHit = selectNearestBatch(t, surf['elem'], medium, distTol,
                                         maxRayLength)
  tSeg = torch.where(hasHit, tHit, torch.full_like(tHit, maxRayLength))
  px, py, pz = ox + tSeg * dx, oy + tSeg * dy, oz + tSeg * dz

  # ---- one packed gather per table ----
  sp = surf['packed'][idx]                        # (N, Ks)
  r = [sp[:, PACKED_ROT + i] for i in range(9)]
  offx, offy, offz = (sp[:, PACKED_OFF], sp[:, PACKED_OFF + 1],
                      sp[:, PACKED_OFF + 2])
  orient = sp[:, PACKED_ORIENT]
  elemIdx = sp[:, PACKED_ELEM].to(torch.int64)
  kindf = sp[:, PACKED_KIND].to(torch.int64)
  prm = sp[:, PACKED_PARAMS:PACKED_PARAMS + 9]

  medIdx = torch.clamp(medium, min=0)
  ep = elements['packed'][elemIdx]                # (N, Ke)
  epMed = elements['packed'][medIdx]
  optType = ep[:, EP_OPTTYPE].to(torch.int64)
  reflectivity = ep[:, EP_REFLECTIVITY]
  gratType = ep[:, EP_GRATTYPE].to(torch.int64)
  gratLpm = ep[:, EP_GRATLPM]
  gDirX, gDirY, gDirZ = (ep[:, EP_GRATDIRX], ep[:, EP_GRATDIRY],
                         ep[:, EP_GRATDIRZ])
  gratOrder = ep[:, EP_GRATORDER]
  recordHits = ep[:, EP_RECORDHITS] > 0.5
  one = torch.ones_like(px)

  # refractive index (dispersion-aware)
  if 'nTable' in elements:
    nTab, grid = elements['nTable'], elements['nLambda']
    disp = interpRows(wl, grid, nTab[elemIdx])
    nElem = torch.where(elements['hasDispersion'][elemIdx], disp,
                        ep[:, EP_REFRINDEX])
    nMedRaw = interpRows(wl, grid, nTab[medIdx])
    nMedium = torch.where(
        medium >= 0,
        torch.where(elements['hasDispersion'][medIdx], nMedRaw,
                    epMed[:, EP_REFRINDEX]), one)
  else:
    nElem = ep[:, EP_REFRINDEX]
    nMedium = torch.where(medium >= 0, epMed[:, EP_REFRINDEX], one)

  # ---- local hit point & normal ----
  plx = r[0] * px + r[1] * py + r[2] * pz + offx
  ply = r[3] * px + r[4] * py + r[5] * pz + offy
  plz = r[6] * px + r[7] * py + r[8] * pz + offz
  nlx, nly, nlz = S.normalLocal(kindf, prm, plx, ply, plz)
  nwx = r[0] * nlx + r[3] * nly + r[6] * nlz
  nwy = r[1] * nlx + r[4] * nly + r[7] * nlz
  nwz = r[2] * nlx + r[5] * nly + r[8] * nlz
  outx, outy, outz = nwx * orient, nwy * orient, nwz * orient
  cosA = _dot3(dx, dy, dz, outx, outy, outz)
  isEntering = cosA < 0
  sgn = torch.where(isEntering, -one, one)
  nx, ny, nz = outx * sgn, outy * sgn, outz * sgn   # forward normal

  powerBefore = power
  # Beer-Lambert (multiplicative; see tracing/tracer.py)
  inMedium = medium >= 0
  absLenMed = torch.where(inMedium, epMed[:, EP_ABSLENGTH],
                          torch.full_like(px, inf))
  factor = torch.where(
      absLenMed == 0, torch.zeros_like(px),
      torch.where(torch.isfinite(absLenMed),
                  torch.exp(-tSeg / torch.clamp(absLenMed, min=1e-30)), one))
  power = torch.where(inMedium, power * factor, power)

  # ---- interactions ----
  dDotN = _dot3(dx, dy, dz, nx, ny, nz)
  mx, my, mz = dx - 2 * nx * dDotN, dy - 2 * ny * dDotN, dz - 2 * nz * dDotN

  # Snell (n forward): mu = n1/n2
  n1 = nMedium
  n2 = torch.where(isEntering, nElem, one)
  mu = n1 / n2
  cx_, cy_, cz_ = _cross3(nx, ny, nz, dx, dy, dz)
  sin2 = cx_ * cx_ + cy_ * cy_ + cz_ * cz_
  root = 1 - mu * mu * sin2
  tir = root < 0
  tx_, ty_, tz_ = dx - nx * dDotN, dy - ny * dDotN, dz - nz * dDotN
  sq = S.sqrtPositive(root)
  sxx, syy, szz = mu * tx_ + nx * sq, mu * ty_ + ny * sq, mu * tz_ + nz * sq
  snx = torch.where(tir, mx, sxx)
  sny = torch.where(tir, my, syy)
  snz = torch.where(tir, mz, szz)

  # grating (Ludwig 1970, incidence-side normal; see tracer.gratingDirection)
  isReflG = gratType == GRATING_REFLECTION
  if (elements['_hostOptType'] == GRATING).any():
    gratX, gratY, gratZ, evanescent = _gratingDirections(
        isReflG, isEntering, nMedium, nElem, nx, ny, nz, dx, dy, dz,
        gDirX, gDirY, gDirZ, wl, gratLpm, gratOrder, snx, sny, snz)
  else:
    gratX, gratY, gratZ = dx, dy, dz
    evanescent = torch.zeros_like(isReflG)

  isMirror = optType == MIRROR
  isLens = optType == LENS
  isGrating = optType == GRATING
  isAbsorber = optType == ABSORBER

  ndx = torch.where(isMirror, mx, torch.where(isLens, snx,
                    torch.where(isGrating, gratX, dx)))
  ndy = torch.where(isMirror, my, torch.where(isLens, sny,
                    torch.where(isGrating, gratY, dy)))
  ndz = torch.where(isMirror, mz, torch.where(isLens, snz,
                    torch.where(isGrating, gratZ, dz)))
  ndx, ndy, ndz = _norm3(ndx, ndy, ndz)

  # ---- stochastic scatter (reference: optical_group.py:281-325) ----
  if 'scatter' in scene and generator is not None:
    ndx, ndy, ndz = _scatter(scene['scatter'], generator, elemIdx,
                             isMirror, isLens, isEntering, hasHit, dDotN,
                             nx, ny, nz, dx, dy, dz, ndx, ndy, ndz)

  lensExitToVacuum = isLens & ~isEntering & ~tir & (medium == elemIdx)
  gratTransEnter = isGrating & ~isReflG & isEntering
  gratTransExit = isGrating & ~isReflG & ~isEntering & ~tir
  newMedium = torch.where((isLens & isEntering) | gratTransEnter, elemIdx,
                          torch.where(lensExitToVacuum | gratTransExit,
                                      torch.full_like(medium, VACUUM_MEDIUM),
                                      medium))
  newPower = torch.where(isMirror, power * reflectivity,
                         torch.where(isAbsorber, torch.zeros_like(power),
                                     power))
  newPower = torch.where(isGrating & isEntering & evanescent,
                         torch.zeros_like(power), newPower)
  seqInc = (isMirror | isAbsorber | (optType == VACUUM)
            | lensExitToVacuum | (isGrating & isReflG & isEntering)
            | gratTransExit).to(seq.dtype)

  hit = hasHit & alive
  records = dict(
      hitElem=torch.where(hit, elemIdx, torch.full_like(elemIdx, -1)),
      hitSurface=torch.where(hit, idx, torch.full_like(idx, -1)),
      px=px, py=py, pz=pz, plx=plx, ply=ply,
      dirX=dx, dirY=dy, dirZ=dz,
      power=power,
      isEntering=isEntering,
      isHit=hit,
      recordHit=hit & recordHits,
      segValid=alive,
      segPower=powerBefore,
      segMedium=medium,
      oX=ox, oY=oy, oZ=oz,
  )

  powerTol = scene.get('powerTol', 1e-6)
  newAlive = alive & hasHit & (newPower >= powerTol)
  newState = (torch.stack([px, py, pz], -1),
              torch.where(hasHit[:, None],
                          torch.stack([ndx, ndy, ndz], -1), d),
              torch.where(hasHit, newPower, power),
              wl,
              torch.where(hasHit, newMedium, medium),
              seq + torch.where(hasHit, seqInc, torch.zeros_like(seqInc)),
              newAlive)
  return newState, records


def _gratingDirections(isReflG, isEntering, nMedium, nElem, nx, ny, nz,
                       dx, dy, dz, gDirX, gDirY, gDirZ, wl, gratLpm, gratOrder,
                       snx, sny, snz):
  '''The outgoing directions of a grating hit (Ludwig 1970 on entry, the
  exit of a reflection grating a pass-through, of a transmission grating
  Snell's `sn`) and the evanescent flags.'''
  one = torch.ones_like(dx)
  gn1 = torch.where(isReflG, nMedium, one)
  gn2 = torch.where(isReflG, nMedium, nElem)
  gmu = gn1 / gn2
  nix, niy, niz = -nx, -ny, -nz
  pgx, pgy, pgz = _norm3(*_cross3(gDirX, gDirY, gDirZ, nix, niy, niz))
  dgx, dgy, dgz = _norm3(*_cross3(nix, niy, niz, pgx, pgy, pgz))
  lamUm = wl / 1000.
  spacing = 1000. / gratLpm
  Tt = gratOrder * lamUm / (gn1 * spacing)
  V = gmu * _dot3(dx, dy, dz, nix, niy, niz)
  W = (gmu * gmu - 1 + Tt * Tt
       - 2 * gmu * Tt * _dot3(dx, dy, dz, dgx, dgy, dgz))
  disc = V * V - W
  evanescent = disc < 0
  gsq = S.sqrtPositive(disc)
  qg = torch.where(isReflG, -V + gsq, -V - gsq)
  ggx, ggy, ggz = _norm3(gmu * dx - Tt * dgx + qg * nix,
                         gmu * dy - Tt * dgy + qg * niy,
                         gmu * dz - Tt * dgz + qg * niz)
  gratX = torch.where(isReflG, torch.where(isEntering, ggx, dx),
                      torch.where(isEntering, ggx, snx))
  gratY = torch.where(isReflG, torch.where(isEntering, ggy, dy),
                      torch.where(isEntering, ggy, sny))
  gratZ = torch.where(isReflG, torch.where(isEntering, ggz, dz),
                      torch.where(isEntering, ggz, snz))
  return gratX, gratY, gratZ, evanescent


def _scatter(sc, generator, elemIdx, isMirror, isLens, isEntering, hasHit,
             dDotN, nx, ny, nz, dx, dy, dz, ndx, ndy, ndz):
  '''The scatter lobe and the MODIFY rotation of the outgoing directions
  (the reference's scatter block of bounceBatch).'''
  N = dx.shape[0]
  if 'phiDiscVals' in sc:
    u = torch.rand((8, N), generator=generator, device=dx.device)
    uS, uM = (u[0], u[1], u[2], u[3]), (u[4], u[5], u[6], u[7])
  else:
    u = torch.rand((4, N), generator=generator, device=dx.device)
    uS, uM = (u[0], u[1], u[0], u[1]), (u[2], u[3], u[2], u[3])
  Tin = sc['phiInv'].shape[2]
  thetaIn = torch.arccos(torch.clamp(dDotN, -1., 1.))
  tinIdx = torch.clamp(torch.round(thetaIn / (np.pi / 2) * (Tin - 1))
                       .to(torch.int64), 0, Tin - 1)
  # scatter kind slots (models/scatter.py)
  REFLECT, REFRACT_ENTER, REFRACT_EXIT, MODIFY = 0, 1, 2, 3
  kind = torch.where(isMirror, torch.full_like(elemIdx, REFLECT),
                     torch.where(isEntering,
                                 torch.full_like(elemIdx, REFRACT_ENTER),
                                 torch.full_like(elemIdx, REFRACT_EXIT)))
  applies = (isMirror | isLens) & sc['flags'][elemIdx, kind] & hasHit
  thetaS, phiS = _scatterDraw(sc, elemIdx, kind, tinIdx, *uS)
  # lobe axis: incidence-side normal for mirrors, forward normal for lenses
  one = torch.ones_like(nx)
  nSgn = torch.where(isMirror, -one, one)
  lnx, lny, lnz = nx * nSgn, ny * nSgn, nz * nSgn
  zero = torch.zeros_like(nx)
  axX, axY, axZ = _cross3(lnx, lny, lnz, dx, dy, dz)
  axLen2 = axX * axX + axY * axY + axZ * axZ
  altX, altY, altZ = _cross3(lnx, lny, lnz, one, zero, zero)
  alt2X, alt2Y, alt2Z = _cross3(lnx, lny, lnz, zero, one, zero)
  altLen2 = altX * altX + altY * altY + altZ * altZ
  useAlt = axLen2 < 1e-12
  altOk = altLen2 > 1e-12
  axX = torch.where(useAlt, torch.where(altOk, altX, alt2X), axX)
  axY = torch.where(useAlt, torch.where(altOk, altY, alt2Y), axY)
  axZ = torch.where(useAlt, torch.where(altOk, altZ, alt2Z), axZ)
  axX, axY, axZ = _norm3(axX, axY, axZ)
  # out = Rot(n, phi) Rot(n x dIn, theta) n
  sx1, sy1, sz1 = _rot3(lnx, lny, lnz, axX, axY, axZ, thetaS)
  sx1, sy1, sz1 = _rot3(sx1, sy1, sz1, lnx, lny, lnz, phiS)
  ndx = torch.where(applies, sx1, ndx)
  ndy = torch.where(applies, sy1, ndy)
  ndz = torch.where(applies, sz1, ndz)

  # modify step: rotate the outgoing direction itself
  appliesM = (isMirror | isLens) & sc['flags'][elemIdx, MODIFY] & hasHit
  thetaM, phiM = _scatterDraw(sc, elemIdx, torch.full_like(kind, MODIFY),
                              tinIdx, *uM)
  mAxX, mAxY, mAxZ = _cross3(ndx, ndy, ndz, dx, dy, dz)
  mLen2 = mAxX * mAxX + mAxY * mAxY + mAxZ * mAxZ
  small = mLen2 < 1e-12
  mAxX = torch.where(small, axX, mAxX)
  mAxY = torch.where(small, axY, mAxY)
  mAxZ = torch.where(small, axZ, mAxZ)
  mAxX, mAxY, mAxZ = _norm3(mAxX, mAxY, mAxZ)
  mx2, my2, mz2 = _rot3(ndx, ndy, ndz, mAxX, mAxY, mAxZ, thetaM)
  mx2, my2, mz2 = _rot3(mx2, my2, mz2, ndx, ndy, ndz, phiM)
  ndx = torch.where(appliesM, mx2, ndx)
  ndy = torch.where(appliesM, my2, ndy)
  ndz = torch.where(appliesM, mz2, ndz)
  return _norm3(ndx, ndy, ndz)
