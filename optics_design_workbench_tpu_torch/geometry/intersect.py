'''
Nearest-intersection search over the compiled surface table (counterpart of
the JAX package's geometry/intersect.py; reference: freecad_elements/
ray.py:290-401): every surface is tested against every ray, rays are moved
into each surface's local frame, and the winner is chosen with the
reference's tie rule: among the hits within 2*distTol of the closest one,
prefer the closest whose element is not the medium the ray travels in;
otherwise the closest overall, the lowest surface index on equal distances.

The JAX package writes these for ONE ray and vmaps them. Here each takes
either one ray ((3,) tensors, the JAX package's call) or a ray batch ((N, 3)
tensors, surface-major (S, N) results); the batch form is the record
tracer's sweep (tracing/batch_tracer) seen from the (N, 3) side, and one ray
is a batch of one.
'''

import torch

from . import surfaces as S


def allDistances(table, o, d, tMin, seqAllowed=None):
  '''Distances from world rays `o`, `d` to every surface of `table` (its
  `byKind` split, `surfaces.byKind`, under the key 'byKind'); +inf where
  there is no valid hit. One ray ((3,) tensors) gives (S,), a batch ((N, 3))
  gives (S, N). `seqAllowed` (bool, (S,) or (S, N)) masks surfaces not
  allowed at a ray's sequential-mode stage.'''
  from ..tracing.batch_tracer import allDistancesBatch
  if o.dim() == 1:
    return allDistances(table, o[None], d[None], tMin, seqAllowed)[:, 0]
  return allDistancesBatch(table, *o.unbind(-1), *d.unbind(-1), tMin,
                           seqAllowed if seqAllowed is None
                           or seqAllowed.dim() == 2
                           else seqAllowed[:, None])


def selectNearest(t, elem, medium, distTol, maxRayLength):
  '''The reference's tie rule (ray.py:388-401): clip to maxRayLength;
  among the hits within [tMin, tMin + 2*distTol] prefer the closest whose
  element is not the ray's medium, else the closest overall; the lowest
  surface index wins on equal distances. `t` is one ray's (S,) distances
  (`medium` 0-d: 0-d results) or an (S, N) matrix ((N,) results). Returns
  (hitIndex, tHit, hasHit).'''
  from ..tracing.batch_tracer import selectNearestBatch
  if t.dim() == 1:
    return tuple(x[0] for x in selectNearestBatch(
        t[:, None], elem, medium.reshape(1), distTol, maxRayLength))
  return selectNearestBatch(t, elem, medium, distTol, maxRayLength)


def hitNormal(table, idx, pWorld, dWorld):
  '''Outward-of-solid normal at the hit points `pWorld` of surfaces `idx`,
  then turned "forward" (non-negative dot with the travel direction
  `dWorld`), as the reference's getNormal (ray.py:403-428). `table` holds
  tensors `w2lRot` (S, 3, 3), `w2lOff` (S, 3), `kind`, `params`, `orient`.
  Returns ((N, 3) forward normals, (N,) isEntering), or ((3,), 0-d) for one
  ray (0-d `idx`, (3,) points and directions).'''
  if pWorld.dim() == 1:
    n, entering = hitNormal(table, idx.reshape(1), pWorld[None], dWorld[None])
    return n[0], entering[0]
  rot, off = table['w2lRot'][idx], table['w2lOff'][idx]
  pl = torch.einsum('nij,nj->ni', rot, pWorld) + off
  nl = torch.stack(S.normalLocal(table['kind'][idx], table['params'][idx],
                                 *pl.unbind(-1)), -1)
  outward = torch.einsum('nji,nj->ni', rot, nl) * table['orient'][idx, None]
  isEntering = (dWorld * outward).sum(-1) < 0
  forward = torch.where(isEntering[:, None], -outward, outward)
  return forward, isEntering
