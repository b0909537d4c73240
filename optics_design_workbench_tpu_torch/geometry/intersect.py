'''
Nearest-intersection search over the compiled surface table (counterpart of
the JAX package's geometry/intersect.py; reference: freecad_elements/
ray.py:290-401): every surface is tested against every ray, rays are moved
into each surface's local frame, and the winner is chosen with the
reference's tie rule: among the hits within 2*distTol of the closest one,
prefer the closest whose element is not the medium the ray travels in;
otherwise the closest overall, the lowest surface index on equal distances.

The JAX package writes these for ONE ray and vmaps them; here they take ray
batches directly ((N, 3) tensors) and return surface-major (S, N) results,
so they are the record tracer's sweep (tracing/batch_tracer) seen from the
(N, 3) side.
'''

import torch

from . import surfaces as S


def allDistances(table, o, d, tMin, seqAllowed=None):
  '''(S, N) distances from world rays `o`, `d` ((N, 3) tensors) to every
  surface of `table` (its `byKind` split, `surfaces.byKind`, under the key
  'byKind'); +inf where there is no valid hit. `seqAllowed` (bool, (S,) or
  (S, N)) masks surfaces not allowed at a ray's sequential-mode stage.'''
  from ..tracing.batch_tracer import allDistancesBatch
  return allDistancesBatch(table, *o.unbind(-1), *d.unbind(-1), tMin,
                           seqAllowed if seqAllowed is None
                           or seqAllowed.dim() == 2
                           else seqAllowed[:, None])


def selectNearest(t, elem, medium, distTol, maxRayLength):
  '''The reference's tie rule on an (S, N) distance matrix: returns
  (hitIndex, tHit, hasHit), each (N,).'''
  from ..tracing.batch_tracer import selectNearestBatch
  return selectNearestBatch(t, elem, medium, distTol, maxRayLength)


def hitNormal(table, idx, pWorld, dWorld):
  '''Outward-of-solid normal at the hit points `pWorld` of surfaces `idx`,
  then turned "forward" (non-negative dot with the travel direction
  `dWorld`), as the reference's getNormal (ray.py:403-428). `table` holds
  tensors `w2lRot` (S, 3, 3), `w2lOff` (S, 3), `kind`, `params`, `orient`.
  Returns ((N, 3) forward normals, (N,) isEntering).'''
  rot, off = table['w2lRot'][idx], table['w2lOff'][idx]
  pl = torch.einsum('nij,nj->ni', rot, pWorld) + off
  nl = torch.stack(S.normalLocal(table['kind'][idx], table['params'][idx],
                                 *pl.unbind(-1)), -1)
  outward = torch.einsum('nji,nj->ni', rot, nl) * table['orient'][idx, None]
  isEntering = (dWorld * outward).sum(-1) < 0
  forward = torch.where(isEntering[:, None], -outward, outward)
  return forward, isEntering
