'''
The record tracer (counterpart of the JAX package's tracing/tracer.py): a
loop over bounce depth whose body advances a whole batch of rays through one
intersection + interaction step (tracing/batch_tracer.bounceBatch), with
per-ray records of every hit and segment. Plain PyTorch on an explicit
device, as the reference's is plain XLA; it carries every feature the
kernels have and those they refuse (any surface count, sequential mode
with any table, the exact scatter gather path), and it is what ray fans,
ray polylines (`RecordRays`), drawing and host-sampled sources go through
where the kernels do not take them (simulation/runner.py).

Physics parity with the reference's per-ray generator `Ray.traceRay`
(reference: freecad_elements/ray.py:36-281):

  * nearest-intersection search with distance tolerance and same-medium
    tie-breaking (ray.py:290-401) — see geometry/intersect.py,
  * Mirror: specular reflection x Reflectivity (ray.py:146-161),
  * Lens: Snell refraction with entering/exiting medium tracking and total
    internal reflection (ray.py:165-211),
  * Grating: Ludwig-1970 diffraction, reflective or transmissive with
    order / lines-per-mm / line-orientation (ray.py:216-268, 445-487),
  * Absorber: power -> 0; Vacuum: pass-through detector (ray.py:271-277),
  * Beer-Lambert absorption along segments inside absorptive media
    (ray.py:120-125). As in the JAX package the power is MULTIPLIED by
    exp(-L/absLen) per segment, where the reference overwrites it.
  * maxIntersections / maxRayLength / powerTol termination (ray.py:46-53,
    96-98, 280), sequential-mode per-bounce element masks
    (simulation_settings.py:46-53; find.py:79-104).
'''

import torch

from ..geometry.surfaces import sqrtPositive
# the optical and grating types live in element_table; the tracer's names
# for them are the reference's (tracing/tracer.py)
from .element_table import (MIRROR, LENS, GRATING, ABSORBER, VACUUM,
                            OPTICAL_TYPES, GRATING_REFLECTION,
                            GRATING_TRANSMISSION, VACUUM_MEDIUM, EP_REFRINDEX)


def refractiveIndex(elements, elemIdx, wavelength):
  '''n(lambda) of elements `elemIdx` at `wavelength` (tensors of one
  shape): the constant RefractiveIndex, or the element's dispersion table
  interpolated linearly where it has one. `elements` is a prepared scene's
  (`batch_tracer.prepareScene`).'''
  base = elements['packed'][elemIdx, EP_REFRINDEX]
  if 'nTable' not in elements:
    return base
  from .batch_tracer import interpRows
  flat = elemIdx.reshape(-1)
  disp = interpRows(wavelength.reshape(-1), elements['nLambda'],
                    elements['nTable'][flat]).reshape(base.shape)
  return torch.where(elements['hasDispersion'][elemIdx], disp, base)


def _dot(a, b):
  return (a * b).sum(-1, keepdim=True)


def _normalize(v, eps=1e-20):
  return v / torch.sqrt((v * v).sum(-1, keepdim=True) + eps)


def mirrorDirection(d, n):
  '''Specular reflection of unit directions d at normals n ((..., 3);
  reference: ray.py:430-434).'''
  return d - 2 * n * _dot(d, n)


def snell(d, n, n1, n2):
  '''Snell's law with forward normals n (non-negative dot with d), indices
  n1, n2 of shape (...,); returns (outDirection, isTotalReflection)
  (reference: ray.py:436-443).'''
  mu = (n1 / n2)[..., None]
  cross = torch.cross(n, d, dim=-1)
  root = 1 - mu * mu * _dot(cross, cross)
  tir = root < 0
  tangential = torch.cross(n, torch.cross(-n, d, dim=-1), dim=-1)
  refracted = mu * tangential + n * sqrtPositive(root)
  return torch.where(tir, mirrorDirection(d, n), refracted), tir[..., 0]


def gratingDirection(d, n, n1, n2, wavelengthNm, order, linesPerMm,
                     linesOrientation, isReflection):
  '''Ludwig-1970 line-grating diffraction (reference: ray.py:445-487),
  evaluated with the incidence-side normal and without the reference's
  final negation, so that order 0 is exactly specular reflection / Snell
  refraction (see the JAX package's tracer.gratingDirection). Vectors are
  (..., 3), scalars (...,). Returns (direction, evanescent).'''
  lam = (wavelengthNm / 1000.)[..., None]
  nInc = -n
  gVec = _normalize(linesOrientation)
  P = _normalize(torch.cross(gVec, nInc, dim=-1))
  D = _normalize(torch.cross(nInc, P, dim=-1))
  mu = (n1 / n2)[..., None]
  spacing = (1000. / linesPerMm)[..., None]
  Tt = order[..., None] * lam / (n1[..., None] * spacing)
  V = mu * _dot(d, nInc)
  W = mu * mu - 1 + Tt * Tt - 2 * mu * Tt * _dot(d, D)
  disc = V * V - W
  evanescent = disc < 0
  sq = sqrtPositive(disc)
  q = torch.where(isReflection[..., None], -V + sq, -V - sq)
  out = mu * d - Tt * D + q * nInc
  return _normalize(out), evanescent[..., 0]


def bounceOne(scene, distTol, maxRayLength, o, d, power, wl, medium, seq,
              alive):
  '''One intersection + interaction step for a single ray: `o`, `d` (3,)
  tensors, `power`, `wl`, `medium` (int64), `seq` (int64), `alive` (bool)
  0-d tensors; `scene` prepared (`batch_tracer.prepareScene`). The per-ray
  form of the JAX package's `bounceOne` (which its caller vmaps; here a
  caller loops): `batch_tracer.bounceBatch` on a batch of one, without
  scatter, as there. Returns (newState, records), records of (3,) and 0-d
  tensors: hitElem, hitSurface, point, direction, power, isEntering, isHit,
  recordHit, segValid, segP1, segP2, segPower, segMedium.'''
  from .batch_tracer import bounceBatch
  state, rec = bounceBatch(scene, distTol, maxRayLength, o[None], d[None],
                           *(x.reshape(1) for x in (power, wl, medium, seq,
                                                    alive)))
  point = torch.stack([rec['px'], rec['py'], rec['pz']], -1)[0]
  records = dict(
      point=point,
      direction=torch.stack([rec['dirX'], rec['dirY'], rec['dirZ']], -1)[0],
      segP1=torch.stack([rec['oX'], rec['oY'], rec['oZ']], -1)[0],
      segP2=point)
  for k in ('hitElem', 'hitSurface', 'power', 'isEntering', 'isHit',
            'recordHit', 'segValid', 'segPower', 'segMedium'):
    records[k] = rec[k][0]
  return tuple(x[0] for x in state), records


# the record fields of one bounce and the value of a bounce that did not
# run (every ray already dead)
_EMPTY = dict(hitElem=-1, hitSurface=-1)


def trace(scene, origins, directions, powers, wavelengths, maxIntersections,
          maxRayLength, distTol, recordSegments=True, generator=None):
  '''Trace a batch of rays to completion. `scene`: a compiled scene (the
  host dict of `Scene.compile(device=None)`, or `batch_tracer.prepareScene`
  of one); the rays are (N, 3) / (N,) tensors whose device the trace runs
  on. Returns (finalState, records) with records a dict of
  (maxIntersections, N, ...) tensors, bounce-major: hitElem, hitSurface,
  point, direction (incoming), power (after Beer-Lambert, before the
  interaction), isEntering, isHit, recordHit and, with recordSegments,
  segValid, segP1, segP2, segPower, segMedium. A bounce runs only while
  some ray is alive; the records of the bounces after that are empty
  (hitElem -1). Scatter draws come from `generator` (a torch.Generator on
  the rays' device; seed 0 where the scene scatters and none is given).'''
  from .batch_tracer import bounceBatch, prepareScene
  dev = origins.device
  scene = prepareScene(scene, dev)
  if generator is None and 'scatter' in scene:
    generator = torch.Generator(device=dev)
    generator.manual_seed(0)
  N = origins.shape[0]
  f32 = lambda x: x.to(device=dev, dtype=torch.float32)
  state = (f32(origins), f32(directions), f32(powers), f32(wavelengths),
           torch.full((N,), VACUUM_MEDIUM, dtype=torch.int64, device=dev),
           torch.zeros((N,), dtype=torch.int64, device=dev),
           torch.ones((N,), dtype=torch.bool, device=dev))
  keys = ('hitElem', 'hitSurface', 'px', 'py', 'pz', 'dirX', 'dirY', 'dirZ',
          'power', 'isEntering', 'isHit', 'recordHit')
  if recordSegments:
    keys += ('segValid', 'segPower', 'segMedium', 'oX', 'oY', 'oZ')
  rec = {k: [] for k in keys}
  for _ in range(int(maxIntersections)):
    if bool(state[6].any()):
      state, last = bounceBatch(scene, distTol, maxRayLength, *state,
                                generator=generator)
      for k in keys:
        rec[k].append(last[k])
    else:
      for k in keys:
        rec[k].append(None)
  stacked = {}
  for k in keys:
    like = next((x for x in rec[k] if x is not None), None)
    if like is None:                 # no bounce ran (no rays)
      like = torch.zeros((N,), device=dev,
                         dtype=torch.int64 if k in _EMPTY or k == 'segMedium'
                         else torch.bool if k in ('isEntering', 'isHit',
                                                  'recordHit', 'segValid')
                         else torch.float32)
    empty = torch.full_like(like, _EMPTY.get(k, 0))
    stacked[k] = torch.stack([empty if x is None else x for x in rec[k]])
  records = dict(
      hitElem=stacked['hitElem'], hitSurface=stacked['hitSurface'],
      point=torch.stack([stacked['px'], stacked['py'], stacked['pz']], -1),
      direction=torch.stack([stacked['dirX'], stacked['dirY'],
                             stacked['dirZ']], -1),
      power=stacked['power'], isEntering=stacked['isEntering'],
      isHit=stacked['isHit'], recordHit=stacked['recordHit'])
  if recordSegments:
    records.update(
        segValid=stacked['segValid'],
        segP1=torch.stack([stacked['oX'], stacked['oY'], stacked['oZ']], -1),
        segP2=records['point'],
        segPower=stacked['segPower'], segMedium=stacked['segMedium'])
  return state, records


def totalSegments(records):
  '''Number of traced ray-segments (the benchmark unit), as a python int.'''
  key = 'segValid' if 'segValid' in records else 'isHit'
  return int(records[key].sum())
