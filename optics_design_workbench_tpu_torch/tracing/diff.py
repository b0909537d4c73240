'''
Differentiable scene parameters: gradient-based optical design on torch
autograd (counterpart of the JAX package's tracing/diff.py).

The reference optimizes designs with derivative-free scipy searches over
FreeCAD document properties, re-running the whole simulation per probe
(reference: jupyter_utils/parameter_sweeper.py:700-918). The record tracer
(tracing/tracer.trace over batch_tracer.bounceBatch) is plain PyTorch, so
the merit function can be differentiated instead: `applyParams` rewrites a
prepared scene as a function of a parameter vector (every redundant table
view updated together), `torch.autograd.grad` backpropagates through the
whole multi-bounce trace (Snell refraction, mirror folds, grating
dispersion), and a first-order optimizer converges in tens of steps.

Parameter specs (each consumes one entry of the parameter vector p):
  ('translate',    surfIdx, axis)       world-space translation along the
                                        (normalized) axis by p
  ('rotate',       surfIdx, axis, pivot) rotation by p radians about the
                                        world axis through pivot
  ('surfaceParam', surfIdx, paramIdx)   additive offset on a surface
                                        parameter (radius, curvature,
                                        conic, quadric coeff, ...)
  ('refrIndex',    elemIdx)             additive offset on an element's
                                        refractive index
  ('translateGroup', elemIdx, axis)     rigid-body translation of EVERY
                                        surface of an element by one p
  ('rotateGroup', elemIdx, axis, pivot[, 'coRotateRuling'])
                                        rigid-body rotation of an element;
                                        the optional 5th entry also
                                        rotates a grating's ruling vector
                                        (the reference keeps
                                        GratingLinesOrientation
                                        world-fixed, ray.py:449)

Limitations (raised where detectable): transforms are rigid; 'refrIndex'
rejects elements with a dispersion table (it would mask the constant
index); trims are not trainable.
'''

import numpy as np
import torch

from .. import resolveDevice
from ..geometry import surfaces as GS
from .batch_tracer import prepareScene
from .element_table import EP_REFRINDEX, EP_GRATDIRX, GRATING


def _layout(surfaces):
  '''Host facts of a prepared scene's surface table, read once and kept on
  it: each kind's row span in the kind-sorted table (its `byKind` slice)
  and every row's element.'''
  cached = surfaces.get('_layout')
  if cached is None:
    kinds = surfaces['kind'].cpu().numpy()
    spans = {}
    for kind in sorted(set(kinds.tolist())):
      rows = np.nonzero(kinds == kind)[0]
      spans[GS._KIND_NAMES[kind]] = (int(rows[0]), int(rows[-1]) + 1)
    cached = surfaces['_layout'] = dict(
        spans=spans, elem=surfaces['elem'].cpu().numpy())
  return cached


def _unit(axis, like):
  a = np.asarray(axis, dtype=float)
  return torch.as_tensor(a / np.linalg.norm(a), dtype=like.dtype,
                         device=like.device)


def _setCols(row, start, values):
  '''`row` with `values` in place of its entries from `start` on, as a new
  tensor.'''
  return torch.cat([row[:start], values.reshape(-1).to(row.dtype),
                    row[start + values.numel():]])


def _rotationMatrix(a, angle):
  '''Rodrigues rotation matrix (3, 3) about the unit axis `a` (3,) by the
  0-d tensor `angle`, differentiable in `angle`.'''
  x, y, z = a
  c, s = torch.cos(angle), torch.sin(angle)
  C = 1. - c
  return torch.stack([
      torch.stack([c + x * x * C, x * y * C - z * s, x * z * C + y * s]),
      torch.stack([y * x * C + z * s, c + y * y * C, y * z * C - x * s]),
      torch.stack([z * x * C - y * s, z * y * C + x * s, c + z * z * C])])


def applyParams(scene, specs, p, device=None):
  '''Return a new prepared scene with the parameter vector `p` applied.
  `scene` is a prepared scene (`batch_tracer.prepareScene`) or a compiled
  host scene, which is prepared on `device`: by default the card `p` lies
  on, else 'cuda' (`resolveDevice`: it raises without a card; pass
  device='cpu' for the plain CPU run). `p` moves to the scene's device.
  The scene is not changed: every changed table is a new tensor built from
  the old one and `p`, so autograd sees every write.
  Every redundant view moves together: a surface's `w2lRot`, `w2lOff`,
  `params`, its `packed` row (the columns `bounceBatch` gathers at the hit)
  and its kind's `byKind` slice (the sweep), sliced from the new full
  tensors in torch; an element's `packed` row (index, ruling).

  The transforms are applied to the world-to-local form the prepared scene
  keeps: a translation by t along a moves w2lOff by -t (W a), a rotation
  R about an axis through q maps (W, o) to (W R^T, o + W (q - R^T q));
  that equals the JAX package's update of its local-to-world tables, and
  p = 0 leaves every table equal to the input.'''
  if not scene.get('_prepared'):
    if device is None and isinstance(p, torch.Tensor) and p.is_cuda:
      device = p.device
    scene = prepareScene(scene, resolveDevice(device or 'cuda'))
  surf = scene['surfaces']
  elements = scene['elements']
  layout = _layout(surf)
  w2lRot0, w2lOff0 = surf['w2lRot'], surf['w2lOff']
  p = torch.as_tensor(p, dtype=w2lRot0.dtype, device=w2lRot0.device)
  frames = {}            # row -> (W (3, 3), o (3,)) as changed so far
  paramRows = {}         # row -> (9,) parameters as changed so far
  elemRows = {}          # element -> packed row as changed so far

  def frame(i):
    return frames.get(i, (w2lRot0[i], w2lOff0[i]))

  def elemRow(e):
    return elemRows.get(e, elements['packed'][e])

  def translateOne(i, axis, t):
    W, o = frame(i)
    frames[i] = (W, o - t * (W @ _unit(axis, W)))

  def rotateOne(i, axis, pivot, angle):
    W, o = frame(i)
    R = _rotationMatrix(_unit(axis, W), angle)
    q = torch.as_tensor(np.asarray(pivot, dtype=float), dtype=W.dtype,
                        device=W.device)
    frames[i] = (W @ R.T, o + W @ (q - R.T @ q))

  for k, spec in enumerate(specs):
    kind = spec[0]
    if kind == 'translate':
      translateOne(spec[1], spec[2], p[k])
    elif kind == 'rotate':
      rotateOne(spec[1], spec[2], spec[3], p[k])
    elif kind in ('translateGroup', 'rotateGroup'):
      rows = np.nonzero(layout['elem'] == spec[1])[0]
      if not len(rows):
        raise ValueError(f'{kind} spec: no surfaces belong to element '
                         f'{spec[1]} (labels are kind-sorted table rows; '
                         f'check info["elementLabels"])')
      for i in rows.tolist():
        if kind == 'translateGroup':
          translateOne(i, spec[2], p[k])
        else:
          rotateOne(i, spec[2], spec[3], p[k])
      if kind == 'rotateGroup' and len(spec) > 4 and spec[4]:
        # opt-in ruling co-rotation: the reference treats
        # GratingLinesOrientation as a WORLD-FIXED property, so the default
        # matches recompiling with a rotated placement
        e = spec[1]
        if int(elements['_hostOptType'][e]) != GRATING:
          raise ValueError(f'coRotateRuling on non-grating element {e}')
        row = elemRow(e)
        R = _rotationMatrix(_unit(spec[2], row), p[k])
        elemRows[e] = _setCols(row, EP_GRATDIRX,
                               R @ row[EP_GRATDIRX:EP_GRATDIRX + 3])
    elif kind == 'surfaceParam':
      _, i, j = spec
      row = paramRows.get(i, surf['params'][i])
      paramRows[i] = _setCols(row, j, row[j] + p[k])
    elif kind == 'refrIndex':
      _, e = spec
      if 'nTable' in elements and bool(elements['hasDispersion'][e]):
        raise ValueError(f'refrIndex spec on element {e}: it has a '
                         f'dispersion table, which masks the constant '
                         f'index (batch_tracer nElem) — the parameter '
                         f'would silently have zero gradient')
      row = elemRow(e)
      elemRows[e] = _setCols(row, EP_REFRINDEX, row[EP_REFRINDEX] + p[k])
    else:
      raise ValueError(f'unknown parameter spec kind {kind!r}')

  def withRows(full, rows):
    if not rows:
      return full
    idx = sorted(rows)
    return full.index_put(
        (torch.as_tensor(idx, device=full.device),),
        torch.stack([rows[i] for i in idx]).to(full.dtype))

  newSurf = dict(surf)
  newSurf['w2lRot'] = withRows(w2lRot0, {i: f[0] for i, f in frames.items()})
  newSurf['w2lOff'] = withRows(w2lOff0, {i: f[1] for i, f in frames.items()})
  newSurf['params'] = withRows(surf['params'], paramRows)
  changed = set(frames) | set(paramRows)
  packedRows = {}
  for i in changed:
    row = _setCols(surf['packed'][i], GS.PACKED_ROT, newSurf['w2lRot'][i])
    row = _setCols(row, GS.PACKED_OFF, newSurf['w2lOff'][i])
    packedRows[i] = _setCols(row, GS.PACKED_PARAMS, newSurf['params'][i])
  newSurf['packed'] = withRows(surf['packed'], packedRows)
  newSurf['byKind'] = dict(surf['byKind'])
  for name, (a, b) in layout['spans'].items():
    if any(a <= i < b for i in changed):
      newSurf['byKind'][name] = dict(
          surf['byKind'][name], params=newSurf['params'][a:b],
          w2lRot=newSurf['w2lRot'][a:b], w2lOff=newSurf['w2lOff'][a:b])
  out = dict(scene, surfaces=newSurf)
  if elemRows:
    out['elements'] = dict(elements,
                           packed=withRows(elements['packed'], elemRows))
  return out


def makeSpotLoss(scene, specs, batch, detectorElem, maxIntersections,
                 maxRayLength=1e6, distTol=1e-4, powerTol=1e-6,
                 missRadius=100.):
  '''`lossGrad(p) -> (value, grad)`: the power-weighted RMS spot radius on
  `detectorElem` for a FIXED ray batch and its gradient in p, by
  `torch.autograd.grad` through `tracer.trace(..., recordSegments=False)`
  of `applyParams(scene, specs, p)`. `batch` holds `origins`, `directions`,
  `powers`, `wavelengths` tensors on the device the trace runs on; `scene`
  is a compiled scene or a prepared one.

  The gradient goes through the whole bounce loop: the nearest-hit choice is
  piecewise constant (held fixed at the selected branch, the usual
  convention of differentiable ray tracing), while hit positions, Snell
  directions and Beer-Lambert powers are smooth. Rays that MISS the
  detector count as `missRadius` at their launch power: without that,
  moving the detector out of the beam would zero the merit. The miss term's
  gradient is zero (the hit set is discrete), but the value keeps
  degenerate geometries from being reported best.'''
  from .tracer import trace
  origins = batch['origins']
  dev = origins.device
  sc0 = dict(prepareScene(scene, dev), powerTol=float(powerTol))
  _layout(sc0['surfaces'])            # the one host read, outside the loop
  directions, powers = batch['directions'], batch['powers']
  wavelengths = batch['wavelengths']

  def loss(p):
    sc = applyParams(sc0, specs, p)
    _state, rec = trace(sc, origins, directions, powers, wavelengths,
                        maxIntersections=maxIntersections,
                        maxRayLength=maxRayLength, distTol=distTol,
                        recordSegments=False)
    m = rec['recordHit'] & (rec['hitElem'] == detectorElem)
    zero = torch.zeros_like(rec['power'])
    w = torch.where(m, rec['power'], zero)
    wSum = torch.clamp(w.sum(), min=1e-12)
    pts = rec['point']
    centroid = (w[..., None] * pts).sum(dim=(0, 1)) / wSum
    # zero the non-hits BEFORE the square, so their (arbitrary) positions
    # cannot leak NaN into the gradient
    d = torch.where(m[..., None], pts - centroid, torch.zeros_like(pts))
    # rays that never reach the detector count as missRadius at launch power
    missW = torch.where(m.any(dim=0), torch.zeros_like(powers), powers)
    num = (w * (d * d).sum(-1)).sum() + (missW * missRadius ** 2).sum()
    den = wSum + missW.sum()
    return torch.sqrt(num / den + 1e-18)

  def lossGrad(p):
    p = torch.as_tensor(p, dtype=torch.float32, device=dev).detach() \
        .requires_grad_(True)
    value = loss(p)
    grad, = torch.autograd.grad(value, p)
    return value.detach(), grad

  return lossGrad


def optimizeGradient(lossGrad, p0, steps=100, learningRate=None,
                     optimizer=None, callback=None):
  '''Minimize `lossGrad` (`makeSpotLoss`'s) from `p0` with a torch
  optimizer: `optimizer(params) -> torch.optim.Optimizer`, by default
  Adam at `learningRate` (0.1). Returns (bestP, history): the parameters
  of the lowest value seen (a tensor) and [(step, value)]. One forward and
  backward trace a step; `callback(step, value, p)` after each.'''
  p0 = torch.as_tensor(p0, dtype=torch.float32)
  p = torch.nn.Parameter(p0.detach().clone())
  if optimizer is None:
    lr = 1e-1 if learningRate is None else learningRate
    opt = torch.optim.Adam([p], lr=lr)
  else:
    opt = optimizer([p])
  best, bestP = np.inf, p.detach().clone()
  history = []
  for step in range(int(steps)):
    value, grad = lossGrad(p.detach())
    value = float(value)
    history.append((step, value))
    if value < best:
      best, bestP = value, p.detach().clone()
    if callback is not None:
      callback(step, value, p.detach())
    opt.zero_grad()
    p.grad = grad.to(p.device)
    opt.step()
  return bestP, history
