'''
OpenCASCADE BRep ASCII parser + analytic face extraction.

The reference traces rays against exact trimmed OCC surfaces through
FreeCAD bindings (`line.Curve.intersect(cachedSurface(face))`, reference:
freecad_elements/ray.py:357-383; trim tests :375-382). FCStd project files
embed each solid's evaluated geometry as a `*.brp` blob in the standard
"CASCADE Topology V1" ASCII format — so the exact analytic surfaces
(plane / cylinder / cone / sphere / torus / surface-of-revolution / bspline)
with their face trims are available WITHOUT an OCC kernel. This module
parses the format and converts each face into the device surface encoding
of geometry/surfaces.py:

  * plane / sphere / cylinder / cone faces map 1:1 onto analytic kinds;
  * surfaces of revolution with a line / circle / parabola meridian map
    onto cone-or-cylinder-or-plane / sphere / ASPHERE(k=-1);
  * face trims are classified from the boundary wires: when the boundary
    region is separable in the surface's natural (angle, height) or (x, y)
    coordinates the closed-form trim windows are used (disc, annulus,
    rectangle, z-range, r-range); arbitrary boundaries (e.g. a boolean Cut
    slot through a paraboloid) become per-face UV occupancy bitmaps that
    the intersection kernels sample at the candidate hit point;
  * bezier / bspline / torus / offset faces fall back to a triangle
    tessellation evaluated from the exact surface record, masked by the
    same boundary rasterization in the surface's own OCC UV chart.

Boundary region orientation follows the OCC material-left convention via
signed-crossing rasterization of the wire loops (holes wind opposite and
cancel), so caps, periodic bands, seams and multi-wire faces all resolve
without special cases.

Host numpy only: the surface dicts it returns are the ones
`surfaces.buildSurfaceTable` packs, and nothing here touches a device.
'''

import math
import re

import numpy as np

from . import surfaces as S
from . import transforms as T
from ..utils import io

_TOL = 1e-7


# =============================================================== tokenization

class _Tokens:
  __slots__ = ('toks', 'i')

  def __init__(self, text):
    self.toks = text.split()
    self.i = 0

  def peek(self):
    return self.toks[self.i] if self.i < len(self.toks) else None

  def next(self):
    t = self.toks[self.i]
    self.i += 1
    return t

  def nextInt(self):
    return int(self.next())

  def nextFloat(self):
    return float(self.next())

  def floats(self, n):
    out = [float(self.toks[self.i + k]) for k in range(n)]
    self.i += n
    return out

  def done(self):
    return self.i >= len(self.toks)


def _sections(text):
  '''Split the file into named sections by their header lines.'''
  names = ('Locations', 'Curve2ds', 'Curves', 'Polygon3D',
           'PolygonOnTriangulations', 'Surfaces', 'Triangulations',
           'TShapes')
  out = {}
  spans = []
  for name in names:
    m = re.search(rf'^{name}\s+(-?\d+)\s*$', text, re.M)
    if m:
      spans.append((m.start(), m.end(), name, int(m.group(1))))
  spans.sort()
  for k, (s, e, name, count) in enumerate(spans):
    end = spans[k + 1][0] if k + 1 < len(spans) else len(text)
    out[name] = (count, text[e:end])
  return out


# ============================================================ geometry records

def _frame3(P, Z, X, Y):
  '''4x4 local->parent transform from an OCC Ax3 (origin + z/x/y axes).'''
  m = np.eye(4)
  m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = X, Y, Z, P
  return m


def _parseCurve(tk, dim):
  '''One curve record (3D when dim=3, pcurve when dim=2); recursive for
  trimmed/offset curves. Returns a dict with 'type' and parameters.'''
  t = tk.nextInt()
  v = lambda: np.array(tk.floats(dim))
  if t == 1:
    return dict(type='line', p=v(), d=v())
  if t == 2:
    if dim == 3:
      return dict(type='circle', p=v(), n=v(), x=v(), y=v(), r=tk.nextFloat())
    return dict(type='circle', p=v(), x=v(), y=v(), r=tk.nextFloat())
  if t == 3:
    if dim == 3:
      return dict(type='ellipse', p=v(), n=v(), x=v(), y=v(),
                  r1=tk.nextFloat(), r2=tk.nextFloat())
    return dict(type='ellipse', p=v(), x=v(), y=v(),
                r1=tk.nextFloat(), r2=tk.nextFloat())
  if t == 4:
    if dim == 3:
      return dict(type='parabola', p=v(), n=v(), x=v(), y=v(),
                  focal=tk.nextFloat())
    return dict(type='parabola', p=v(), x=v(), y=v(), focal=tk.nextFloat())
  if t == 5:
    if dim == 3:
      return dict(type='hyperbola', p=v(), n=v(), x=v(), y=v(),
                  r1=tk.nextFloat(), r2=tk.nextFloat())
    return dict(type='hyperbola', p=v(), x=v(), y=v(),
                r1=tk.nextFloat(), r2=tk.nextFloat())
  if t == 6:
    rational = tk.nextInt()
    degree = tk.nextInt()
    n = degree + 1
    poles = np.array(tk.floats(n * (dim + rational))).reshape(n, dim + rational)
    return dict(type='bezier', rational=rational, degree=degree, poles=poles)
  if t == 7:
    rational = tk.nextInt()
    periodic = tk.nextInt()
    degree = tk.nextInt()
    npoles = tk.nextInt()
    nknots = tk.nextInt()
    poles = np.array(tk.floats(npoles * (dim + rational))
                     ).reshape(npoles, dim + rational)
    km = np.array(tk.floats(2 * nknots)).reshape(nknots, 2)
    return dict(type='bspline', rational=rational, periodic=periodic,
                degree=degree, poles=poles, knots=km[:, 0],
                mults=km[:, 1].astype(int))
  if t == 8:
    f, l = tk.nextFloat(), tk.nextFloat()
    return dict(type='trimmed', first=f, last=l, basis=_parseCurve(tk, dim))
  if t == 9:
    if dim == 3:
      val = tk.nextFloat()
      d = np.array(tk.floats(3))
      return dict(type='offset', value=val, d=d, basis=_parseCurve(tk, dim))
    val = tk.nextFloat()
    return dict(type='offset', value=val, basis=_parseCurve(tk, dim))
  raise ValueError(f'unknown curve record type {t}')


def _parseSurface(tk):
  t = tk.nextInt()
  v3 = lambda: np.array(tk.floats(3))
  if t == 1:
    return dict(type='plane', frame=_frame3(v3(), v3(), v3(), v3()))
  if t == 2:
    return dict(type='cylinder', frame=_frame3(v3(), v3(), v3(), v3()),
                r=tk.nextFloat())
  if t == 3:
    return dict(type='cone', frame=_frame3(v3(), v3(), v3(), v3()),
                r=tk.nextFloat(), semiAngle=tk.nextFloat())
  if t == 4:
    return dict(type='sphere', frame=_frame3(v3(), v3(), v3(), v3()),
                r=tk.nextFloat())
  if t == 5:
    return dict(type='torus', frame=_frame3(v3(), v3(), v3(), v3()),
                r1=tk.nextFloat(), r2=tk.nextFloat())
  if t == 6:
    d = v3()
    return dict(type='extrusion', d=d, basis=_parseCurve(tk, 3))
  if t == 7:
    p = v3()
    d = v3()
    return dict(type='revolution', p=p, d=d, basis=_parseCurve(tk, 3))
  if t == 8:
    urat, vrat = tk.nextInt(), tk.nextInt()
    udeg, vdeg = tk.nextInt(), tk.nextInt()
    w = 3 + (1 if (urat or vrat) else 0)
    poles = np.array(tk.floats((udeg + 1) * (vdeg + 1) * w)
                     ).reshape(udeg + 1, vdeg + 1, w)
    return dict(type='bezier', urational=urat, vrational=vrat,
                udegree=udeg, vdegree=vdeg, poles=poles)
  if t == 9:
    urat, vrat = tk.nextInt(), tk.nextInt()
    uper, vper = tk.nextInt(), tk.nextInt()
    udeg, vdeg = tk.nextInt(), tk.nextInt()
    nup, nvp = tk.nextInt(), tk.nextInt()
    nuk, nvk = tk.nextInt(), tk.nextInt()
    w = 3 + (1 if (urat or vrat) else 0)
    poles = np.array(tk.floats(nup * nvp * w)).reshape(nup, nvp, w)
    ukm = np.array(tk.floats(2 * nuk)).reshape(nuk, 2)
    vkm = np.array(tk.floats(2 * nvk)).reshape(nvk, 2)
    return dict(type='bspline', urational=urat, vrational=vrat,
                uperiodic=uper, vperiodic=vper, udegree=udeg, vdegree=vdeg,
                poles=poles, uknots=ukm[:, 0], umults=ukm[:, 1].astype(int),
                vknots=vkm[:, 0], vmults=vkm[:, 1].astype(int))
  if t == 10:
    u1, u2 = tk.nextFloat(), tk.nextFloat()
    v1, v2 = tk.nextFloat(), tk.nextFloat()
    return dict(type='rtrimmed', u1=u1, u2=u2, v1=v1, v2=v2,
                basis=_parseSurface(tk))
  if t == 11:
    return dict(type='offsetsurf', value=tk.nextFloat(),
                basis=_parseSurface(tk))
  raise ValueError(f'unknown surface record type {t}')


# ============================================================ curve evaluation

def _flatKnotsAndPoles(knots, mults, poles, deg, periodic):
  '''OCC bspline (knots+mults, possibly periodic) -> scipy-compatible flat
  knot vector and unrolled control points. For periodic splines the knot
  sequence is extended by one period on each side and the control net is
  wrapped so len(t) == len(c) + deg + 1.'''
  seq = np.repeat(knots, mults)
  if not periodic:
    return seq, poles
  T = knots[-1] - knots[0]
  m1 = int(mults[0])
  a = deg + 1 - m1      # extra knots needed on the left
  left = (seq[:-m1][-a:] - T) if a > 0 else seq[:0]
  right = seq[m1:][:deg + 1] + T   # deg+1 so the right edge keeps full
                                   # basis support (partition of unity at um)
  t = np.concatenate([left, seq, right])
  nC = len(t) - deg - 1
  n = len(poles)
  if nC != n + deg + 1:
    raise ValueError('inconsistent periodic bspline record')
  polesU = np.concatenate([poles[n - deg:], poles, poles[:1]], axis=0)
  return t, polesU


def _bsplineEval(rec, t, dim):
  '''Evaluate a (possibly rational, possibly periodic) bspline curve record
  at parameters t via scipy BSpline on the flattened knot vector.'''
  from scipy.interpolate import BSpline
  deg = rec['degree']
  knots, poles = _flatKnotsAndPoles(rec['knots'], rec['mults'],
                                    rec['poles'], deg, rec['periodic'])
  if rec['rational']:
    w = poles[:, dim]
    hom = poles[:, :dim] * w[:, None]
    num = np.stack([BSpline(knots, hom[:, k], deg, extrapolate=True)(t)
                    for k in range(dim)], axis=-1)
    den = BSpline(knots, w, deg, extrapolate=True)(t)
    den = np.where(np.abs(den) < 1e-30, 1e-30, den)
    return num / den[..., None]
  return np.stack([BSpline(knots, poles[:, k], deg, extrapolate=True)(t)
                   for k in range(dim)], axis=-1)


def _bezierEval(rec, t, dim):
  deg = rec['degree']
  poles = rec['poles']
  from math import comb
  t = np.asarray(t)[..., None]
  basis = np.stack([comb(deg, i) * t[..., 0] ** i * (1 - t[..., 0]) ** (deg - i)
                    for i in range(deg + 1)], axis=-1)
  if rec['rational']:
    w = poles[:, dim]
    num = basis @ (poles[:, :dim] * w[:, None])
    den = basis @ w
    return num / den[..., None]
  return basis @ poles[:, :dim]


def evalCurve(rec, t, dim=3):
  '''Evaluate a parsed curve record at parameter array t -> (N, dim).'''
  t = np.asarray(t, dtype=float)
  kind = rec['type']
  if kind == 'line':
    return rec['p'] + t[..., None] * rec['d']
  if kind == 'circle':
    return (rec['p'] + rec['r'] * np.cos(t)[..., None] * rec['x']
            + rec['r'] * np.sin(t)[..., None] * rec['y'])
  if kind == 'ellipse':
    return (rec['p'] + rec['r1'] * np.cos(t)[..., None] * rec['x']
            + rec['r2'] * np.sin(t)[..., None] * rec['y'])
  if kind == 'parabola':
    # C(t) = P + t^2/(4 focal) X + t Y  (OCC gp_Parab parametrization)
    return (rec['p'] + (t ** 2 / (4 * rec['focal']))[..., None] * rec['x']
            + t[..., None] * rec['y'])
  if kind == 'hyperbola':
    return (rec['p'] + (rec['r1'] * np.cosh(t))[..., None] * rec['x']
            + (rec['r2'] * np.sinh(t))[..., None] * rec['y'])
  if kind == 'bezier':
    return _bezierEval(rec, t, dim)
  if kind == 'bspline':
    return _bsplineEval(rec, t, dim)
  if kind == 'trimmed':
    return evalCurve(rec['basis'], t, dim)
  if kind == 'offset':
    if dim == 3:
      eps = 1e-5
      p = evalCurve(rec['basis'], t, dim)
      tangent = (evalCurve(rec['basis'], t + eps, dim) - p) / eps
      n = np.cross(rec['d'], tangent)
      n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-30)
      return p + rec['value'] * np.cross(n, rec['d'] / np.linalg.norm(rec['d']))
    raise ValueError('2d offset curves are not supported')
  raise ValueError(f'cannot evaluate curve type {kind}')


# ========================================================== surface evaluation

def _surfBsplineEval(rec, u, v):
  from scipy.interpolate import BSpline
  poles = rec['poles']
  uk, polesU = _flatKnotsAndPoles(rec['uknots'], rec['umults'],
                                  poles, rec['udegree'], rec['uperiodic'])
  poles = polesU
  vk, polesV = _flatKnotsAndPoles(rec['vknots'], rec['vmults'],
                                  np.swapaxes(poles, 0, 1), rec['vdegree'],
                                  rec['vperiodic'])
  poles = np.swapaxes(polesV, 0, 1)
  rational = rec['urational'] or rec['vrational']
  w = poles[:, :, 3] if rational else np.ones(poles.shape[:2])
  hom = poles[:, :, :3] * w[..., None]

  def ev(grid):   # grid (nu, nv, c)
    c = grid.shape[-1]
    tmp = np.stack([
        np.stack([BSpline(vk, grid[i, :, k], rec['vdegree'],
                          extrapolate=True)(v) for k in range(c)], axis=-1)
        for i in range(grid.shape[0])])          # (nu, len(v), c)
    out = np.stack([
        np.stack([BSpline(uk, tmp[:, j, k], rec['udegree'],
                          extrapolate=True)(u) for k in range(c)], axis=-1)
        for j in range(tmp.shape[1])])           # (len(v), len(u), c)
    return out
  num = ev(hom)
  den = ev(w[..., None])[..., 0]
  return num / den[..., None]    # (len(v), len(u), 3)


def evalSurface(rec, u, v):
  '''Evaluate a parsed surface record on the OCC UV grid (u (NU,), v (NV,))
  -> points (NV, NU, 3) in the record's own frame-parent coordinates.'''
  u = np.asarray(u, dtype=float)
  v = np.asarray(v, dtype=float)
  kind = rec['type']
  if kind in ('plane', 'cylinder', 'cone', 'sphere', 'torus'):
    F = rec['frame']
    X, Y, Z, P = F[:3, 0], F[:3, 1], F[:3, 2], F[:3, 3]
    uu, vv = np.meshgrid(u, v)
    cu, su = np.cos(uu)[..., None], np.sin(uu)[..., None]
    if kind == 'plane':
      return P + uu[..., None] * X + vv[..., None] * Y
    if kind == 'cylinder':
      return P + rec['r'] * (cu * X + su * Y) + vv[..., None] * Z
    if kind == 'cone':
      sa, ca = math.sin(rec['semiAngle']), math.cos(rec['semiAngle'])
      rad = (rec['r'] + vv * sa)[..., None]
      return P + rad * (cu * X + su * Y) + (vv * ca)[..., None] * Z
    if kind == 'sphere':
      cv, sv = np.cos(vv)[..., None], np.sin(vv)[..., None]
      return P + rec['r'] * (cv * (cu * X + su * Y) + sv * Z)
    if kind == 'torus':
      cv, sv = np.cos(vv)[..., None], np.sin(vv)[..., None]
      rad = rec['r1'] + rec['r2'] * cv
      return P + rad * (cu * X + su * Y) + rec['r2'] * sv * Z
  if kind == 'revolution':
    # P(u, v) = rotate(C(v) around axis by u)
    pts = evalCurve(rec['basis'], v)              # (NV, 3)
    axis = rec['d'] / np.linalg.norm(rec['d'])
    rel = pts - rec['p']
    along = rel @ axis
    radial = rel - along[:, None] * axis
    rlen = np.linalg.norm(radial, axis=-1)
    e1 = np.where(rlen[:, None] > 1e-12, radial / np.maximum(
        rlen[:, None], 1e-30), 0.)
    e2 = np.cross(axis, e1)
    cu, su = np.cos(u), np.sin(u)
    out = (rec['p'] + along[None, :, None] * axis
           + rlen[None, :, None] * (cu[:, None, None] * e1[None]
                                    + su[:, None, None] * e2[None]))
    return np.swapaxes(out, 0, 1)                # (NV, NU, 3)? -> see below
  if kind == 'extrusion':
    pts = evalCurve(rec['basis'], u)              # (NU, 3)
    return pts[None, :, :] + v[:, None, None] * rec['d']
  if kind == 'bezier':
    # represent as bspline with clamped knots
    br = dict(type='bspline', urational=rec['urational'],
              vrational=rec['vrational'], uperiodic=0, vperiodic=0,
              udegree=rec['udegree'], vdegree=rec['vdegree'],
              poles=rec['poles'] if rec['poles'].shape[-1] == 4 else
              rec['poles'],
              uknots=np.array([0., 1.]), umults=np.array(
                  [rec['udegree'] + 1] * 2),
              vknots=np.array([0., 1.]), vmults=np.array(
                  [rec['vdegree'] + 1] * 2))
    if rec['poles'].shape[-1] == 3 and (rec['urational'] or rec['vrational']):
      pass
    if rec['poles'].shape[-1] == 3:
      br['urational'] = br['vrational'] = 0
    return _surfBsplineEval(br, u, v)
  if kind == 'bspline':
    return _surfBsplineEval(rec, u, v)
  if kind == 'rtrimmed':
    return evalSurface(rec['basis'], u, v)
  if kind == 'offsetsurf':
    eps = 1e-5
    p = evalSurface(rec['basis'], u, v)
    pu = evalSurface(rec['basis'], u + eps, v)
    pv = evalSurface(rec['basis'], u, v + eps)
    n = np.cross((pu - p) / eps, (pv - p) / eps)
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-30)
    return p + rec['value'] * n
  raise ValueError(f'cannot evaluate surface type {kind}')


# =================================================================== topology

class _TShape:
  __slots__ = ('shapeType', 'data', 'flags', 'refs')

  def __init__(self, shapeType, data, flags, refs):
    self.shapeType = shapeType
    self.data = data
    self.flags = flags
    self.refs = refs          # [(sign, tshapeIdx(1-based-from-END), locIdx)]


class BRep:
  def __init__(self):
    self.locations = [np.eye(4)]
    self.curves2d = []
    self.curves = []
    self.surfaces = []
    self.tshapes = []         # file order
    self.roots = []           # [(sign, idx, loc)]

  def tshape(self, idx):
    '''Resolve a 1-based-from-end reference.'''
    return self.tshapes[len(self.tshapes) - idx]


_FLAGS_RE = re.compile(r'^[01]{7}$')
_SHAPE_TYPES = {'Ve', 'Ed', 'Wi', 'Fa', 'Sh', 'So', 'CS', 'Co'}


def parseBRep(text):
  '''Parse a "CASCADE Topology V1" ASCII blob.'''
  if 'CASCADE Topology V1' not in text[:200]:
    raise ValueError('not a CASCADE Topology V1 BRep blob')
  secs = _sections(text)
  brep = BRep()

  if 'Locations' in secs:
    count, body = secs['Locations']
    tk = _Tokens(body)
    for _ in range(count):
      t = tk.nextInt()
      if t == 1:
        rows = np.array(tk.floats(12)).reshape(3, 4)
        m = np.eye(4)
        m[:3, :] = rows
        brep.locations.append(m)
      elif t == 2:
        m = np.eye(4)
        while True:
          idx = tk.nextInt()
          if idx == 0:
            break
          power = tk.nextInt()
          base = brep.locations[idx]
          step = np.linalg.matrix_power(base, power) if power != 1 else base
          m = m @ step
        brep.locations.append(m)
      else:
        raise ValueError(f'unknown location record type {t}')

  for name, dim, dest in (('Curve2ds', 2, brep.curves2d),
                          ('Curves', 3, brep.curves)):
    if name in secs:
      count, body = secs[name]
      tk = _Tokens(body)
      for _ in range(count):
        dest.append(_parseCurve(tk, dim))

  if 'Surfaces' in secs:
    count, body = secs['Surfaces']
    tk = _Tokens(body)
    for _ in range(count):
      brep.surfaces.append(_parseSurface(tk))

  if 'TShapes' not in secs:
    return brep
  count, body = secs['TShapes']
  tk = _Tokens(body)
  for _ in range(count):
    st = tk.next()
    if st not in _SHAPE_TYPES:
      raise ValueError(f'unexpected shape type token {st!r}')
    data = {}
    if st == 'Ve':
      data['tol'] = tk.nextFloat()
      data['point'] = np.array(tk.floats(3))
      # vertex representations: consume until the 7-bit flags token
      extra = []
      while not _FLAGS_RE.match(tk.peek() or ''):
        extra.append(tk.next())
      data['reps'] = extra
    elif st == 'Ed':
      data['tol'] = tk.nextFloat()
      data['sameParameter'] = tk.nextInt()
      data['sameRange'] = tk.nextInt()
      data['degenerated'] = tk.nextInt()
      reps = []
      while True:
        rt = tk.nextInt()
        if rt == 0:
          break
        if rt == 1:
          reps.append(dict(rep='curve3d', curve=tk.nextInt(),
                           loc=tk.nextInt(), first=tk.nextFloat(),
                           last=tk.nextFloat()))
        elif rt == 2:
          reps.append(dict(rep='pcurve', curve2d=tk.nextInt(),
                           surf=tk.nextInt(), loc=tk.nextInt(),
                           first=tk.nextFloat(), last=tk.nextFloat()))
        elif rt == 3:
          c1 = tk.nextInt()
          c2tok = tk.next()
          m = re.match(r'^(\d+)([A-Za-z0-9]*)$', c2tok)
          c2 = int(m.group(1))
          reps.append(dict(rep='pcurve2', curve2d=c1, curve2d2=c2,
                           continuity=m.group(2), surf=tk.nextInt(),
                           loc=tk.nextInt(), first=tk.nextFloat(),
                           last=tk.nextFloat()))
        elif rt == 4:
          reps.append(dict(rep='regularity', continuity=tk.next(),
                           surf1=tk.nextInt(), loc1=tk.nextInt(),
                           surf2=tk.nextInt(), loc2=tk.nextInt()))
        elif rt in (5, 6, 7):
          # polygon representations: skip their payloads
          n = {5: 2, 6: 3, 7: 4}[rt]
          for _k in range(n):
            tk.next()
          reps.append(dict(rep=f'polygon{rt}'))
        else:
          raise ValueError(f'unknown edge representation {rt}')
      data['reps'] = reps
      # pcurve range markers may follow ("curve on surface" UV values);
      # consume anything that is not the flags token
      while not _FLAGS_RE.match(tk.peek() or ''):
        tk.next()
    elif st == 'Fa':
      data['naturalRestriction'] = tk.nextInt()
      data['tol'] = tk.nextFloat()
      data['surf'] = tk.nextInt()
      data['loc'] = tk.nextInt()
      while not _FLAGS_RE.match(tk.peek() or ''):
        tk.next()
    # Wi / Sh / So / CS / Co carry no payload
    while not _FLAGS_RE.match(tk.peek() or ''):
      tk.next()
    flags = tk.next()
    refs = []
    while True:
      tok = tk.next()
      if tok == '*':
        break
      sign = +1
      if tok[0] in '+-ie':
        sign = -1 if tok[0] == '-' else +1
        idx = int(tok[1:])
      else:
        idx = int(tok)
      loc = tk.nextInt()
      refs.append((sign, idx, loc))
    brep.tshapes.append(_TShape(st, data, flags, refs))
  # trailing root references
  while not tk.done():
    tok = tk.next()
    if not tok or tok == '*':
      continue
    sign = -1 if tok[0] == '-' else +1
    idx = int(tok.lstrip('+-ie'))
    loc = tk.nextInt() if not tk.done() else 0
    brep.roots.append((sign, idx, loc))
  return brep


def iterFaces(brep):
  '''Yield (faceTShape, accumulatedLocation4x4, orientationSign) for every
  face reachable from the roots, composing reference locations and
  orientation signs down the hierarchy (one face may be yielded several
  times when instanced via shared sub-shapes).'''
  out = []

  def walk(sign, idx, loc, acc):
    ts = brep.tshape(idx)
    acc2 = acc @ brep.locations[loc] if loc else acc
    if ts.shapeType == 'Fa':
      out.append((ts, acc2, sign))
      return
    if ts.shapeType in ('Ve', 'Ed', 'Wi'):
      return
    for s2, i2, l2 in ts.refs:
      walk(sign * s2, i2, l2, acc2)

  for sign, idx, loc in brep.roots:
    walk(sign, idx, loc, np.eye(4))
  return out


# ================================================= face boundary construction

def _edgeCurve3d(brep, edge):
  for rep in edge.data['reps']:
    if rep['rep'] == 'curve3d':
      return rep
  return None


def _edgePcurve(brep, edge, surfIdx):
  for rep in edge.data['reps']:
    if rep['rep'] in ('pcurve', 'pcurve2') and rep['surf'] == surfIdx:
      return rep
  return None


def _sampleEdge3d(brep, edge, nSamples=96):
  '''World-frame (= shape-frame) polyline of one edge from its 3D curve.'''
  rep = _edgeCurve3d(brep, edge)
  if rep is None:
    return None
  curve = brep.curves[rep['curve'] - 1]
  t = np.linspace(rep['first'], rep['last'], nSamples)
  pts = evalCurve(curve, t)
  loc = brep.locations[rep['loc']] if rep['loc'] else None
  if loc is not None:
    pts = pts @ loc[:3, :3].T + loc[:3, 3]
  return pts


def _chainSegs(segs):
  '''Reorder a wire's edge polylines head-to-tail. TopoDS wires store edges
  as an unordered set with per-edge orientation; each edge's DIRECTION
  (after its sign) is authoritative, only the order needs recovering.
  Degenerate entries (dicts) are appended at the end unchanged.'''
  arrs = [(i, seg) for i, (_sg, seg) in enumerate(segs)
          if isinstance(seg, np.ndarray)]
  degs = [(sg, seg) for sg, seg in segs if not isinstance(seg, np.ndarray)]
  if len(arrs) <= 1:
    return [( +1, seg) for _i, seg in arrs] + degs
  scale = max(1., max(float(np.abs(seg).max()) for _i, seg in arrs))
  tol = 1e-6 * scale
  used = {arrs[0][0]}
  chain = [arrs[0][1]]
  cur = arrs[0][1][-1]
  while len(used) < len(arrs):
    nxt = None
    for i, seg in arrs:
      if i in used:
        continue
      if np.linalg.norm(seg[0] - cur) < tol:
        nxt = (i, seg)
        break
    if nxt is None:
      # tolerate slight gaps: nearest-start edge wins (NaN-distance edges,
      # e.g. from a degenerate spline sample, fall through to first-unused)
      best, bestD = None, np.inf
      for i, seg in arrs:
        if i in used:
          continue
        dd = float(np.linalg.norm(seg[0] - cur))
        if dd < bestD:
          best, bestD = (i, seg), dd
      nxt = best if best is not None else next(
          (i, seg) for i, seg in arrs if i not in used)
    used.add(nxt[0])
    chain.append(nxt[1])
    cur = nxt[1][-1]
  return [(+1, seg) for seg in chain] + degs


def faceWireLoops(brep, faceTs, accLoc, nSamples=96):
  '''Ordered, oriented boundary loops of a face as world-frame polylines
  (one array (N, 3) per wire). Degenerate edges (pole edges of spheres)
  contribute their pcurve so the loop still closes in UV later: they are
  returned as dicts {degenerate pcurve info} inline in the loop list.'''
  loops = []
  for wSign, wIdx, wLoc in faceTs.refs:
    wire = brep.tshape(wIdx)
    if wire.shapeType != 'Wi':
      continue
    wireLoc = accLoc @ brep.locations[wLoc] if wLoc else accLoc
    segs = []
    for eSign, eIdx, eLoc in wire.refs:
      edge = brep.tshape(eIdx)
      if edge.shapeType != 'Ed':
        continue
      edgeLoc = wireLoc @ brep.locations[eLoc] if eLoc else wireLoc
      if edge.data['degenerated']:
        pc = _edgePcurve(brep, edge, faceTs.data['surf'])
        segs.append((eSign, dict(degenerate=True, pcurve=pc, edge=edge)))
        continue
      pts = _sampleEdge3d(brep, edge, nSamples)
      if pts is None:
        pc = _edgePcurve(brep, edge, faceTs.data['surf'])
        segs.append((eSign, dict(degenerate=True, pcurve=pc, edge=edge)))
        continue
      pts = pts @ edgeLoc[:3, :3].T + edgeLoc[:3, 3]
      if eSign < 0:
        pts = pts[::-1]
      segs.append((eSign, pts))
    if wSign < 0:
      segs = [(s, (p[::-1] if isinstance(p, np.ndarray) else p))
              for s, p in reversed(segs)]
    loops.append(_chainSegs(segs))
  return loops


# ============================================================ UV rasterization

def rasterizeLoops(uvLoops, uWindow, vWindow, res, uPeriod=None):
  '''Signed-crossing rasterization: mask[j, i] = (winding number != 0) for
  cell centers, where winding is accumulated from oriented boundary
  segments crossing the downward v-ray of each cell (OCC material-left
  convention; holes wind opposite and cancel; periodic bands and caps need
  no special cases). uvLoops: list of (N, 2) arrays. Returns (mask(res,res),
  u0, v0, du, dv).'''
  u0, u1 = uWindow
  v0, v1 = vWindow
  du = (u1 - u0) / res
  dv = (v1 - v0) / res
  us = u0 + (np.arange(res) + .5) * du     # cell centers
  winding = np.zeros((res, res), dtype=np.int32)
  shifts = (0.,) if uPeriod is None else (-uPeriod, 0., uPeriod, 2 * uPeriod,
                                          -2 * uPeriod)
  for loop in uvLoops:
    if len(loop) < 2:
      continue
    a = loop[:-1]
    b = loop[1:]
    for shift in shifts:
      ax, ay = a[:, 0] + shift, a[:, 1]
      bx, by = b[:, 0] + shift, b[:, 1]
      # segments crossing vertical line u = us[i]
      for i, u in enumerate(us):
        crosses = ((ax <= u) & (bx > u)) | ((bx <= u) & (ax > u))
        if not crosses.any():
          continue
        sel = np.nonzero(crosses)[0]
        tpar = (u - ax[sel]) / (bx[sel] - ax[sel])
        vCross = ay[sel] + tpar * (by[sel] - ay[sel])
        sign = np.where(bx[sel] > ax[sel], 1, -1)
        # accumulate +-1 for all cells with center v above the crossing
        jStart = np.ceil((vCross - v0) / dv - .5).astype(int)
        for js, sg in zip(jStart, sign):
          if js < 0:
            winding[:, i] += sg
          elif js < res:
            winding[js:, i] += sg
  return (winding != 0), u0, v0, du, dv


def _contiguousTrue(arr, periodic=False):
  '''Return (lo, hi) index bounds if arr has exactly one contiguous run of
  True (allowing wraparound when periodic), else None.'''
  idx = np.nonzero(arr)[0]
  if len(idx) == 0:
    return None
  runsBreak = np.nonzero(np.diff(idx) > 1)[0]
  if len(runsBreak) == 0:
    return int(idx[0]), int(idx[-1])
  if periodic and len(runsBreak) == 1 and idx[0] == 0 \
      and idx[-1] == len(arr) - 1:
    # single run wrapping the seam
    return int(idx[runsBreak[0] + 1]), int(idx[runsBreak[0]]) + len(arr)
  return None


def _separable(mask):
  uIn = mask.any(axis=0)
  vIn = mask.any(axis=1)
  return bool((mask == np.outer(vIn, uIn)).all()), uIn, vIn


# ================================================== analytic face classification

def _decomposeRigidScale(m):
  '''Split a 4x4 into (rigid right-handed 4x4, uniformScale); raises on
  shear / non-uniform scale. Left-handed frames (OCC Ax3 with indirect
  sense, e.g. a cylinder's -Z axis record) are made right-handed by
  flipping the Y column — valid for all the axisymmetric kinds; the UV
  chart mirroring this causes is detected separately via the chart
  Jacobian (see _chartMirrored).'''
  R = np.asarray(m, dtype=float)[:3, :3].copy()
  scales = np.linalg.norm(R, axis=0)
  if scales.min() <= 0:
    raise ValueError('degenerate transform')
  s = float(scales.mean())
  if (abs(scales - s) > 1e-6 * s).any():
    raise ValueError('non-uniform scale in placement')
  Rn = R / s
  if not np.allclose(Rn.T @ Rn, np.eye(3), atol=1e-5):
    raise ValueError('shear in placement')
  if np.linalg.det(Rn) < 0:
    Rn[:, 1] = -Rn[:, 1]
  out = np.eye(4)
  out[:3, :3] = Rn
  out[:3, 3] = np.asarray(m, dtype=float)[:3, 3]
  return out, s


def _axisFrame(origin, zAxis, hint=None):
  z = np.asarray(zAxis, dtype=float)
  z = z / np.linalg.norm(z)
  h = np.array([1., 0., 0.]) if hint is None else np.asarray(hint, float)
  if abs(np.dot(h, z)) > .9:
    h = np.array([0., 1., 0.])
  x = h - np.dot(h, z) * z
  x /= np.linalg.norm(x)
  y = np.cross(z, x)
  m = np.eye(4)
  m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = x, y, z, origin
  return m


def _resolveAnalytic(rec):
  '''Map a surface record onto one of the device analytic kinds. Returns
  (kindName, frame4x4, params dict) or None when only tessellation works.
  frame is local->shape; kind params follow geometry/surfaces.py.'''
  t = rec['type']
  if t == 'rtrimmed':
    return _resolveAnalytic(rec['basis'])
  if t == 'plane':
    return 'plane', rec['frame'], {}
  if t == 'sphere':
    return 'sphere', rec['frame'], dict(radius=rec['r'])
  if t == 'cylinder':
    return 'cylinder', rec['frame'], dict(radius=rec['r'])
  if t == 'cone':
    return 'cone', rec['frame'], dict(radius=rec['r'],
                                      tanAngle=math.tan(rec['semiAngle']))
  if t == 'torus':
    # only the non-self-intersecting regime maps to the device TORUS kind
    if rec['r1'] > rec['r2'] > 0:
      return 'torus', rec['frame'], dict(majorRadius=rec['r1'],
                                         minorRadius=rec['r2'])
    return None
  if t == 'offsetsurf':
    base = _resolveAnalytic(rec['basis'])
    if base is None:
      return None
    kind, frame, params = base
    val = rec['value']
    if kind == 'plane':
      f = frame.copy()
      f[:3, 3] = f[:3, 3] + val * f[:3, 2]
      return 'plane', f, params
    if kind in ('sphere', 'cylinder'):
      r = params['radius'] + val
      if r <= 0:
        return None
      return kind, frame, dict(radius=r)
    return None
  if t == 'revolution':
    axisP = rec['p']
    axisD = rec['d'] / np.linalg.norm(rec['d'])
    basis = rec['basis']
    window = None
    if basis['type'] == 'trimmed':
      window = (basis['first'], basis['last'])
      basis = basis['basis']
    if basis['type'] == 'line':
      d = basis['d'] / np.linalg.norm(basis['d'])
      cosA = float(np.dot(d, axisD))
      p0 = basis['p']
      radial = p0 - axisP - np.dot(p0 - axisP, axisD) * axisD
      r0 = float(np.linalg.norm(radial))
      if abs(cosA) < 1e-9:
        # meridian perpendicular to axis -> plane
        z0 = float(np.dot(p0 - axisP, axisD))
        return 'plane', _axisFrame(axisP + z0 * axisD, axisD), {}
      if abs(abs(cosA) - 1) < 1e-9:
        return 'cylinder', _axisFrame(axisP, axisD), dict(radius=r0)
      # general cone: radius(z) = rAt0 + z * tanA in the axis frame
      radialDir = d - cosA * axisD
      sinA = float(np.linalg.norm(radialDir))
      drdt = sinA if r0 < 1e-12 or float(
          np.dot(radialDir, radial)) >= 0 else -sinA
      tanA = drdt / cosA        # dr/dz along the line
      z0 = float(np.dot(p0 - axisP, axisD))
      rAt0 = r0 - z0 * tanA
      return 'cone', _axisFrame(axisP, axisD), dict(radius=rAt0,
                                                    tanAngle=tanA)
    if basis['type'] == 'circle':
      c = basis['p']
      onAxis = np.linalg.norm(np.cross(c - axisP, axisD)) < 1e-7 * \
          max(1., basis['r'])
      if onAxis:
        return 'sphere', _axisFrame(c, axisD), dict(radius=basis['r'])
      # off-axis circle whose plane contains the revolution axis -> torus
      along = float(np.dot(c - axisP, axisD))
      radial = c - axisP - along * axisD
      R1 = float(np.linalg.norm(radial))
      r2 = float(basis['r'])
      circleN = basis.get('n')
      if circleN is not None and R1 > r2 > 0:
        circleN = np.asarray(circleN, dtype=float)
        circleN = circleN / max(np.linalg.norm(circleN), 1e-300)
        # the circle's plane contains the axis iff its normal is
        # perpendicular to the axis direction
        if abs(float(np.dot(circleN, axisD))) < 1e-7:
          ringCenter = axisP + along * axisD
          return 'torus', _axisFrame(ringCenter, axisD), \
              dict(majorRadius=R1, minorRadius=r2)
      return None               # self-intersecting / skew -> tessellate
    if basis['type'] == 'parabola':
      # paraboloid: vertex on axis, symmetry axis == revolution axis
      vertex = basis['p']
      sym = basis['x'] / np.linalg.norm(basis['x'])
      if np.linalg.norm(np.cross(vertex - axisP, axisD)) > 1e-6 or \
         abs(abs(np.dot(sym, axisD)) - 1) > 1e-6:
        return None
      # sag along +sym: z = r^2 / (4 focal) -> asphere c=1/(2 focal), k=-1
      c = 1. / (2. * basis['focal'])
      return 'asphere', _axisFrame(vertex, sym), dict(curvature=c,
                                                      conic=-1.)
    return None
  if t in ('bspline', 'bezier'):
    # NURBS faces are frequently EXACT quadrics in disguise: Part::Scale /
    # affine-transformed spheres, cylinders and cones come back from OCC as
    # rational b-splines (reference example 2's scaled lens = 12824
    # tessellation triangles without this). Refit and trace the closed
    # form instead.
    return _fitQuadricSurface(rec)
  return None


def _quadricParamRange(rec):
  '''(u0, u1, v0, v1) natural parameter window of a bspline/bezier
  record.'''
  if rec['type'] == 'bezier':
    return 0., 1., 0., 1.
  uk, vk = np.asarray(rec['uknots']), np.asarray(rec['vknots'])
  return float(uk[0]), float(uk[-1]), float(vk[0]), float(vk[-1])


def _fitQuadricSurface(rec, nFit=20, nVerify=41, tol=1e-6):
  '''Least-squares refit of a b-spline/bezier surface record as an exact
  quadric x^T A x + b.x + c = 0, canonicalized to principal axes. Returns
  (kindName, frame, params) like _resolveAnalytic — mapping to the cheaper
  'plane'/'sphere'/'cylinder' kinds when the eigenstructure collapses —
  or None when the surface is not a quadric to `tol` (relative geometric
  residual |f|/|grad f| per sample against the surface scale).'''
  try:
    u0, u1, v0, v1 = _quadricParamRange(rec)
  except Exception:
    return None
  if not (np.isfinite([u0, u1, v0, v1]).all() and u1 > u0 and v1 > v0):
    return None

  def sample(n):
    us = np.linspace(u0, u1, n)
    vs = np.linspace(v0, v1, n)
    p = evalSurface(rec, us, vs)
    return p.reshape(-1, 3)

  try:
    pts = sample(nFit)
  except Exception:
    return None
  pts = pts[np.isfinite(pts).all(axis=1)]
  if len(pts) < 30:
    return None
  cen0 = pts.mean(axis=0)
  scale = max(float(np.sqrt(((pts - cen0) ** 2).sum(axis=1).mean())), 1e-12)
  q = (pts - cen0) / scale

  # plane first: a plane satisfies infinitely many quadrics; detect it via
  # principal components before the quadric solve goes degenerate
  _w, _V = np.linalg.eigh(q.T @ q / len(q))
  if _w[0] < (tol ** 2):
    n = _V[:, 0]
    frame = _axisFrame(cen0, n)
    return 'plane', frame, {}

  x, y, z = q[:, 0], q[:, 1], q[:, 2]
  M = np.stack([x * x, y * y, z * z, x * y, x * z, y * z,
                x, y, z, np.ones_like(x)], axis=1)
  _u, sv, VT = np.linalg.svd(M, full_matrices=False)
  coef = VT[-1]
  Aq = np.array([[coef[0], coef[3] / 2, coef[4] / 2],
                 [coef[3] / 2, coef[1], coef[5] / 2],
                 [coef[4] / 2, coef[5], coef[2]]])
  bq = coef[6:9]
  cq = coef[9]
  # un-center / un-scale to record coordinates
  A = Aq / scale ** 2
  b = bq / scale - 2. * (Aq @ cen0) / scale ** 2
  c = (float(cen0 @ Aq @ cen0) / scale ** 2 - float(bq @ cen0) / scale
       + cq)

  w, V = np.linalg.eigh(A)
  wmax = np.abs(w).max()
  if wmax < 1e-12:
    return None
  wrel = w / wmax
  zero = np.abs(wrel) < 1e-7
  nz = int((~zero).sum())
  if nz == 0:
    return None

  bR = V.T @ b
  # a linear term along a zero-curvature axis is only representable on the
  # canonical z axis; two such axes cannot both be z (|b| has units 1/L vs
  # |A|'s 1/L^2, so thresholds carry the surface scale)
  linZero = (np.abs(bR) > 1e-7 * wmax * scale) & zero
  if linZero.sum() > 1:
    return None

  # sphere: three equal eigenvalues
  if nz == 3 and np.abs(wrel.max() - wrel.min()) < 1e-6:
    a = float(w.mean())
    cenS = -b / (2 * a)
    r2 = float(cenS @ A @ cenS - c) / a
    if r2 <= 0:
      return None
    return ('sphere', _axisFrame(cenS, V[:, 2]),
            dict(radius=math.sqrt(r2)))

  # choose the canonical z axis
  if linZero.any():
    zi = int(np.nonzero(linZero)[0][0])          # parabolic direction
  elif nz == 2:
    zi = int(np.nonzero(zero)[0][0])             # extrusion axis
  elif np.abs(wrel[0] - wrel[1]) < 1e-6 or \
      np.abs(wrel[1] - wrel[2]) < 1e-6 or np.abs(wrel[0] - wrel[2]) < 1e-6:
    # revolution quadric: z = the distinct eigenvalue's axis
    d01 = abs(wrel[0] - wrel[1])
    d12 = abs(wrel[1] - wrel[2])
    d02 = abs(wrel[0] - wrel[2])
    if d01 <= d12 and d01 <= d02:
      zi = 2
    elif d12 <= d01 and d12 <= d02:
      zi = 0
    else:
      zi = 1
  else:
    # triaxial: z = principal axis most aligned with the mean surface
    # normal, so a dome face becomes a z zone/cap
    g = (2. * pts @ A + b)
    gn = np.linalg.norm(g, axis=1, keepdims=True)
    g = (g / np.maximum(gn, 1e-30)).mean(axis=0)
    zi = int(np.argmax(np.abs(V.T @ g)))
  order = [i for i in range(3) if i != zi] + [zi]
  Vp = V[:, order]
  if np.linalg.det(Vp) < 0:
    Vp[:, 0] = -Vp[:, 0]
  wp = w[order]
  bp = Vp.T @ b

  # complete squares: local = rotated - cen makes the representable linear
  # terms vanish; a zero-curvature z axis keeps its linear coefficient qz
  cen = np.zeros(3)
  for i in range(3):
    if np.abs(wp[i]) > 1e-7 * wmax:
      cen[i] = -bp[i] / (2 * wp[i])
    elif i < 2 and np.abs(bp[i]) > 1e-7 * wmax * scale:
      return None
  zFlat = np.abs(wp[2]) <= 1e-7 * wmax
  qz = float(bp[2]) if zFlat else 0.
  if zFlat:
    wp[2] = 0.
  # constant term = f evaluated at the new origin (rotated coords `cen`)
  q0 = float((wp * cen * cen).sum() + bp @ cen + c)
  if abs(qz) > 1e-7 * wmax * scale:
    # paraboloid: absorb the constant by shifting the origin along z
    cen[2] += -q0 / qz
    q0 = 0.
  else:
    qz = 0.

  # normalize: largest |quadratic coefficient| = 1, net-positive sign
  m = np.abs(wp).max()
  qa, qb, qc = wp / m
  qzN, q0N = qz / m, q0 / m
  if qa + qb + qc < 0:
    qa, qb, qc, qzN, q0N = -qa, -qb, -qc, -qzN, -q0N

  frame = np.eye(4)
  frame[:3, :3] = Vp
  frame[:3, 3] = Vp @ cen

  # cylinder shortcut: circular cross-section, no z terms
  if np.isclose(qa, qb, rtol=1e-6) and abs(qc) < 1e-9 and \
      abs(qzN) < 1e-9 and q0N < 0 and qa > 0:
    return 'cylinder', frame, dict(radius=math.sqrt(-q0N / qa))

  params = dict(coeffs=(float(qa), float(qb), float(qc),
                        float(qzN), float(q0N)))

  # verify on a denser grid with the CANONICAL form (catches both fit and
  # canonicalization errors): geometric distance |f| / |grad f| < tol*scale
  try:
    vpts = sample(nVerify)
  except Exception:
    return None
  vpts = vpts[np.isfinite(vpts).all(axis=1)]
  inv = np.linalg.inv(frame)
  pl = vpts @ inv[:3, :3].T + inv[:3, 3]
  f = (qa * pl[:, 0] ** 2 + qb * pl[:, 1] ** 2 + qc * pl[:, 2] ** 2
       + qzN * pl[:, 2] + q0N)
  grad = np.stack([2 * qa * pl[:, 0], 2 * qb * pl[:, 1],
                   2 * qc * pl[:, 2] + qzN], axis=1)
  gn = np.maximum(np.linalg.norm(grad, axis=1), 1e-30)
  if (np.abs(f) / gn).max() > tol * scale:
    return None
  return 'quadric', frame, params


_NAT_UREV = ('sphere', 'cylinder', 'cone', 'asphere', 'quadric', 'torus')


def _deviceUV(kind, params, pLocal):
  '''Map local-frame points -> the device trim chart (u, v) per kind
  (geometry/surfaces.py trim semantics).'''
  x, y, z = pLocal[..., 0], pLocal[..., 1], pLocal[..., 2]
  if kind == 'plane':
    return x, y
  u = np.arctan2(y, x)
  if kind == 'asphere':
    return u, np.hypot(x, y)
  if kind == 'torus':
    # v = tube angle, same chart the device trim band tests
    return u, np.arctan2(z, np.hypot(x, y) - params['majorRadius'])
  return u, z          # sphere / cylinder / cone


def _unwrapLoopUV(u, v, vAngular=False):
  '''Unwrap angular u (and angular v: torus tube angle) along the loop for
  polygon continuity.'''
  return np.unwrap(u), (np.unwrap(v) if vAngular else v)


class FaceResult:
  '''One classified face: either an analytic surface dict (surfaces.py
  format, possibly with a trimBitmap), or a list of triangle dicts.'''

  def __init__(self, surfaces, note=''):
    self.surfaces = surfaces
    self.note = note


def _loopsToUV(kind, params, frame, loops, sphereR=None):
  '''World loops -> device-UV polylines (list of (N,2)).'''
  inv = np.linalg.inv(frame)
  uvLoops = []
  for segs in loops:
    us, vs = [], []
    for sign, seg in segs:
      if isinstance(seg, dict):      # degenerate pole edge
        if kind == 'sphere' and seg['pcurve'] is not None and \
           sphereR is not None:
          # the 3D point is the pole; sweep u over the pcurve range
          rep = seg['pcurve']
          uu = np.linspace(rep['first'], rep['last'], 17)
          if sign < 0:
            uu = uu[::-1]
          vv = np.full_like(uu, np.nan)  # filled after neighbor known
          us.append(uu)
          vs.append(vv)
        continue
      pl = seg @ inv[:3, :3].T + inv[:3, 3]
      u, v = _deviceUV(kind, params, pl)
      us.append(np.asarray(u))
      vs.append(np.asarray(v))
    if not us:
      continue
    u = np.concatenate(us)
    v = np.concatenate(vs)
    # degenerate-edge v (nan) -> pole height
    if np.isnan(v).any() and sphereR is not None:
      # pole sign: nearest non-nan neighbor's v decides which pole
      nn = np.where(np.isnan(v), np.interp(
          np.arange(len(v)), np.nonzero(~np.isnan(v))[0],
          v[~np.isnan(v)]), v)
      v = np.where(np.isnan(v), np.sign(nn) * sphereR, v)
    if kind != 'plane':
      u, v = _unwrapLoopUV(u, v, vAngular=(kind == 'torus'))
      # keep the unwrapped loop near the principal branch so the
      # rasterizer's +-2-period replicas always cover it
      u = u - round(float(u.mean()) / (2 * math.pi)) * 2 * math.pi
      if kind == 'torus':
        v = v - round(float(v.mean()) / (2 * math.pi)) * 2 * math.pi
    uvLoops.append(np.stack([u, v], axis=1))
  return uvLoops


def _circleLoopInfo(segs, frame):
  '''If every sampled segment of a loop lies on a circle (in the local z=0
  plane of `frame`, any center), return (center2d, radius); else None.'''
  inv = np.linalg.inv(frame)
  pts = np.concatenate([s for _sg, s in segs
                        if isinstance(s, np.ndarray)], axis=0)
  pl = pts @ inv[:3, :3].T + inv[:3, 3]
  scale = max(1., float(np.abs(pl).max()))
  if np.ptp(pl[:, 2]) > 1e-6 * scale:
    return None
  # algebraic (Kasa) circle fit: exact for points on a circle, unbiased for
  # arcs (a plain centroid is offset for partial or endpoint-duplicated
  # sampling)
  x, y = pl[:, 0], pl[:, 1]
  A = np.stack([2 * x, 2 * y, np.ones_like(x)], axis=1)
  b = x * x + y * y
  try:
    sol, *_ = np.linalg.lstsq(A, b, rcond=None)
  except np.linalg.LinAlgError:
    return None
  c = sol[:2]
  r = np.hypot(x - c[0], y - c[1])
  if np.ptp(r) > 1e-6 * scale:
    return None
  return c, float(r.mean())


def classifyFace(brep, faceTs, accLoc, faceSign, elem, baseTransform,
                 maskRes=192, tessRes=96, label=''):
  '''Convert one BRep face into device surfaces. Returns a FaceResult.'''
  surfIdx = faceTs.data['surf']
  rec = brep.surfaces[surfIdx - 1]
  base = np.asarray(baseTransform, dtype=float)
  faceLoc = accLoc @ brep.locations[faceTs.data['loc']] \
      if faceTs.data['loc'] else accLoc
  fullLoc = base @ faceLoc          # surface record frame -> world

  # boundary loops: faceWireLoops yields shape-frame points (accLoc and the
  # per-edge ref locations are applied; the object placement is not) —
  # lift them to world with `base`
  loops = faceWireLoops(brep, faceTs, accLoc)
  loops = [[(sg, (p @ base[:3, :3].T + base[:3, 3])
             if isinstance(p, np.ndarray) else p) for sg, p in segs]
           for segs in loops]
  if not loops:
    return FaceResult([], 'face without wires skipped')

  analytic = _resolveAnalytic(rec)
  if analytic is not None:
    try:
      return _buildAnalyticFace(brep, faceTs, rec, analytic, fullLoc,
                                faceSign, elem, loops, maskRes, label)
    except Exception as e:
      io.verb(f'analytic conversion of a {rec["type"]} face in {label!r} '
              f'failed ({e}); tessellating')
  return _tessellateFace(brep, faceTs, rec, fullLoc, faceSign, elem,
                         tessRes, label)


def _occNormalSign(rec, kind, params, frame, fullLoc, uvLoopsOcc=None,
                   probe=None):
  '''+1 if the OCC surface normal (dPu x dPv) matches the device canonical
  normal at a probe point, else -1. Evaluated numerically so every surface
  type and meridian direction is handled uniformly.'''
  if probe is None:
    return +1
  u, v = probe
  eps = 1e-4
  p = evalSurface(rec, np.array([u, u + eps]), np.array([v, v + eps]))
  p00, p01 = p[0, 0], p[0, 1]
  p10 = p[1, 0]
  du = (p01 - p00) / eps
  dv = (p10 - p00) / eps
  nOcc = np.cross(du, dv)
  nn = np.linalg.norm(nOcc)
  if nn < 1e-12:
    return +1
  nOcc = nOcc / nn
  # canonical device normal at the same point, in shape frame
  inv = np.linalg.inv(frame)
  pl = inv[:3, :3] @ p00 + inv[:3, 3]
  x, y, z = pl
  if kind == 'plane':
    nLoc = np.array([0., 0., 1.])
  elif kind == 'sphere':
    nLoc = pl / max(np.linalg.norm(pl), 1e-30)
  elif kind == 'cylinder':
    nLoc = np.array([x, y, 0.])
    nLoc /= max(np.linalg.norm(nLoc), 1e-30)
  elif kind == 'cone':
    r = max(math.hypot(x, y), 1e-30)
    nLoc = np.array([x / r, y / r, -params['tanAngle']])
    nLoc /= np.linalg.norm(nLoc)
  elif kind == 'asphere':
    c, k = params['curvature'], params.get('conic', 0.)
    r2 = x * x + y * y
    root = math.sqrt(max(1 - (1 + k) * c * c * r2, 1e-12))
    g = c * (2 / (1 + root) + (1 + k) * c * c * r2 / (root * (1 + root) ** 2))
    nLoc = np.array([-g * x, -g * y, 1.])
    nLoc /= np.linalg.norm(nLoc)
  elif kind == 'quadric':
    qa, qb, qc, qz, _q0 = params['coeffs']
    nLoc = np.array([2 * qa * x, 2 * qb * y, 2 * qc * z + qz])
    nLoc /= max(np.linalg.norm(nLoc), 1e-30)
  elif kind == 'torus':
    s = max(math.hypot(x, y), 1e-30)
    scale = params['majorRadius'] / s
    nLoc = np.array([x * (1. - scale), y * (1. - scale), z])
    nLoc /= max(np.linalg.norm(nLoc), 1e-30)
  else:
    return +1
  nCanon = frame[:3, :3] @ nLoc
  return +1 if float(np.dot(nOcc, nCanon)) >= 0 else -1


def _chartMirrored(rec, fullLoc, frameWorld, kind, probeUV, params=None):
  '''True when the map from the OCC UV chart onto the device trim chart
  (u = azimuth in frameWorld / plane-xy) flips orientation — stored wire
  directions then bound the complementary region. Evaluated numerically so
  indirect Ax3 frames, reversed revolution axes and meridian directions
  are all handled uniformly.'''
  u, v = probeUV
  eps = 1e-4 * (1. + abs(u) + abs(v))
  p = evalSurface(rec, np.array([u, u + eps]), np.array([v, v + eps]))
  pts = np.stack([p[0, 0], p[0, 1], p[1, 0]])       # (u,v), (u+e,v), (u,v+e)
  pts = pts @ fullLoc[:3, :3].T + fullLoc[:3, 3]
  inv = np.linalg.inv(frameWorld)
  pl = pts @ inv[:3, :3].T + inv[:3, 3]
  um, vm = _deviceUV(kind, params, pl)
  um = np.unwrap(um)
  J = (um[1] - um[0]) * (vm[2] - vm[0]) - (um[2] - um[0]) * (vm[1] - vm[0])
  return J < 0


def _probeUV(rec, brep, faceTs):
  '''A UV point on the face (midpoint of the first pcurve, or of the first
  sampled 3D edge's parameter range mapped arbitrarily).'''
  for wSign, wIdx, _wl in faceTs.refs:
    wire = brep.tshape(wIdx)
    if wire.shapeType != 'Wi':
      continue
    for _es, eIdx, _el in wire.refs:
      edge = brep.tshape(eIdx)
      if edge.shapeType != 'Ed':
        continue
      pc = _edgePcurve(brep, edge, faceTs.data['surf'])
      if pc is not None and 'curve2d' in pc:
        c2 = brep.curves2d[pc['curve2d'] - 1]
        mid = .5 * (pc['first'] + pc['last'])
        uv = evalCurve(c2, np.array([mid]), dim=2)[0]
        return float(uv[0]), float(uv[1])
  return None


def _buildAnalyticFace(brep, faceTs, rec, analytic, fullLoc, faceSign,
                       elem, loops, maskRes, label):
  kind, frameLocal, params = analytic
  # surface frame -> world, splitting off uniform scale into the params
  frameWorld, scale = _decomposeRigidScale(fullLoc @ frameLocal)
  if scale != 1.:
    if 'radius' in params:
      params['radius'] *= scale
    if 'majorRadius' in params:
      params['majorRadius'] *= scale
      params['minorRadius'] *= scale
    if 'curvature' in params:
      params['curvature'] /= scale
    if 'coeffs' in params:
      qa, qb, qc, qz, q0 = params['coeffs']
      s2 = scale * scale
      params['coeffs'] = (qa / s2, qb / s2, qc / s2, qz / scale, q0)

  probe = _probeUV(rec, brep, faceTs)
  nSign = _occNormalSign(rec, kind, params, frameLocal, fullLoc, probe=probe)
  orient = float(faceSign) * nSign

  sphereR = params.get('radius') if kind == 'sphere' else None
  uvLoops = _loopsToUV(kind, params, frameWorld, loops, sphereR=sphereR)
  if not uvLoops:
    raise ValueError('no usable boundary loops')
  # material side: stored wire directions bound the region material-left in
  # the OCC chart of a FORWARD face; flip for REVERSED faces and for device
  # charts that mirror the OCC chart (indirect Ax3 frames, reversed
  # revolution axes)
  flip = faceSign < 0
  if probe is not None:
    try:
      if _chartMirrored(rec, fullLoc, frameWorld, kind, probe,
                        params=params):
        flip = not flip
    except Exception:
      pass
  if flip:
    uvLoops = [loop[::-1] for loop in uvLoops]
  allUV = np.concatenate(uvLoops, axis=0)

  angular = kind in _NAT_UREV
  if angular:
    uWindow = (-math.pi, math.pi)
    uPeriod = 2 * math.pi
  else:
    margin = .02 * max(np.ptp(allUV[:, 0]), 1e-9) + 1e-9
    uWindow = (allUV[:, 0].min() - margin, allUV[:, 0].max() + margin)
    uPeriod = None
  if kind == 'sphere':
    vWindow = (-params['radius'], params['radius'])
  elif kind == 'torus':
    # v is the tube ANGLE: natural domain one full turn. Loops are
    # unwrapped like u; recenter so the face's own band stays inside one
    # period (faces crossing the inner-equator seam get a shifted window
    # only the mask sees — the closed-form band below snaps via allUV).
    vWindow = (-math.pi, math.pi)
  elif kind == 'asphere':
    vWindow = (0., allUV[:, 1].max() * 1.0001 + 1e-9)
  elif kind == 'quadric' and (zNat := _quadricZDomain(params)) is not None:
    # bounded quadric (ellipsoid): natural z domain like the sphere's
    # (-R, R), so caps containing the apex classify as z bands
    vWindow = zNat
  else:
    margin = .02 * max(np.ptp(allUV[:, 1]), 1e-9) + 1e-9
    vWindow = (allUV[:, 1].min() - margin, allUV[:, 1].max() + margin)

  mask, u0, v0, du, dv = rasterizeLoops(uvLoops, uWindow, vWindow, maskRes,
                                        uPeriod=uPeriod)
  if not mask.any():
    # systematically inverted orientation convention -> retry flipped
    mask = ~mask
  fillRatio = mask.mean()

  def makeSurf(trimArgs, frame=None):
    return S._surf(S.KIND_CODES[kind], _kindParams(kind, params),
                   trimArgs, frameWorld if frame is None else frame,
                   elem, orient)

  # plane: concentric-circle boundaries beat the separability path (a disc
  # is not separable in cartesian UV)
  if kind == 'plane':
    res = _planeCircles(loops, frameWorld, makeSurf)
    if res is not None:
      return res

  sep, uIn, vIn = _separable(mask)
  if sep:
    uRun = _contiguousTrue(uIn, periodic=angular)
    vRun = _contiguousTrue(vIn)
    if uRun is not None and vRun is not None:
      # the mask decides WHETHER the region is a UV box; the box bounds come
      # from the exact boundary extents (mask bins are ~face/192 coarse).
      # A run reaching past the boundary extent means the face contains the
      # chart's degenerate point (sphere pole / asphere vertex): snap to the
      # natural domain limit there.
      vLoMask = v0 + vRun[0] * dv
      vHiMask = v0 + (vRun[1] + 1) * dv
      vLoExact = float(allUV[:, 1].min())
      vHiExact = float(allUV[:, 1].max())
      vLo = vLoExact if vLoMask > vLoExact - 2 * dv else vWindow[0]
      vHi = vHiExact if vHiMask < vHiExact + 2 * dv else vWindow[1]
      uFull = (uRun[1] - uRun[0] + 1) >= len(uIn)
      if kind in ('sphere', 'cylinder', 'cone', 'quadric') and uFull:
        return FaceResult([makeSurf((0., vLo, vHi))], 'zRange')
      if kind == 'torus' and uFull:
        # v band must live inside ONE principal period for the closed-form
        # atan2 band test; a seam-crossing partial band falls through to
        # the bitmap (whose chart window may sit shifted)
        if vHi - vLo > 2 * math.pi - 1e-3:
          return FaceResult([makeSurf((0., -3.15, 3.15))], 'full tube')
        if -math.pi <= vLo and vHi <= math.pi:
          return FaceResult([makeSurf((0., vLo, vHi))], 'vRange')
      if kind == 'asphere' and uFull:
        return FaceResult([makeSurf((0., max(vLo, 0.), vHi))], 'rRange')
      if kind == 'plane':
        # rectangle, recentered so the rect trim is origin-symmetric
        uLo, uHi = float(allUV[:, 0].min()), float(allUV[:, 0].max())
        vLo, vHi = vLoExact, vHiExact
        cx, cy = .5 * (uLo + uHi), .5 * (vLo + vHi)
        fw = frameWorld @ T.translation(cx, cy, 0.)
        return FaceResult(
            [makeSurf((1., .5 * (uHi - uLo), .5 * (vHi - vLo)), frame=fw)],
            'rect')

  # ---- trim primitives: boolean-cut faces (base window minus exact
  # rect/disc/half-plane holes) beat the bitmap in fidelity AND cost
  res = _fitTrimPrims(kind, params, frameWorld, loops, uvLoops, allUV,
                      uWindow, vWindow, angular, makeSurf)
  if res is not None:
    return res

  # ---- bitmap trim
  if kind == 'torus' and (allUV[:, 1].min() < -math.pi - 1e-6
                          or allUV[:, 1].max() > math.pi + 1e-6):
    # the kernel/tracer sample v on the principal branch only; a bitmap
    # window shifted across the tube seam would mis-index -> tessellate
    raise ValueError('torus face crosses the tube-angle seam')
  bitmap = dict(mask=mask.astype(np.uint8), u0=u0, v0=v0,
                invDu=1. / du, invDv=1. / dv)
  surf = makeSurf((2., 0., 0., 0., 0., 0.))
  surf['trimBitmap'] = bitmap
  return FaceResult([surf], f'bitmap trim (fill {fillRatio:.2f})')


# ========================================================== trim-primitive fit

def _windingAt(uvLoops, pts, uPeriod=None):
  '''Occupancy (winding number != 0) of chart points against the oriented
  boundary polylines — the point-query twin of rasterizeLoops (same
  downward-v-ray crossing convention).'''
  w = np.zeros(len(pts), dtype=np.int64)
  shifts = (0.,) if uPeriod is None else (-uPeriod, 0., uPeriod,
                                          2 * uPeriod, -2 * uPeriod)
  pu, pv = pts[:, 0], pts[:, 1]
  for loop in uvLoops:
    if len(loop) < 2:
      continue
    a, b = loop[:-1], loop[1:]
    for shift in shifts:
      ax, ay = a[:, 0] + shift, a[:, 1]
      bx, by = b[:, 0] + shift, b[:, 1]
      cross = ((ax[None, :] <= pu[:, None]) & (bx[None, :] > pu[:, None])) \
          | ((bx[None, :] <= pu[:, None]) & (ax[None, :] > pu[:, None]))
      denom = np.where(np.abs(bx - ax) < 1e-300, 1e-300, bx - ax)
      tpar = (pu[:, None] - ax[None, :]) / denom[None, :]
      vCross = ay[None, :] + tpar * (by - ay)[None, :]
      sign = np.where(bx > ax, 1, -1)
      w += np.sum(np.where(cross & (vCross <= pv[:, None]),
                           sign[None, :], 0), axis=1)
  return w != 0


def _distToLoops(uvLoops, pts, uScale, vScale, uPeriod=None):
  '''Min normalized distance of chart points to the boundary polylines
  (validation-margin metric; per-axis scales even out radians vs mm).'''
  best = np.full(len(pts), np.inf)
  q = np.stack([pts[:, 0] / uScale, pts[:, 1] / vScale], axis=1)
  shifts = (0.,) if uPeriod is None else (-uPeriod, 0., uPeriod)
  for loop in uvLoops:
    if len(loop) < 2:
      continue
    for shift in shifts:
      a = np.stack([(loop[:-1, 0] + shift) / uScale,
                    loop[:-1, 1] / vScale], axis=1)
      b = np.stack([(loop[1:, 0] + shift) / uScale,
                    loop[1:, 1] / vScale], axis=1)
      ab = b - a
      den = np.maximum((ab * ab).sum(axis=1), 1e-300)
      t = ((q[:, None, :] - a[None, :, :]) * ab[None, :, :]).sum(axis=2) \
          / den[None, :]
      t = np.clip(t, 0., 1.)
      proj = a[None, :, :] + t[:, :, None] * ab[None, :, :]
      d = np.sqrt(((q[:, None, :] - proj) ** 2).sum(axis=2)).min(axis=1)
      best = np.minimum(best, d)
  return best


def _chartToLocalXY(kind, params, u, v):
  '''Inverse of _deviceUV onto the surface: local (x, y, z) at chart
  (u, v) plus a validity mask (False where (u, v) has no surface
  point).'''
  if kind == 'plane':
    return u, v, np.zeros(len(u)), np.ones(len(u), dtype=bool)
  cu, su = np.cos(u), np.sin(u)
  z = v
  if kind == 'sphere':
    r2 = params['radius'] ** 2 - v ** 2
    ok = r2 >= 0
    r = np.sqrt(np.maximum(r2, 0.))
  elif kind == 'cylinder':
    r = np.full(len(u), params['radius'])
    ok = np.ones(len(u), dtype=bool)
  elif kind == 'cone':
    r = params['radius'] + v * params['tanAngle']
    ok = r >= 0
  elif kind == 'asphere':
    r = v
    ok = v >= 0
    c = params['curvature']
    k = params.get('conic', 0.)
    root = np.sqrt(np.maximum(1. - (1. + k) * c * c * r * r, 1e-12))
    z = c * r * r / (1. + root)
  elif kind == 'quadric':
    qa, qb, qc, qz, q0 = params['coeffs']
    w = -(qc * v * v + qz * v + q0)
    den = qa * cu * cu + qb * su * su
    ok = (w >= 0) & (den > 0)
    r = np.sqrt(np.maximum(w, 0.) / np.maximum(den, 1e-300))
  elif kind == 'torus':
    # v is the tube angle; z = r2 sin v, radial = R + r2 cos v
    r = params['majorRadius'] + params['minorRadius'] * np.cos(v)
    z = params['minorRadius'] * np.sin(v)
    ok = np.ones(len(u), dtype=bool)
  else:
    return None
  return r * cu, r * su, z, ok


def _fitSeg2D(p2, tol, dbg=None):
  '''Classify one boundary-edge polyline's (x, y) projection:
  ('line', n, c, d, ctr, pts), ('circle', cx, cy, r),
  ('conic', A, B, C, D, E, F), ('poly2', ctr, d, c2, c1) — an open
  conic arc y' = c2 x'^2 + c1 x' in its PCA frame, the planar cut of a
  conic neighbor face — ('point',), or None.'''
  ctr = p2.mean(axis=0)
  q = p2 - ctr
  if np.abs(q).max() < tol:
    return ('point',)
  _w, V = np.linalg.eigh(q.T @ q / len(q))
  n = V[:, 0]
  if np.abs(q @ n).max() <= tol:
    return ('line', n, float(n @ ctr), V[:, 1], ctr, p2)
  x, y = p2[:, 0], p2[:, 1]
  A = np.stack([2 * x, 2 * y, np.ones_like(x)], axis=1)
  b = x * x + y * y
  try:
    sol, *_ = np.linalg.lstsq(A, b, rcond=None)
  except np.linalg.LinAlgError:
    return None
  cx, cy = float(sol[0]), float(sol[1])
  r = np.hypot(x - cx, y - cy)
  circResid = .5 * float(np.ptp(r))
  # open conic arc in the PCA frame: y' = c2 x'^2 + c1 x' + c0, with the
  # frame normal matching the runtime convention n = (-d[1], d[0]).
  # A shallow arc may pass BOTH fits — prefer the smaller residual (a
  # parabolic slot-wall edge beats its osculating circle by ~1e6x)
  d = V[:, 1]
  nC = np.array([-d[1], d[0]])
  xr, yr = q @ d, q @ nC
  M = np.stack([xr * xr, xr, np.ones_like(xr)], axis=1)
  try:
    cf, *_ = np.linalg.lstsq(M, yr, rcond=None)
    polyResid = float(np.abs(M @ cf - yr).max())
  except np.linalg.LinAlgError:
    cf, polyResid = None, np.inf
  # shallow arcs (sag < 0.2 chord) ALWAYS prefer poly2: a Kasa circle fit
  # of a shallow arc passes tolerance with a wildly ill-determined center,
  # which poisons disc-hole candidates; the quadratic localizes the
  # boundary itself to machine precision
  shallow = float(np.ptp(yr)) < .2 * float(np.ptp(xr))
  if cf is not None and polyResid <= tol and \
      (shallow or polyResid < circResid):
    return ('poly2', ctr + float(cf[2]) * nC, d, float(cf[0]),
            float(cf[1]))
  if circResid <= tol:
    return ('circle', cx, cy, float(r.mean()))
  # general conic (ellipse / hyperbola / rotated parabola — boolean-cut
  # boundaries such as the planar rim of a scaled-sphere lens, or a
  # tilted-plane cut of a paraboloid)
  con = _fitConic2D(p2, tol)
  if con is not None:
    return ('conic',) + con
  if dbg is not None:
    dbg('segfit fail: lineResid', float(np.abs(q @ n).max()),
        'circResid', float(np.ptp(r)), 'polyResid', polyResid,
        'tol', tol, 'bbox', p2.min(0).tolist(), p2.max(0).tolist())
  return None


def _fitConic2D(p2, tol):
  '''Least-squares general conic A x^2 + B xy + C y^2 + D x + E y + F = 0
  through the polyline (fit in a centered/scaled frame, coefficients
  returned in the ORIGINAL frame, normalized to max |coeff| = 1); None
  unless the geometric residual |f|/|grad f| is within `tol`.'''
  ctr0 = p2.mean(axis=0)
  sc = max(float(np.abs(p2 - ctr0).max()), 1e-12)
  x, y = (p2[:, 0] - ctr0[0]) / sc, (p2[:, 1] - ctr0[1]) / sc
  M = np.stack([x * x, x * y, y * y, x, y, np.ones_like(x)], axis=1)
  try:
    _u, _s, VT = np.linalg.svd(M, full_matrices=False)
  except np.linalg.LinAlgError:
    return None
  A, B, C, D, E, F = VT[-1]
  f = M @ VT[-1]
  gx = 2 * A * x + B * y + D
  gy = B * x + 2 * C * y + E
  gn = np.maximum(np.hypot(gx, gy), 1e-30)
  if (np.abs(f) / gn).max() > tol / sc:
    return None
  # un-scale/un-center to original coords
  cx0, cy0 = float(ctr0[0]), float(ctr0[1])
  A2, B2, C2 = A / sc ** 2, B / sc ** 2, C / sc ** 2
  D2 = D / sc - (2 * A2 * cx0 + B2 * cy0)
  E2 = E / sc - (B2 * cx0 + 2 * C2 * cy0)
  F2 = (F + A2 * cx0 * cx0 + B2 * cx0 * cy0 + C2 * cy0 * cy0
        - (D / sc) * cx0 - (E / sc) * cy0)
  co = np.array([A2, B2, C2, D2, E2, F2])
  co = co / max(np.abs(co).max(), 1e-300)
  return tuple(float(v) for v in co)


def _fitPlane3D(pl, tol):
  '''(n, c) with n.p = c if the 3D polyline lies in a unique plane (rank-2
  spread, residual <= tol), else None.'''
  ctr = pl.mean(axis=0)
  q = pl - ctr
  w, V = np.linalg.eigh(q.T @ q / len(q))
  if np.sqrt(max(float(w[1]), 0.)) < tol:
    return None                   # degenerate (straight) — no unique plane
  n = V[:, 0]
  if np.abs(q @ n).max() > tol:
    return None
  return n, float(n @ ctr)


def _fitTrimPrims(kind, params, frameWorld, loops, uvLoops, allUV,
                  uWindow, vWindow, angular, makeSurf, maxPrims=8,
                  nSamples=4096):
  """Classify a face whose boundary is neither a UV box nor a disc via the
  shape algebra of boolean CAD operations: a closed-form BASE window plus
  exact ADD primitives minus exact HOLE primitives (rotated rects, discs,
  half-planes in local (x, y)) — the reference trims such faces per-ray
  through OCC distToShape (ray.py:357-383). Primitive candidates are
  proposed from line/circle fits of the boundary edges (tolerance ~half a
  bitmap pixel, so an accepted fit is at least as faithful as the 192-px
  bitmap it replaces), accepted only where interior sampling agrees, and
  the final formula must reproduce the exact winding-number occupancy on
  every margin-filtered sample — any mismatch falls back to the bitmap
  trim. Returns a FaceResult or None."""
  import os
  dbg = (lambda *a: print('[fitprims]', *a)) \
      if os.environ.get('ODW_DEBUG_PRIMS') else (lambda *a: None)
  inv = np.linalg.inv(frameWorld)
  edges = []                      # (p2 (N,2), vArr or None)
  edges3d = []                    # full local-frame polylines (N,3)
  for wireSegs in loops:
    for _sg, seg in wireSegs:
      if not isinstance(seg, np.ndarray):
        continue
      pl = seg @ inv[:3, :3].T + inv[:3, 3]
      vArr = None
      if kind != 'plane':
        _u, vArr = _deviceUV(kind, params, pl)
      edges.append((pl[:, :2], vArr))
      edges3d.append(pl)
  if not edges:
    return None
  scale = max(1., max(float(np.abs(p2).max()) for p2, _v in edges))
  tol = 1e-5 * scale              # geometric identity tolerance
  uPeriod = 2 * math.pi if angular else None

  # ---------------------------------------------------------- ground truth
  rng = np.random.RandomState(0xC0FFEE)
  us = uWindow[0] + rng.rand(nSamples) * (uWindow[1] - uWindow[0])
  vs = vWindow[0] + rng.rand(nSamples) * (vWindow[1] - vWindow[0])
  pts = np.stack([us, vs], axis=1)
  occ = _windingAt(uvLoops, pts, uPeriod)
  if not occ.any():
    occ = ~occ                    # inverted convention (as rasterizeLoops)
  uScale = max(uWindow[1] - uWindow[0], 1e-12)
  vScale = max(vWindow[1] - vWindow[0], 1e-12)
  distB = _distToLoops(uvLoops, pts, uScale, vScale, uPeriod)
  margin = distB > 4e-3
  # fit acceptance: below the validation margin on the narrow window axis
  # (a fit residual beyond the margin leaks stray mismatches past the
  # blind zone and breaks hole/add acceptance); boundary curves from
  # boolean cuts are exact conics, so the tight bound costs nothing
  tolFit = max(min(1e-3 * scale,
                   3e-3 * (vScale if angular else min(uScale, vScale))),
               tol)
  xs, ys, zs, okXY = _chartToLocalXY(kind, params, us, vs)
  valid = margin & okXY
  if valid.sum() < 400:
    dbg('too few valid samples', int(valid.sum()))
    return None

  # --------------------------------------------- edge classes + base options
  vLoE, vHiE = float(allUV[:, 1].min()), float(allUV[:, 1].max())
  lines, circles, conics, poly2s, planes3d = [], [], [], [], []
  baseOpts = []
  if angular:
    def probeOcc(vP):
      uu = np.linspace(uWindow[0], uWindow[1], 9, endpoint=False)
      return _windingAt(uvLoops, np.stack(
          [uu, np.full_like(uu, vP)], axis=1), uPeriod).mean() > 0.5

    epsV = 2e-3 * vScale
    vLo = vWindow[0] if (vLoE > vWindow[0] + 2 * epsV
                         and probeOcc(vWindow[0] + epsV)) else vLoE
    vHi = vWindow[1] if (vHiE < vWindow[1] - 2 * epsV
                         and probeOcc(vWindow[1] - epsV)) else vHiE
    if kind == 'asphere':
      vLo = max(vLo, 0.)
    baseOpts.append(dict(type='band', vLo=vLo, vHi=vHi, circles=None,
                         snapLo=vLo != vLoE, snapHi=vHi != vHiE))
    for (p2, vArr), pl3 in zip(edges, edges3d):
      # rim edges (v ~ const at a band boundary) ARE the base window;
      # genuinely flat rims sit at ~float precision — a finite-ptp "rim"
      # is a tilted cut and must become a half-space candidate instead
      if np.ptp(vArr) < 1e-4 * vScale and (
          abs(float(np.median(vArr)) - vLo) < 4e-3 * vScale
          or abs(float(np.median(vArr)) - vHi) < 4e-3 * vScale):
        dbg('angular edge: RIM ptpV', round(float(np.ptp(vArr)), 5),
            'medV', round(float(np.median(vArr)), 3))
        continue
      # a 3D-planar edge is the rim of a tilted planar cut: a half-SPACE
      # candidate handles it even when the (x, y) projection fits nothing
      pf = _fitPlane3D(pl3, tolFit)
      if pf is not None:
        planes3d.append(pf)
      fit = _fitSeg2D(p2, tolFit, dbg)
      dbg('angular edge: ptpV', round(float(np.ptp(vArr)), 4), 'medV',
          round(float(np.median(vArr)), 3), '2d',
          fit[0] if fit else None, '3dplane', pf is not None)
      if fit is None and pf is None:
        dbg('angular: unclassifiable edge', len(p2))
        return None
      if fit is None:
        continue
      if fit[0] == 'line':
        lines.append(fit[1:])
      elif fit[0] == 'circle':
        circles.append(fit[1:])
      elif fit[0] == 'conic':
        conics.append(fit[1:])
      elif fit[0] == 'poly2':
        poly2s.append(fit[1:])
  else:
    for p2, _v in edges:
      fit = _fitSeg2D(p2, tolFit, dbg)
      if fit is None:
        dbg('plane: unclassifiable edge', len(p2))
        return None
      if fit[0] == 'line':
        lines.append(fit[1:])
      elif fit[0] == 'circle':
        circles.append(fit[1:])
      elif fit[0] == 'conic':
        conics.append(fit[1:])
      elif fit[0] == 'poly2':
        poly2s.append(fit[1:])
    dbg('plane: lines', len(lines), 'circles', len(circles),
        'conics', len(conics), 'poly2s', len(poly2s))
    # disc/annulus base candidates: one per distinct circle center
    # (largest radius first — crescent faces need the smaller circle as
    # base with the bigger one as a hole, so try each)
    seen = []
    for cBig in sorted(circles, key=lambda c: -c[2])[:4]:
      c0 = np.array(cBig[:2])
      if any(np.hypot(c0[0] - s[0], c0[1] - s[1]) < 2 * tolFit
             and abs(cBig[2] - s[2]) < 2 * tolFit for s in seen):
        continue
      seen.append(cBig)
      conc = [c for c in circles
              if np.hypot(c[0] - c0[0], c[1] - c0[1]) < 2 * tolFit]
      radii = sorted({round(c[2], 6) for c in conc})
      rIn = radii[0] if len(radii) > 1 else 0.
      rest = [c for c in circles if c not in conc]
      baseOpts.append(dict(type='annulus', cx=float(c0[0]),
                           cy=float(c0[1]), rIn=float(rIn),
                           rOut=float(cBig[2]), circles=rest))
    rectL = _rectFromLines(lines, tolFit)
    if rectL is not None:
      baseOpts.append(dict(type='rect', circles=circles, **rectL))
    uLoE, uHiE = float(allUV[:, 0].min()), float(allUV[:, 0].max())
    baseOpts.append(dict(type='rect', cx=.5 * (uLoE + uHiE),
                         cy=.5 * (vLoE + vHiE), hx=.5 * (uHiE - uLoE),
                         hy=.5 * (vHiE - vLoE), ca=1., sa=0.,
                         circles=circles))
    # empty base: the whole face from ADD prims (e.g. an ellipse-rim disc)
    baseOpts.append(dict(type='rect', cx=0., cy=0., hx=0., hy=0.,
                         ca=1., sa=0., circles=circles))

  def primInside(h, x, y, z):
    isInv = h[0] > 15.5
    rem = h[0] - 20. if isInv else h[0]
    shape = rem - 10. if rem > 5.5 else rem
    dxp, dyp = x - h[1], y - h[2]
    xr = h[5] * dxp + h[6] * dyp
    yr = -h[6] * dxp + h[5] * dyp
    if shape == 6.:
      inP = x * h[1] + y * h[2] + z * h[3] >= h[4]
    elif shape == 5.:
      inP = (h[1] * x * x + h[2] * x * y + h[3] * y * y
             + h[4] * x + h[5] * y + h[6]) <= 0.
    elif shape == 4.:
      inP = yr <= h[3] * xr * xr + h[4] * xr
    elif shape == 3.:
      inP = dxp * h[3] + dyp * h[4] >= 0
    elif shape == 2.:
      inP = dxp * dxp + dyp * dyp <= h[3]
    else:
      inP = (np.abs(xr) <= h[3]) & (np.abs(yr) <= h[4])
    return ~inP if isInv else inP

  BIG = 1e7

  def shapeCands(srcLines, srcCircles):
    """Disc, strip, capped-rect, half-plane, poly2, conic and
    half-space candidates — discs also inverted (+20:
    keep-inside-the-arc booleans); conics carry their own both-sides
    variants by sign flip."""
    out = []
    for c in srcCircles:
      out.append((2., c[0], c[1], c[2] * c[2], 0., 0., 0.))
      out.append((22., c[0], c[1], c[2] * c[2], 0., 0., 0.))
    for A, Bc, C, D, E, F in conics:
      out.append((5., A, Bc, C, D, E, F))
      out.append((5., -A, -Bc, -C, -D, -E, -F))   # other side
    for n3, c3 in planes3d:
      out.append((6., float(n3[0]), float(n3[1]), float(n3[2]),
                  float(c3), 0., 0.))
      out.append((6., float(-n3[0]), float(-n3[1]), float(-n3[2]),
                  float(-c3), 0., 0.))
    for ctr, d, c2, c1 in poly2s:
      # both orientations: the region below the arc in (d, n) and in
      # (-d, -n) (which is the region above it)
      out.append((4., float(ctr[0]), float(ctr[1]), c2, c1,
                  float(d[0]), float(d[1])))
      out.append((4., float(ctr[0]), float(ctr[1]), -c2, c1,
                  float(-d[0]), float(-d[1])))
    for i in range(len(srcLines)):
      ni, ci, di, ctri, pi_ = srcLines[i]
      for j in range(i + 1, len(srcLines)):
        nj, cj, dj, ctrj, pj_ = srcLines[j]
        dotN = float(ni @ nj)
        if abs(abs(dotN) - 1.) > 1e-3:
          continue
        cjAli = cj * (1. if dotN > 0 else -1.)
        if abs(cjAli - ci) < 10 * tol:
          continue
        lo, hi = min(ci, cjAli), max(ci, cjAli)
        mid, half = .5 * (lo + hi), .5 * (hi - lo)
        d = np.array([-ni[1], ni[0]])
        allP = np.concatenate([pi_, pj_], axis=0)
        span = allP @ d
        cD = .5 * (float(span.min()) + float(span.max()))
        hD = .5 * (float(span.max()) - float(span.min()))
        center = mid * ni + cD * d
        # unbounded strip first, then the segment-capped rect; inverted
        # variants express boolean intersections (disc-cap rect etc.)
        out.append((1., float(center[0]), float(center[1]), BIG, half,
                    float(d[0]), float(d[1])))
        out.append((1., float(center[0]), float(center[1]), hD, half,
                    float(d[0]), float(d[1])))
        out.append((21., float(center[0]), float(center[1]), BIG, half,
                    float(d[0]), float(d[1])))
        out.append((21., float(center[0]), float(center[1]), hD, half,
                    float(d[0]), float(d[1])))
    for n, c, d, ctr, _p in srcLines:
      for sgn in (1., -1.):
        out.append((3., float(ctr[0]), float(ctr[1]),
                    float(sgn * n[0]), float(sgn * n[1]), 0., 0.))
    return out

  # --------------------------------------------- per-base greedy + validate
  for base in baseOpts:
    if base['type'] == 'band':
      inBase = (vs >= base['vLo']) & (vs <= base['vHi'])
      holeCircles = circles
      baseLines = lines
    elif base['type'] == 'annulus':
      rr = np.hypot(xs - base['cx'], ys - base['cy'])
      inBase = (rr >= base['rIn']) & (rr <= base['rOut'])
      holeCircles = base['circles']
      baseLines = lines
    else:
      ca, sa = base['ca'], base['sa']
      xr = ca * (xs - base['cx']) + sa * (ys - base['cy'])
      yr = -sa * (xs - base['cx']) + ca * (ys - base['cy'])
      inBase = (np.abs(xr) <= base['hx']) & (np.abs(yr) <= base['hy'])
      holeCircles = base['circles']

      def onRect(ln, base=base):
        n, c, d, ctr, _p = ln
        dr = (base['ca'] * d[0] + base['sa'] * d[1],
              -base['sa'] * d[0] + base['ca'] * d[1])
        cr = (base['ca'] * (ctr[0] - base['cx'])
              + base['sa'] * (ctr[1] - base['cy']),
              -base['sa'] * (ctr[0] - base['cx'])
              + base['ca'] * (ctr[1] - base['cy']))
        if abs(dr[1]) < 1e-3:        # runs along the rect x axis
          return abs(abs(cr[1]) - base['hy']) < 2 * tolFit
        if abs(dr[0]) < 1e-3:
          return abs(abs(cr[0]) - base['hx']) < 2 * tolFit
        return False
      baseLines = [ln for ln in lines if not onRect(ln)]

    # pass 1: ADD prims — regions outside the base that are occupied
    cands = shapeCands(baseLines, holeCircles)
    adds = []
    inBase2 = inBase
    for h in cands:
      sel = valid & ~inBase2 & primInside(h, xs, ys, zs)
      if sel.sum() < 8 or not occ[sel].all():
        dbg('  add rej flag', h[0], 'sel', int(sel.sum()),
            'occFrac', float(occ[sel].mean()) if sel.any() else -1.)
        continue
      adds.append((h[0] + 10.,) + tuple(h[1:]))
      inBase2 = inBase2 | primInside(h, xs, ys, zs)
    # pass 2: HOLE prims — regions inside base+adds that are empty
    holes = []
    covered = np.zeros(nSamples, dtype=bool)
    ok = True
    for h in cands:
      sel = valid & inBase2 & primInside(h, xs, ys, zs)
      if sel.sum() < 8 or occ[sel].any() or not (sel & ~covered).any():
        dbg('  hole rej flag', h[0], 'sel', int(sel.sum()),
            'occFrac', float(occ[sel].mean()) if sel.any() else -1.)
        continue
      holes.append(h)
      covered = covered | sel
      if len(holes) + len(adds) > maxPrims:
        ok = False
        break
    if not ok:
      dbg('base', base['type'], ': too many prims')
      continue
    inHole = np.zeros(nSamples, dtype=bool)
    for h in holes:
      inHole = inHole | primInside(h, xs, ys, zs)
    formula = inBase2 & ~inHole
    cmpMask = valid
    if base['type'] == 'band':
      # occupancy strictly beyond the boundary loops' own v-extent is a
      # seam/winding artifact of the sampled ground truth (a region can
      # only exceed its boundary's extent by containing a chart cap, which
      # the probeOcc snap detects): exclude those points from validation
      epsV = 2e-3 * vScale
      artifact = occ & (
          ((not base.get('snapHi', False)) & (vs > vHiE + epsV))
          | ((not base.get('snapLo', False)) & (vs < vLoE - epsV)))
      cmpMask = valid & ~artifact
    nm = int((formula[cmpMask] != occ[cmpMask]).sum())
    approx = ''
    if nm:
      # bounded relaxation: a handful of stragglers hugging the boundary
      # (sub-sample chamfers/fillets) are below the fidelity of the
      # 192-px bitmap this classification replaces
      mis = np.nonzero(cmpMask)[0][formula[cmpMask] != occ[cmpMask]]
      if nm <= max(4, cmpMask.sum() // 500) and distB[mis].max() < 8e-3:
        approx = ', ~1px approx'
      else:
        dbg('base', base['type'], ': validation mismatches', nm, 'of',
            int(cmpMask.sum()), 'adds', len(adds), 'holes', len(holes))
        dbg('   mismatch u', float(us[mis].min()), float(us[mis].max()),
            'v', float(vs[mis].min()), float(vs[mis].max()),
            'occFrac', float(occ[mis].mean()))
        dbg('   prims', [tuple(round(float(x), 3) for x in h)
                         for h in adds + holes])
        dbg('   lines', [(tuple(np.round(n, 3)), round(c, 3))
                         for n, c, _d, _ct, _p in lines])
        dbg('   circles', [tuple(round(float(x), 3) for x in c)
                           for c in circles])
        if base['type'] == 'rect':
          dbg('   rectbase',
              {k: (round(v, 3) if isinstance(v, float) else v)
               for k, v in base.items() if k != 'circles'})
        continue

    # ------------------------------------------------------------ encode
    prims = adds + holes
    if base['type'] == 'band':
      if not prims:
        return FaceResult([makeSurf((0., base['vLo'], base['vHi']))],
                          'band (prim-validated)')
      surf = makeSurf((3., base['vLo'], base['vHi']))
    elif base['type'] == 'annulus':
      fw = frameWorld @ T.translation(base['cx'], base['cy'], 0.)
      if not prims:
        return FaceResult(
            [makeSurf((0., base['rIn'], base['rOut']), frame=fw)],
            'disc/annulus (prim-validated)')
      surf = makeSurf((3., base['rIn'], base['rOut']), frame=fw)
      prims = _shiftPrims(prims, base['cx'], base['cy'], 1., 0.)
    else:
      ca, sa = base['ca'], base['sa']
      rotZ = np.eye(4)
      rotZ[0, 0], rotZ[0, 1] = ca, -sa
      rotZ[1, 0], rotZ[1, 1] = sa, ca
      fw = frameWorld @ T.translation(base['cx'], base['cy'], 0.) @ rotZ
      if not prims:
        return FaceResult(
            [makeSurf((1., base['hx'], base['hy']), frame=fw)],
            'rect (prim-validated)')
      surf = makeSurf((4., base['hx'], base['hy']), frame=fw)
      prims = _shiftPrims(prims, base['cx'], base['cy'], ca, sa)
    surf['trimPrims'] = dict(holes=[tuple(float(x) for x in h)
                                    for h in prims])
    return FaceResult(
        [surf],
        f"trim prims ({base['type']} + {len(adds)} - {len(holes)}{approx})")
  return None


def _rectFromLines(lines, tolFit):
  """Rectangle (possibly rotated) bounded by the fitted boundary lines:
  the TRUE rectangle of a boolean-cut face whose bbox is polluted by
  protruding tabs. Returns dict(cx, cy, hx, hy, ca, sa) or None."""
  if len(lines) < 3:
    return None
  spans = [float(np.linalg.norm(p2[-1] - p2[0]))
           for _n, _c, _d, _ctr, p2 in lines]
  a1 = lines[int(np.argmax(spans))][2]
  a2 = np.array([-a1[1], a1[0]])
  offs1, offs2 = [], []            # y' bounds (lines along a1), x' bounds
  for n, c, d, ctr, _p in lines:
    if abs(abs(float(d @ a1)) - 1.) < 1e-3:
      offs1.append(float(ctr @ a2))
    elif abs(abs(float(d @ a2)) - 1.) < 1e-3:
      offs2.append(float(ctr @ a1))
  if len(offs1) < 2 or len(offs2) < 2:
    return None
  yLo, yHi = min(offs1), max(offs1)
  xLo, xHi = min(offs2), max(offs2)
  if yHi - yLo < 4 * tolFit or xHi - xLo < 4 * tolFit:
    return None
  cx = .5 * (xLo + xHi) * a1 + .5 * (yLo + yHi) * a2
  return dict(cx=float(cx[0]), cy=float(cx[1]), hx=.5 * (xHi - xLo),
              hy=.5 * (yHi - yLo), ca=float(a1[0]), sa=float(a1[1]))


def _shiftPrims(prims, cx, cy, ca, sa):
  """Re-express prims in a recentered (cx, cy) + rotated (ca, sa) frame:
  positions rotate/translate; rect orientations and half-plane normals
  rotate by the inverse base rotation."""
  out = []
  for h in prims:
    flag = h[0]
    rem = flag - 20. if flag > 15.5 else flag
    shape = rem - 10. if rem > 5.5 else rem
    dx, dy = h[1] - cx, h[2] - cy
    px = ca * dx + sa * dy
    py = -sa * dx + ca * dy
    if shape == 6.:
      nx = ca * h[1] + sa * h[2]
      ny = -sa * h[1] + ca * h[2]
      cN = h[4] - (h[1] * cx + h[2] * cy)
      out.append((flag, nx, ny, h[3], cN, 0., 0.))
      continue
    if shape == 5.:
      # conic under x = ca x' - sa y' + cx, y = sa x' + ca y' + cy
      A, Bc, C, D, E, F = h[1:7]
      gx = 2 * A * cx + Bc * cy + D
      gy = Bc * cx + 2 * C * cy + E
      out.append((flag,
                  A * ca * ca + Bc * ca * sa + C * sa * sa,
                  -2 * A * ca * sa + Bc * (ca * ca - sa * sa)
                  + 2 * C * ca * sa,
                  A * sa * sa - Bc * ca * sa + C * ca * ca,
                  gx * ca + gy * sa,
                  -gx * sa + gy * ca,
                  A * cx * cx + Bc * cx * cy + C * cy * cy
                  + D * cx + E * cy + F))
      continue
    if shape == 3.:
      nx = ca * h[3] + sa * h[4]
      ny = -sa * h[3] + ca * h[4]
      out.append((flag, px, py, nx, ny, 0., 0.))
    elif shape == 2.:
      out.append((flag, px, py, h[3], 0., 0., 0.))
    else:                        # rect / poly2 / ellipse: rotate the frame
      ca2 = ca * h[5] + sa * h[6]
      sa2 = -sa * h[5] + ca * h[6]
      out.append((flag, px, py, h[3], h[4], ca2, sa2))
  return out



def _planeCircles(loops, frameWorld, makeSurf):
  '''Disc/annulus classification: every wire a circle in the plane, all
  concentric; the frame is recentered on the common center.'''
  infos = []
  for segs in loops:
    info = _circleLoopInfo(segs, frameWorld)
    if info is None:
      return None
    infos.append(info)
  if len(infos) > 2:
    return None
  centers = np.array([c for c, _r in infos])
  radii = sorted(r for _c, r in infos)
  scale = max(1., radii[-1])
  if len(infos) == 2 and np.linalg.norm(centers[0] - centers[1]) \
      > 1e-6 * scale:
    return None
  c = centers.mean(axis=0)
  fw = frameWorld @ T.translation(c[0], c[1], 0.)
  inner = radii[0] if len(radii) > 1 else 0.
  return FaceResult([makeSurf((0., inner, radii[-1]), frame=fw)],
                    'disc/annulus')


def _quadricZDomain(params):
  '''Natural z extent of a bounded quadric (exists iff the cross-section
  radicand qc z^2 + qz z + q0 <= 0 somewhere with qa, qb > 0), or None for
  unbounded kinds (cylinders, paraboloids, hyperboloids).'''
  qa, qb, qc, qz, q0 = params['coeffs']
  if qa <= 0 or qb <= 0 or qc <= 0:
    return None
  disc = qz * qz - 4 * qc * q0
  if disc <= 0:
    return None
  sq = math.sqrt(disc)
  return ((-qz - sq) / (2 * qc), (-qz + sq) / (2 * qc))


def _kindParams(kind, params):
  if kind == 'plane':
    return ()
  if kind == 'sphere':
    return (params['radius'],)
  if kind == 'cylinder':
    return (params['radius'],)
  if kind == 'cone':
    return (params['radius'], params['tanAngle'])
  if kind == 'asphere':
    return (params['curvature'], params.get('conic', 0.), 0., 0., 0.)
  if kind == 'quadric':
    return tuple(params['coeffs'])
  if kind == 'torus':
    return (params['majorRadius'], params['minorRadius'])
  raise ValueError(kind)


# ================================================================ tessellation

def _faceUVLoopsOcc(brep, faceTs, nSamples=96):
  '''Boundary loops in the surface's own OCC UV chart from the pcurves.'''
  surfIdx = faceTs.data['surf']
  uvLoops = []
  for wSign, wIdx, _wl in faceTs.refs:
    wire = brep.tshape(wIdx)
    if wire.shapeType != 'Wi':
      continue
    pts = []
    for eSign, eIdx, _el in wire.refs:
      edge = brep.tshape(eIdx)
      if edge.shapeType != 'Ed':
        continue
      pc = _edgePcurve(brep, edge, surfIdx)
      if pc is None:
        return None
      c2 = brep.curves2d[pc['curve2d'] - 1]
      t = np.linspace(pc['first'], pc['last'], nSamples)
      uv = evalCurve(c2, t, dim=2)
      if eSign < 0:
        uv = uv[::-1]
      pts.append((eSign, uv))
    if not pts:
      continue
    chained = _chainSegs(pts)
    loop = np.concatenate([seg for _sg, seg in chained
                           if isinstance(seg, np.ndarray)], axis=0)
    if wSign < 0:
      loop = loop[::-1]
    uvLoops.append(loop)
  return uvLoops


def _tessellateFace(brep, faceTs, rec, fullLoc, faceSign, elem,
                    tessRes, label):
  '''Triangulate an exact surface record over its UV-masked domain.'''
  uvLoops = _faceUVLoopsOcc(brep, faceTs)
  if not uvLoops:
    raise ValueError(f'face of type {rec["type"]} in {label!r} has no '
                     f'pcurves; cannot tessellate')
  if faceSign < 0:
    uvLoops = [loop[::-1] for loop in uvLoops]
  allUV = np.concatenate(uvLoops, axis=0)
  margin = 1e-9
  uw = (allUV[:, 0].min() - margin, allUV[:, 0].max() + margin)
  vw = (allUV[:, 1].min() - margin, allUV[:, 1].max() + margin)
  mask, u0, v0, du, dv = rasterizeLoops(uvLoops, uw, vw, tessRes)
  if not mask.any():
    mask = ~mask
  us = u0 + np.arange(tessRes + 1) * du
  vs = v0 + np.arange(tessRes + 1) * dv
  grid = evalSurface(rec, us, vs)            # (nv+1, nu+1, 3)
  grid = grid @ fullLoc[:3, :3].T + fullLoc[:3, 3]
  tris = []
  jj, ii = np.nonzero(mask)
  for j, i in zip(jj, ii):
    p00 = grid[j, i]
    p01 = grid[j, i + 1]
    p10 = grid[j + 1, i]
    p11 = grid[j + 1, i + 1]
    if faceSign >= 0:
      tris.append(S.triangle(p00, p01, p11, elem=elem))
      tris.append(S.triangle(p00, p11, p10, elem=elem))
    else:
      tris.append(S.triangle(p00, p11, p01, elem=elem))
      tris.append(S.triangle(p00, p10, p11, elem=elem))
  # drop degenerate (zero-area) cells, e.g. at poles
  out = []
  for tri in tris:
    v = np.asarray(tri['params'][:9]).reshape(3, 3)
    if np.linalg.norm(np.cross(v[1] - v[0], v[2] - v[0])) > 1e-12:
      out.append(tri)
  return FaceResult(out, f'tessellated {rec["type"]} ({len(out)} tris)')


# ==================================================================== frontend

def brepToSurfaces(text, elem, transform=None, maskRes=192, tessRes=48,
                   label=''):
  '''Parse a BRep blob and return (surfaces, notes): device surface dicts
  for every face of every root shape, with `transform` (object placement)
  composed in. Raises ValueError for blobs without usable topology.'''
  transform = np.eye(4) if transform is None else np.asarray(transform,
                                                             dtype=float)
  brep = parseBRep(text)
  if not brep.surfaces or not brep.tshapes:
    raise ValueError('BRep blob contains no surface geometry')
  faces = iterFaces(brep)
  if not faces:
    raise ValueError('BRep blob contains no faces')
  surfaces, notes = [], []
  for faceTs, accLoc, sign in faces:
    res = classifyFace(brep, faceTs, accLoc, sign, elem, transform,
                       maskRes=maskRes, tessRes=tessRes, label=label)
    surfaces.extend(res.surfaces)
    notes.append(res.note)
  return surfaces, notes
