'''
Synthetic FreeCAD project files for the ingest tests and the card's smoke
run: OpenCASCADE BRep ASCII blobs ("CASCADE Topology V1") and FCStd
archives (Document.xml plus the blobs), written with numpy, zipfile and
xml only. Neither package is imported here, so both ingest the same files.

BRep blobs are written as OpenCASCADE lays them out: the geometry sections
(Locations, Curve2ds, Curves, Surfaces) with their token layouts, then the
TShapes in post order (children first), each referenced by its position
counted 1-based from the end of the list, ending in the root reference.
Every face is bounded material-left in its surface's own UV chart: outer
wires counter-clockwise, holes clockwise, seams once each way, degenerate
pole edges with their pcurve only. Each edge carries its 3-D curve and a
pcurve on every face that uses it, with the 3-D curve's parameter range.

The fixture faces:
  * boxBlob: a box, six rectangles (the minimum faces REVERSED);
  * cylinderBlob: a band and two discs;
  * sphereBlob: a full sphere (a seam and two pole edges);
  * lensBlob: the lens of `benchmarks.buildLensMirrorScene` as one solid:
    the sphere cap R 60 over aperture 25, the barrel between the cap's rim
    and z = 6, the disc at z = 6;
  * platePolygonBlob: one plane face with polygon holes (a rectangular
    slot: SLOT_PLATE; a non-convex pentagon: IRREGULAR_PLATE);
  * paraboloidBlob: a surface of revolution with a parabola meridian.
A blob's `location` argument becomes its root location, written as type 1
records composed by a type 2 record (how FreeCAD stores a Part shape's
placement).
'''

import math
import os
import zipfile
from xml.sax.saxutils import quoteattr

import numpy as np

TWO_PI = 2. * math.pi
EX, EY, EZ = np.eye(3)

# the lens of buildLensMirrorScene (benchmarks.py): front radius, aperture,
# thickness, the cap's sag
LENS_R, LENS_APERTURE, LENS_THICKNESS = 60., 25., 6.
LENS_SAG = LENS_R - math.sqrt(LENS_R ** 2 - LENS_APERTURE ** 2)

# a 50 x 50 mm plate with a 4 x 30 mm slot through its centre, and one with
# a non-convex pentagon hole
SLOT_PLATE = dict(
    outer=[(-25., -25.), (25., -25.), (25., 25.), (-25., 25.)],
    holes=[[(-2., -15.), (2., -15.), (2., 15.), (-2., 15.)]])
IRREGULAR_PLATE = dict(
    outer=[(-25., -25.), (25., -25.), (25., 25.), (-25., 25.)],
    holes=[[(-12., -10.), (14., -6.), (3., 1.), (10., 13.), (-9., 8.)]])


def _f(x):
  return repr(float(x))


def _vec(v):
  return ' '.join(_f(x) for x in v)


def _unit(v):
  v = np.asarray(v, float)
  return v / np.linalg.norm(v)


def translation(x, y, z):
  m = np.eye(4)
  m[:3, 3] = (x, y, z)
  return m


def rotation(axis, angleDeg):
  '''4x4 rotation by `angleDeg` about `axis` (right-handed).'''
  a = _unit(axis)
  t = math.radians(angleDeg)
  K = np.array([[0., -a[2], a[1]], [a[2], 0., -a[0]], [-a[1], a[0], 0.]])
  m = np.eye(4)
  m[:3, :3] = np.eye(3) + math.sin(t) * K + (1. - math.cos(t)) * K @ K
  return m


# ================================================================ BRep writer

class BRepWriter:
  '''Accumulates the records of one BRep blob; `text(roots)` writes it.
  Geometry indices are 1-based in their section; shapes are handles (their
  position in creation order, which is post order).'''

  def __init__(self):
    self.locations, self.curves2d, self.curves, self.surfaces = [], [], [], []
    self.shapes = []          # [type, data, flags, refs]
    self.edges = {}           # handle -> dict(curve, first, last, pcurves)

  @staticmethod
  def _add(records, text):
    records.append(text)
    return len(records)

  # ---- locations
  def location(self, m):
    rows = np.asarray(m, float)[:3, :4]
    return self._add(self.locations, '1\n' + '\n'.join(
        '  ' + _vec(r) for r in rows))

  def composedLocation(self, pairs):
    '''A type 2 record: the product of (location index, power) pairs.'''
    return self._add(self.locations, '2  ' + ' '.join(
        f'{i} {p}' for i, p in pairs) + ' 0')

  # ---- curves and surfaces
  def line3(self, p, d):
    return self._add(self.curves, f'1 {_vec(p)} {_vec(d)}')

  def circle3(self, c, x, y, r):
    return self._add(self.curves, f'2 {_vec(c)} {_vec(np.cross(x, y))} '
                     f'{_vec(x)} {_vec(y)} {_f(r)}')

  @staticmethod
  def parabolaRecord(p, x, y, focal):
    return f'4 {_vec(p)} {_vec(np.cross(x, y))} {_vec(x)} {_vec(y)} ' \
        f'{_f(focal)}'

  def parabola3(self, p, x, y, focal):
    return self._add(self.curves, self.parabolaRecord(p, x, y, focal))

  def line2(self, p, d):
    return self._add(self.curves2d, f'1 {_vec(p)} {_vec(d)}')

  def circle2(self, c, x, y, r):
    return self._add(self.curves2d, f'2 {_vec(c)} {_vec(x)} {_vec(y)} '
                     f'{_f(r)}')

  def _frameSurface(self, code, P, X, Y, extra=()):
    Z = np.cross(X, Y)
    return self._add(self.surfaces, f'{code} {_vec(P)} {_vec(Z)} {_vec(X)} '
                     f'{_vec(Y)}' + ''.join(f' {_f(e)}' for e in extra))

  def plane(self, P, X, Y):
    return self._frameSurface(1, P, X, Y)

  def cylinder(self, P, X, Y, r):
    return self._frameSurface(2, P, X, Y, (r,))

  def sphere(self, P, X, Y, r):
    return self._frameSurface(4, P, X, Y, (r,))

  def revolution(self, p, d, basisRecord):
    return self._add(self.surfaces, f'7 {_vec(p)} {_vec(d)}\n{basisRecord}')

  # ---- topology
  def _shape(self, kind, data, flags, refs):
    self.shapes.append([kind, data, flags, refs])
    return len(self.shapes) - 1

  def vertex(self, p):
    return self._shape('Ve', f'1e-07\n{_vec(p)}\n0 0\n', '0101101', [])

  def edge(self, v1, v2, curve=None, first=0., last=1.):
    '''An edge from vertex v1 to v2 along 3-D curve `curve` over [first,
    last]; curve None makes a degenerate edge (a sphere's pole).'''
    h = self._shape('Ed', None, '0101000', [(+1, v1, 0), (-1, v2, 0)])
    self.edges[h] = dict(curve=curve, first=first, last=last, pcurves=[])
    return h

  def pcurve(self, edge, surf, c2d, c2dReversed=None):
    '''The edge's curve in the UV chart of surface `surf`; a seam edge of
    a closed surface has two, the first for its forward use.'''
    self.edges[edge]['pcurves'].append((surf, c2d, c2dReversed))

  def wire(self, edges):
    return self._shape('Wi', '', '0101100', [(s, e, 0) for s, e in edges])

  def face(self, surf, wires):
    return self._shape('Fa', f'0  1e-07 {surf} 0\n', '0111000',
                       [(+1, w, 0) for w in wires])

  def shell(self, faces):
    return self._shape('Sh', '', '0101100', [(s, f, 0) for s, f in faces])

  def solid(self, shells):
    return self._shape('So', '', '1100000', [(+1, s, 0) for s in shells])

  def _edgeData(self, h):
    e = self.edges[h]
    lines = [f' 1e-07 1 1 {0 if e["curve"] else 1}']
    rng = f'{_f(e["first"])} {_f(e["last"])}'
    if e['curve']:
      lines.append(f'1  {e["curve"]} 0 {rng}')
    for surf, c1, c2 in e['pcurves']:
      if c2 is None:
        lines.append(f'2  {c1} {surf} 0 {rng}')
      else:
        lines.append(f'3  {c1} {c2}C0 {surf} 0 {rng}')
    lines.append('0')
    return '\n'.join(lines) + '\n'

  def text(self, root, rootLoc=0):
    N = len(self.shapes)
    ref = lambda s, h, loc: f'{"+" if s > 0 else "-"}{N - h} {loc}'
    out = ['DBRep_DrawableShape', '',
           'CASCADE Topology V1, (c) Matra-Datavision']
    for name, records in (('Locations', self.locations),
                          ('Curve2ds', self.curves2d),
                          ('Curves', self.curves)):
      out.append(f'{name} {len(records)}')
      out.extend(records)
    out += ['Polygon3D 0', 'PolygonOnTriangulations 0',
            f'Surfaces {len(self.surfaces)}'] + self.surfaces
    out += ['Triangulations 0', '', f'TShapes {N}']
    for h, (kind, data, flags, refs) in enumerate(self.shapes):
      data = self._edgeData(h) if kind == 'Ed' else data
      out.append(f'{kind}\n{data}\n{flags}')
      out.append(' '.join(ref(*r) for r in refs) + (' *' if refs else '*'))
    out += ['', ref(+1, root, rootLoc), '']
    return '\n'.join(out)

  def rootLocation(self, m):
    '''`m` as the root location: two type 1 records, a translation by half
    of m's offset and the rest of m, composed by a type 2 record with the
    half-offset squared (m = T(off/2)^2 @ rotation part).'''
    m = np.asarray(m, float)
    half = translation(*(m[:3, 3] / 2.))
    rest = np.eye(4)
    rest[:3, :3] = m[:3, :3]
    a = self.location(half)
    b = self.location(rest)
    return self.composedLocation([(a, 2), (b, 1)])


# ================================================================ face kits

def _planeUV(P, X, Y, p):
  d = np.asarray(p, float) - P
  return np.array([d @ X, d @ Y])


class _PlanarSolid:
  '''Plane faces bounded by polygons, sharing vertices and line edges
  (each edge gets a pcurve on every face that uses it).'''

  def __init__(self, bw):
    self.bw = bw
    self.vertices = {}
    self.lineEdges = {}

  def vertexAt(self, p):
    key = tuple(np.round(np.asarray(p, float), 9))
    if key not in self.vertices:
      self.vertices[key] = (self.bw.vertex(p), np.asarray(p, float))
    return self.vertices[key]

  def lineEdge(self, a, b):
    key = frozenset((tuple(np.round(a, 9)), tuple(np.round(b, 9))))
    if key not in self.lineEdges:
      va, pa = self.vertexAt(a)
      vb, pb = self.vertexAt(b)
      d = pb - pa
      length = float(np.linalg.norm(d))
      h = self.bw.edge(va, vb, self.bw.line3(pa, d / length), 0., length)
      self.lineEdges[key] = (h, pa, d / length, length, va)
    return self.lineEdges[key]

  def face(self, P, X, Y, loops):
    '''A plane face at frame (P, X, Y) bounded by 3-D polygons `loops`
    (outer first, then holes), oriented here: outer counter-clockwise in
    the plane's UV, holes clockwise.'''
    bw = self.bw
    P, X, Y = (np.asarray(v, float) for v in (P, X, Y))
    surf = bw.plane(P, X, Y)
    wires = []
    for k, loop in enumerate(loops):
      loop = [np.asarray(p, float) for p in loop]
      uv = np.array([_planeUV(P, X, Y, p) for p in loop])
      area = 0.5 * float(np.sum(uv[:, 0] * np.roll(uv[:, 1], -1)
                                - np.roll(uv[:, 0], -1) * uv[:, 1]))
      if (area > 0) != (k == 0):
        loop = loop[::-1]
      uses = []
      for a, b in zip(loop, loop[1:] + loop[:1]):
        h, pa, d, length, va = self.lineEdge(a, b)
        if not any(s == surf for s, _c, _c2 in bw.edges[h]['pcurves']):
          bw.pcurve(h, surf, bw.line2(_planeUV(P, X, Y, pa),
                                      np.array([d @ X, d @ Y])))
        same = np.allclose(pa, a, atol=1e-9)
        uses.append((+1 if same else -1, h))
      wires.append(bw.wire(uses))
    return bw.face(surf, wires)


def boxBlob(L=10., W=18., H=40., location=None):
  '''A box [0, L] x [0, W] x [0, H]: six rectangles on planes whose
  normals point along +x, +y, +z; the faces at the minimum REVERSED, as
  OpenCASCADE builds a box.'''
  bw = BRepWriter()
  ps = _PlanarSolid(bw)
  c = lambda i, j, k: np.array([i * L, j * W, k * H])
  faces = []
  for axis in range(3):
    u, v = (axis + 1) % 3, (axis + 2) % 3
    X, Y = np.eye(3)[u], np.eye(3)[v]
    for side in (0, 1):
      def corner(a, b):
        idx = [0, 0, 0]
        idx[axis], idx[u], idx[v] = side, a, b
        return c(*idx)
      loop = [corner(0, 0), corner(1, 0), corner(1, 1), corner(0, 1)]
      f = ps.face(corner(0, 0), X, Y, [loop])
      faces.append((+1 if side else -1, f))
  return _finish(bw, bw.solid([bw.shell(faces)]), location)


def platePolygonBlob(outer, holes, location=None):
  '''One plane face in z = 0 bounded by polygon `outer` with polygon
  `holes` (lists of (x, y)).'''
  bw = BRepWriter()
  ps = _PlanarSolid(bw)
  lift = lambda pts: [np.array([x, y, 0.]) for x, y in pts]
  f = ps.face(np.zeros(3), EX, EY, [lift(outer)] + [lift(h) for h in holes])
  return _finish(bw, f, location)


def _finish(bw, root, location):
  loc = 0 if location is None else bw.rootLocation(location)
  return bw.text(root, loc)


def _band(bw, surfCyl, seamBottom, seamTop, h0, h1, radius, bottomEdge,
          topEdge):
  '''The lateral face of a cylinder (frame z axis, radius `radius`) between
  heights h0 and h1 bounded by full circles `bottomEdge` and `topEdge`
  (parameter = the cylinder's u); returns the face.'''
  seam = bw.edge(seamBottom, seamTop,
                 bw.line3(np.array([radius, 0., h0]), EZ), 0., h1 - h0)
  bw.pcurve(seam, surfCyl, bw.line2((TWO_PI, h0), (0., 1.)),
            bw.line2((0., h0), (0., 1.)))
  bw.pcurve(bottomEdge, surfCyl, bw.line2((0., h0), (1., 0.)))
  bw.pcurve(topEdge, surfCyl, bw.line2((0., h1), (1., 0.)))
  return bw.face(surfCyl, [bw.wire([(+1, bottomEdge), (+1, seam),
                                    (-1, topEdge), (-1, seam)])])


def _circleEdge(bw, vertex, centre, radius):
  '''A full circle about +z through `vertex` at angle 0.'''
  return bw.edge(vertex, vertex, bw.circle3(centre, EX, EY, radius), 0.,
                 TWO_PI)


def _disc(bw, circleEdge, z, radius):
  surf = bw.plane(np.array([0., 0., z]), EX, EY)
  bw.pcurve(circleEdge, surf, bw.circle2((0., 0.), (1., 0.), (0., 1.),
                                         radius))
  return bw.face(surf, [bw.wire([(+1, circleEdge)])])


def cylinderBlob(R=9., H=14., location=None):
  '''A solid cylinder about +z, radius R, z in [0, H]: the band and two
  discs (the bottom disc REVERSED).'''
  bw = BRepWriter()
  vb = bw.vertex((R, 0., 0.))
  vt = bw.vertex((R, 0., H))
  bottom = _circleEdge(bw, vb, np.zeros(3), R)
  top = _circleEdge(bw, vt, np.array([0., 0., H]), R)
  surfCyl = bw.cylinder(np.zeros(3), EX, EY, R)
  band = _band(bw, surfCyl, vb, vt, 0., H, R, bottom, top)
  discBottom = _disc(bw, bottom, 0., R)
  discTop = _disc(bw, top, H, R)
  shell = bw.shell([(+1, band), (-1, discBottom), (+1, discTop)])
  return _finish(bw, bw.solid([shell]), location)


def _sphereSeam(bw, surf, centre, R, vFrom, vTo, vertexFrom, vertexTo):
  '''The meridian seam of a sphere about +z (u = 0 / 2 pi) from latitude
  vFrom to vTo.'''
  seam = bw.edge(vertexFrom, vertexTo, bw.circle3(centre, EX, EZ, R), vFrom,
                 vTo)
  bw.pcurve(seam, surf, bw.line2((TWO_PI, 0.), (0., 1.)),
            bw.line2((0., 0.), (0., 1.)))
  return seam


def _pole(bw, surf, vertex, v):
  pole = bw.edge(vertex, vertex, None, 0., TWO_PI)
  bw.pcurve(pole, surf, bw.line2((0., v), (1., 0.)))
  return pole


def sphereBlob(R=20., location=None):
  '''A full sphere about the origin: one face bounded by its seam (once
  each way) and its two degenerate pole edges.'''
  bw = BRepWriter()
  surf = bw.sphere(np.zeros(3), EX, EY, R)
  south = bw.vertex((0., 0., -R))
  north = bw.vertex((0., 0., R))
  seam = _sphereSeam(bw, surf, np.zeros(3), R, -math.pi / 2, math.pi / 2,
                     south, north)
  pS = _pole(bw, surf, south, -math.pi / 2)
  pN = _pole(bw, surf, north, math.pi / 2)
  face = bw.face(surf, [bw.wire([(+1, pS), (+1, seam), (-1, pN),
                                 (-1, seam)])])
  return _finish(bw, bw.solid([bw.shell([(+1, face)])]), location)


def lensBlob(location=None):
  '''The lens of `benchmarks.buildLensMirrorScene` as one solid in its own
  frame: the sphere cap of radius LENS_R about (0, 0, LENS_R) from its
  apex at the origin to its rim at z = LENS_SAG, radius LENS_APERTURE; the
  barrel from the rim to z = LENS_THICKNESS; the disc there.'''
  bw = BRepWriter()
  R, a, T = LENS_R, LENS_APERTURE, LENS_THICKNESS
  centre = np.array([0., 0., R])
  vRim = math.asin((LENS_SAG - R) / R)
  surfS = bw.sphere(centre, EX, EY, R)
  apex = bw.vertex((0., 0., 0.))
  rimV = bw.vertex((a, 0., LENS_SAG))
  topV = bw.vertex((a, 0., T))
  rim = _circleEdge(bw, rimV, np.array([0., 0., LENS_SAG]), a)
  top = _circleEdge(bw, topV, np.array([0., 0., T]), a)
  # the cap: the apex pole, the seam up to the rim, the rim backwards
  seam = _sphereSeam(bw, surfS, centre, R, -math.pi / 2, vRim, apex, rimV)
  pole = _pole(bw, surfS, apex, -math.pi / 2)
  bw.pcurve(rim, surfS, bw.line2((0., vRim), (1., 0.)))
  cap = bw.face(surfS, [bw.wire([(+1, pole), (+1, seam), (-1, rim),
                                 (-1, seam)])])
  surfC = bw.cylinder(np.zeros(3), EX, EY, a)
  barrel = _band(bw, surfC, rimV, topV, LENS_SAG, T, a, rim, top)
  disc = _disc(bw, top, T, a)
  shell = bw.shell([(+1, cap), (+1, barrel), (+1, disc)])
  return _finish(bw, bw.solid([shell]), location)


def paraboloidBlob(focal=25., rMax=20., location=None):
  '''A dish: the surface of revolution about +z of the parabola z = r^2 /
  (4 focal) (a trimmed parabola record), from its vertex to the rim at r =
  rMax; bounded by the rim, the meridian seam and the vertex's degenerate
  edge.'''
  bw = BRepWriter()
  basis = f'8 0.0 {_f(rMax)}\n' + bw.parabolaRecord(np.zeros(3), EZ, EX,
                                                     focal)
  surf = bw.revolution(np.zeros(3), EZ, basis)
  zRim = rMax ** 2 / (4. * focal)
  apex = bw.vertex((0., 0., 0.))
  rimV = bw.vertex((rMax, 0., zRim))
  rim = _circleEdge(bw, rimV, np.array([0., 0., zRim]), rMax)
  bw.pcurve(rim, surf, bw.line2((0., rMax), (1., 0.)))
  seam = bw.edge(apex, rimV, bw.parabola3(np.zeros(3), EZ, EX, focal), 0.,
                 rMax)
  bw.pcurve(seam, surf, bw.line2((TWO_PI, 0.), (0., 1.)),
            bw.line2((0., 0.), (0., 1.)))
  pole = bw.edge(apex, apex, None, 0., TWO_PI)
  bw.pcurve(pole, surf, bw.line2((0., 0.), (1., 0.)))
  face = bw.face(surf, [bw.wire([(+1, pole), (+1, seam), (-1, rim),
                                 (-1, seam)])])
  return _finish(bw, face, location)


# a display triangulation only, without the CASCADE Topology V1 header (the
# layout geometry.mesh reads: nodes, UV nodes, triangles of one face)
BREP_TRIANGULATION_ONLY = '''DBRep_DrawableShape
Triangulations 1
4 2 1 0.01
-10 -10 0 10 -10 0 10 10 0 -10 10 0
0 0 1 0 1 1 0 1
1 2 3 1 3 4
'''


# ================================================================ FCStd writer

def _quaternion(m):
  '''(x, y, z, w) of the rotation part of 4x4 `m`.'''
  R = np.asarray(m, float)[:3, :3]
  w = math.sqrt(max(0., 1. + R[0, 0] + R[1, 1] + R[2, 2])) / 2.
  x = math.copysign(math.sqrt(max(0., 1. + R[0, 0] - R[1, 1] - R[2, 2])) / 2.,
                    R[2, 1] - R[1, 2])
  y = math.copysign(math.sqrt(max(0., 1. - R[0, 0] + R[1, 1] - R[2, 2])) / 2.,
                    R[0, 2] - R[2, 0])
  z = math.copysign(math.sqrt(max(0., 1. - R[0, 0] - R[1, 1] + R[2, 2])) / 2.,
                    R[1, 0] - R[0, 1])
  return x, y, z, w


def string(v):
  return ('App::PropertyString', f'<String value={quoteattr(str(v))}/>')


def floating(v, kind='App::PropertyFloat'):
  return (kind, f'<Float value="{_f(v)}"/>')


def integer(v):
  return ('App::PropertyInteger', f'<Integer value="{int(v)}"/>')


def boolean(v):
  return ('App::PropertyBool', f'<Bool value="{"true" if v else "false"}"/>')


def enumeration(value, choices):
  enums = ''.join(f'<Enum value={quoteattr(c)}/>' for c in choices)
  return ('App::PropertyEnumeration',
          f'<Integer value="{list(choices).index(value)}" '
          f'CustomEnum="true"/><CustomEnumList count="{len(choices)}">'
          f'{enums}</CustomEnumList>')


def vector(v):
  return ('App::PropertyVector', '<PropertyVector valueX="{}" valueY="{}" '
          'valueZ="{}"/>'.format(*(_f(x) for x in v)))


def placement(m):
  m = np.asarray(m, float)
  x, y, z, w = _quaternion(m)
  return ('App::PropertyPlacement',
          f'<PropertyPlacement Px="{_f(m[0, 3])}" Py="{_f(m[1, 3])}" '
          f'Pz="{_f(m[2, 3])}" Q0="{_f(x)}" Q1="{_f(y)}" Q2="{_f(z)}" '
          f'Q3="{_f(w)}"/>')


def link(name):
  return ('App::PropertyLink', f'<Link value={quoteattr(name)}/>')


def xlink(name, file=''):
  return ('App::PropertyXLink',
          f'<XLink file={quoteattr(file)} name={quoteattr(name)}/>')


def linkList(names):
  items = ''.join(f'<Link value={quoteattr(n)}/>' for n in names)
  return ('App::PropertyLinkList',
          f'<LinkList count="{len(names)}">{items}</LinkList>')


def linkSubList(entries):
  '''[(object name, [sub names])] as a PropertyLinkSubList.'''
  items = ''.join(
      f'<Link obj={quoteattr(o)} count="{len(subs)}">'
      + ''.join(f'<Sub value={quoteattr(s)}/>' for s in subs) + '</Link>'
      for o, subs in entries)
  return ('App::PropertyLinkSubList',
          f'<LinkSubList count="{len(entries)}">{items}</LinkSubList>')


def shape(file):
  return ('Part::PropertyPartShape', f'<Part file={quoteattr(file)}/>')


class Obj:
  '''One document object: its name, type and {property: (type, xml)}.'''

  def __init__(self, name, type_, label=None, **props):
    self.name, self.type = name, type_
    self.props = dict(Label=string(label or name), **props)


def documentXml(objects):
  lines = ["<?xml version='1.0' encoding='utf-8'?>",
           '<Document SchemaVersion="4" ProgramVersion="0.21" '
           'FileVersion="1">', '<Properties Count="0"/>',
           f'<Objects Count="{len(objects)}">']
  lines += [f'<Object type={quoteattr(o.type)} name={quoteattr(o.name)}/>'
            for o in objects]
  lines += ['</Objects>', f'<ObjectData Count="{len(objects)}">']
  for o in objects:
    lines.append(f'<Object name={quoteattr(o.name)}>')
    lines.append(f'<Properties Count="{len(o.props)}">')
    for key, (ptype, xml) in o.props.items():
      lines.append(f'<Property name={quoteattr(key)} type={quoteattr(ptype)}>'
                   f'{xml}</Property>')
    lines += ['</Properties>', '</Object>']
  lines += ['</ObjectData>', '</Document>', '']
  return '\n'.join(lines)


def writeFCStd(path, objects, blobs=None):
  '''Write an FCStd archive: Document.xml of `objects` and the shape blobs
  {zip member name: text}. Returns `path`.'''
  with zipfile.ZipFile(path, 'w', zipfile.ZIP_DEFLATED) as z:
    z.writestr('Document.xml', documentXml(objects))
    for name, text in (blobs or {}).items():
      z.writestr(name, text.encode('latin-1'))
  return path


# ============================================================ the workbench

_OPTICAL_TYPES = ('Mirror', 'Lens', 'Grating', 'Absorber', 'Vacuum')


def group(kind, members, label=None, at=None, **props):
  '''An Optical<kind>Group of the workbench (App::LinkGroupPython).'''
  return Obj(f'Optical{kind}Group' + props.pop('suffix', ''),
             'App::LinkGroupPython', label,
             OpticalType=enumeration(kind, _OPTICAL_TYPES),
             ElementList=linkList(members),
             **({} if at is None else dict(Placement=placement(at))),
             **props)


def pointSource(label='Source', at=None, **props):
  return Obj('OpticalPointSource' + props.pop('suffix', ''),
             'Part::FeaturePython', label,
             **({} if at is None else dict(Placement=placement(at))),
             **props)


def settings(label='OpticalSimulationSettings', **props):
  return Obj('OpticalSimulationSettings', 'Part::FeaturePython', label,
             **props)


def box(name, L, W, H, at):
  return Obj(name, 'Part::Box', Length=floating(L, 'App::PropertyLength'),
             Width=floating(W, 'App::PropertyLength'),
             Height=floating(H, 'App::PropertyLength'), Placement=placement(at))


def cylinder(name, R, H, at):
  return Obj(name, 'Part::Cylinder',
             Radius=floating(R, 'App::PropertyLength'),
             Height=floating(H, 'App::PropertyLength'), Placement=placement(at))


def feature(name, blobName, at=None, type_='Part::Feature', **props):
  '''A shape object whose evaluated BRep is the zip member `blobName`;
  its Placement (FreeCAD keeps it equal to the blob's root location).'''
  return Obj(name, type_, Shape=shape(blobName),
             Placement=placement(np.eye(4) if at is None else at), **props)


# ---- the lens-and-mirror project: buildLensMirrorScene as a project file

LENS_AT = translation(0., 0., 50.) @ rotation(EZ, 90.)
MIRROR_AT = translation(0., 0., 150.) @ rotation(EY, 45.)
DETECTOR_AT = translation(-101., -60., 90.)


def lensMirrorProject(folder, name='lens_mirror', raysPerIteration=1000000,
                      endAfterIterations='inf', maxIntersections=6):
  '''examples/2's scene as a project: the lens as one BRep solid whose
  root location is its placement (50 mm up the axis, turned 90 deg about
  it), a thin Part::Cylinder mirror (R 40) whose bottom disc is the built
  scene's fold mirror at 45 deg, a Part::Box detector whose +x face lies
  at x = -100 (120 x 120 mm), the Gaussian point source. Returns the path
  of `<folder>/<name>.FCStd`.'''
  objects = [
      feature('Lens', 'Lens.Shape.brp', at=LENS_AT),
      cylinder('Mirror', 40., 1., MIRROR_AT),
      box('DetectorBox', 1., 120., 120., DETECTOR_AT),
      group('Lens', ['Lens'], label='Lens',
            RefractiveIndex=floating(1.5)),
      group('Mirror', ['Mirror'], label='FoldMirror',
            Reflectivity=floating(0.98)),
      group('Absorber', ['DetectorBox'], label='Detector',
            RecordHits=boolean(True)),
      pointSource(PowerDensity=string('exp(-theta^2/0.02)'),
                  ThetaDomain=string('0, 0.35'), Wavelength=floating(532.),
                  ThetaResolutionNumericMode=string('2e4')),
      settings(RaysPerIteration=integer(raysPerIteration),
               MaxIntersections=integer(maxIntersections),
               EndAfterIterations=string(endAfterIterations),
               EndAfterRays=string('inf')),
  ]
  return writeFCStd(os.path.join(folder, f'{name}.FCStd'), objects,
                    {'Lens.Shape.brp': lensBlob(LENS_AT)})


# ---- the slotted-plate mirror: a plane face with a slot, over a sphere

SLOT_PLATE_AT = translation(0., 0., 50.)


def slotPlateProject(folder, name='slot_plate'):
  '''The slotted mirror of the trim tests as a project: SLOT_PLATE (a 50 x
  50 mm plane face with a 4 x 30 mm slot) 50 mm up the axis, a point
  source of exp(-theta^2/0.1) over [0, 0.45] at the origin, an absorbing
  Part::Sphere of radius 300 about it.'''
  objects = [
      feature('Plate', 'Plate.Shape.brp', at=SLOT_PLATE_AT,
              type_='Part::Cut'),
      Obj('Sphere', 'Part::Sphere',
          Radius=floating(300., 'App::PropertyLength'),
          Placement=placement(np.eye(4))),
      group('Mirror', ['Plate'], label='Slotted'),
      group('Absorber', ['Sphere'], label='Det', RecordHits=boolean(True)),
      pointSource(label='Src', PowerDensity=string('exp(-theta^2/0.1)'),
                  ThetaDomain=string('0, 0.45'), Wavelength=floating(532.),
                  ThetaResolutionNumericMode=string('1e4')),
      settings(RaysPerIteration=integer(1000000), MaxIntersections=integer(4)),
  ]
  return writeFCStd(os.path.join(folder, f'{name}.FCStd'), objects, {
      'Plate.Shape.brp': platePolygonBlob(location=SLOT_PLATE_AT,
                                          **SLOT_PLATE)})


# ---- examples/1 as a project

def sourceDetectorProject(folder, name='source_detector'):
  '''examples/1-source-and-detector as the reference's test describes its
  project: a Part::Box absorber 10 x 10 x 1 whose group sits at z = 50,
  a point source of exp(-theta^2/0.01) at 500 nm, 1e4 rays.'''
  objects = [
      box('Box', 10., 10., 1., translation(-5., -5., 0.)),
      group('Absorber', ['Box'], at=translation(0., 0., 50.),
            RecordHits=boolean(True)),
      pointSource(label='OpticalPointSource',
                  PowerDensity=string('exp(-theta^2/0.01)'),
                  Wavelength=floating(500.), ThetaDomain=string('0, pi/4'),
                  ThetaResolutionNumericMode=string('1e4')),
      settings(EndAfterRays=string('1e4'), RaysPerIteration=integer(1000),
               MaxIntersections=integer(4)),
  ]
  return writeFCStd(os.path.join(folder, f'{name}.FCStd'), objects)


# ---- containers, links, every source kind, booleans

def structureProject(folder, name='structure', replayFrom=''):
  '''Placement composition and every object kind the ingest reads:
    * an App::Part (placed) holding a visible Part::Sphere and an invisible
      Part::Box, in a mirror group;
    * App::Links to a placed Part::Cylinder, one with LinkTransform false
      (its placement replaces the target's) and one with it true
      (composes), in a lens group, and the target itself in a vacuum group
      that an App::Link places a second time;
    * Part::Feature / Part::Cut members with BRep blobs (box, cylinder,
      sphere, paraboloid, the irregular plate) in an absorber group placed
      at z = -30;
    * an OpticalSurfaceSource on Face1 and Face3 of a Part::Box, an
      OpticalPointSource inside another App::Part (placed through it), an
      OpticalReplaySource, and settings.'''
  rot = translation(5., -3., 2.) @ rotation((1., 2., 3.), 35.)
  objects = [
      Obj('Sphere', 'Part::Sphere', Radius=floating(7., 'App::PropertyLength'),
          Placement=placement(translation(0., 0., 20.))),
      Obj('HiddenBox', 'Part::Box', Length=floating(4.), Width=floating(4.),
          Height=floating(4.), Visibility=boolean(False),
          Placement=placement(translation(1., 1., 1.))),
      Obj('Part', 'App::Part', Group=linkList(['Sphere', 'HiddenBox']),
          Placement=placement(translation(10., 0., 0.) @ rotation(EZ, 30.))),
      Obj('Holder', 'App::Part', Group=linkList(['OpticalPointSource']),
          Placement=placement(translation(0., 4., -8.) @ rotation(EX, 10.))),
      cylinder('Rod', 3., 12., translation(0., 20., 0.) @ rotation(EX, 90.)),
      Obj('LinkPlaced', 'App::Link', LinkedObject=link('Rod'),
          LinkTransform=boolean(False),
          Placement=placement(translation(-20., 0., 5.))),
      Obj('LinkComposed', 'App::Link', LinkedObject=link('Rod'),
          LinkTransform=boolean(True),
          Placement=placement(translation(0., -15., 0.) @ rotation(EY, 20.))),
      feature('BoxShape', 'BoxShape.Shape.brp', at=rot),
      feature('CylShape', 'CylShape.Shape.brp'),
      feature('SphereShape', 'SphereShape.Shape.brp',
              at=translation(0., 0., -40.)),
      feature('Dish', 'Dish.Shape.brp', type_='Part::Revolution'),
      feature('Holey', 'Holey.Shape.brp', type_='Part::Cut',
              at=translation(0., 0., 60.)),
      box('Emitter', 6., 6., 2., translation(-3., -3., -60.)),
      group('Mirror', ['Part'], label='Mirrors',
            GratingLinesOrientation=vector((0., 1., 0.))),
      group('Lens', ['LinkPlaced', 'LinkComposed'], label='Lenses',
            RefractiveIndex=floating(1.6)),
      group('Vacuum', ['Rod'], label='RodItself',
            at=translation(0., 0., 3.)),
      Obj('GroupLink', 'App::Link', LinkedObject=link('OpticalVacuumGroup'),
          Placement=placement(translation(40., 0., 0.))),
      group('Absorber', ['BoxShape', 'CylShape', 'SphereShape', 'Dish',
                         'Holey'], label='Shapes', at=translation(0., 0., -30.),
            RecordHits=boolean(True)),
      pointSource(label='PartSource', at=translation(0., 0., -5.),
                  PowerDensity=string('exp(-theta^2/0.05)'),
                  ThetaDomain=string('0, 0.4'), Wavelength=floating(600.)),
      Obj('OpticalSurfaceSource', 'Part::FeaturePython', 'Glow',
          ActiveSurfaces=linkSubList([('Emitter', ['Face1', 'Face3'])]),
          PowerDensity=string('cos(theta)**2'), Wavelength=floating(450.)),
      Obj('OpticalReplaySource', 'Part::FeaturePython', 'Replay',
          ReplayFromDir=string(replayFrom), Wavelength=floating(510.),
          Placement=placement(translation(0., 0., 7.))),
      settings(RaysPerIteration=integer(5000), MaxIntersections=integer(8),
               EnableStoreSingleShotData=boolean(True)),
  ]
  blobs = {
      'BoxShape.Shape.brp': boxBlob(location=rot),
      'CylShape.Shape.brp': cylinderBlob(),
      'SphereShape.Shape.brp': sphereBlob(location=translation(0., 0., -40.)),
      'Dish.Shape.brp': paraboloidBlob(),
      'Holey.Shape.brp': platePolygonBlob(location=translation(0., 0., 60.),
                                          **IRREGULAR_PLATE),
  }
  return writeFCStd(os.path.join(folder, f'{name}.FCStd'), objects, blobs)


def externalProjects(folder, withExternal=True):
  '''A host project whose mirror group holds App::Links to an App::Part of
  another document (a cross-document XLink), twice at two placements, and
  an external document that holds the Part (a BRep box in it) and an
  absorber group of its own. withExternal=False leaves the external file
  out (the host must load what it can). Returns the host's path.'''
  ext = [
      feature('Cube', 'Cube.Shape.brp'),
      Obj('Part', 'App::Part', Group=linkList(['Cube']),
          Placement=placement(translation(0., 0., 80.))),
      Obj('Plate', 'Part::Box', Length=floating(30.), Width=floating(30.),
          Height=floating(1.), Placement=placement(translation(-15., -15.,
                                                               200.))),
      group('Absorber', ['Plate'], label='ExtDetector',
            RecordHits=boolean(True)),
  ]
  if withExternal:
    writeFCStd(os.path.join(folder, 'external.FCStd'), ext,
               {'Cube.Shape.brp': boxBlob(8., 8., 8.)})
  host = [
      Obj('LinkA', 'App::Link', LinkedObject=xlink('Part', 'external.FCStd'),
          Placement=placement(translation(-10., 0., 0.))),
      Obj('LinkB', 'App::Link', LinkedObject=xlink('Part', 'external.FCStd'),
          LinkTransform=boolean(True),
          Placement=placement(translation(10., 0., 0.))),
      Obj('Part002', 'Part::Sphere', Radius=floating(3.),
          Placement=placement(translation(0., 0., 40.))),
      group('Mirror', ['LinkA', 'LinkB', 'Part002'], label='linkedMirrors'),
      pointSource(PowerDensity=string('exp(-theta^2/0.02)'),
                  ThetaDomain=string('0, 0.3')),
      settings(RaysPerIteration=integer(2000)),
  ]
  return writeFCStd(os.path.join(folder, 'host.FCStd'), host)


def unsupportedProject(folder, name='unsupported'):
  '''A mirror group whose one member is a Part::Feature whose blob is
  neither a CASCADE Topology V1 BRep nor a stored triangulation, beside a
  plain Part::Box absorber.'''
  objects = [
      feature('Mystery', 'Mystery.Shape.brp', type_='PartDesign::Body'),
      box('Box', 10., 10., 1., translation(-5., -5., 50.)),
      group('Mirror', ['Mystery'], label='Broken'),
      group('Absorber', ['Box'], label='Det', RecordHits=boolean(True)),
      pointSource(),
      settings(),
  ]
  return writeFCStd(os.path.join(folder, f'{name}.FCStd'), objects,
                    {'Mystery.Shape.brp': 'not a shape at all\n'})
