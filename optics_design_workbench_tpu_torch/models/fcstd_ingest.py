'''
FCStd scene ingest — load the reference workbench's project files directly,
without FreeCAD.

An FCStd file is a zip containing Document.xml with every object's typed
properties. The workbench's own objects (OpticalPointSource /
Optical*Group / OpticalSimulationSettings, created by the reference's
GenericMakeFreecadElement, common.py:332-356) carry all their optics
properties right in the XML, and elementary Part geometry
(Part::Box/Sphere/Cylinder) carries its dimensions — enough to rebuild the
scene as analytic surfaces. Placements compose through App::Part containers
and App::Link instances (multi-placement semantics, common.py:36-109).

Geometry built from sketches/booleans (Part::Cut, Part::Revolution,
PartDesign bodies...) exists only as OpenCASCADE BRep blobs; rebuilding
the exact analytic surfaces would need an OCC kernel, but FreeCAD usually
embeds the display triangulation in the blob — those members load as
triangle meshes (geometry/mesh.py parseBRepTriangulations). Members with
neither a primitive type nor a stored triangulation raise (or are skipped
with `skipUnsupported=True`) with a pointer to the models/mesh APIs.
'''

import io as _io
import os
import xml.etree.ElementTree as ET
import zipfile

import numpy as np

from ..geometry import surfaces as S
from ..utils import io
from .scene import Scene
from .settings import SimulationSettings
from .optical_group import OpticalGroup, OPTICAL_TYPES
from .point_source import PointSource
from .surface_source import SurfaceSource
from .replay_source import ReplaySource


def _quatToMatrix(px, py, pz, q0, q1, q2, q3):
  '''FreeCAD placement quaternion (x, y, z, w) + position -> 4x4.'''
  x, y, z, w = q0, q1, q2, q3
  n = x * x + y * y + z * z + w * w
  s = 0. if n == 0 else 2. / n
  R = np.array([
      [1 - s * (y * y + z * z), s * (x * y - w * z), s * (x * z + w * y)],
      [s * (x * y + w * z), 1 - s * (x * x + z * z), s * (y * z - w * x)],
      [s * (x * z - w * y), s * (y * z + w * x), 1 - s * (x * x + y * y)],
  ])
  m = np.eye(4)
  m[:3, :3] = R
  m[:3, 3] = (px, py, pz)
  return m


def _parseProperty(prop):
  '''Parse one <Property> element into a python value.'''
  ptype = prop.get('type', '')
  children = list(prop)
  if not children:
    return None
  c = children[0]
  if ptype in ('App::PropertyString', 'App::PropertyEnumeration'):
    if ptype == 'App::PropertyEnumeration':
      # the CustomEnumList is a sibling of the value element
      enums = [e.get('value') for e in prop.iter('Enum')]
      try:
        idx = int(c.get('value'))
        if enums and 0 <= idx < len(enums):
          return enums[idx]
        return idx
      except (TypeError, ValueError):
        return c.get('value')
    return c.get('value')
  if ptype in ('App::PropertyFloat', 'App::PropertyLength',
               'App::PropertyAngle', 'App::PropertyDistance',
               'App::PropertyQuantity'):
    return float(c.get('value'))
  if ptype == 'App::PropertyInteger':
    return int(c.get('value'))
  if ptype == 'App::PropertyBool':
    return c.get('value') in ('true', 'True', '1')
  if ptype == 'App::PropertyVector':
    return (float(c.get('valueX', 0)), float(c.get('valueY', 0)),
            float(c.get('valueZ', 0)))
  if ptype == 'App::PropertyPlacement':
    return _quatToMatrix(*(float(c.get(k, 0)) for k in
                           ('Px', 'Py', 'Pz', 'Q0', 'Q1', 'Q2', 'Q3')))
  if ptype in ('App::PropertyLink',):
    return c.get('value') or None
  if ptype in ('App::PropertyXLink', 'App::PropertyXLinkSub'):
    # <XLink file="" name="Obj"/> — in-document cross link;
    # <XLink file="other.FCStd" name="Obj"/> — cross-DOCUMENT link,
    # namespaced as 'other.FCStd#Obj' and resolved by _mergeExternal
    # (reference: find._allObjects walks linked external documents,
    # find.py:24-56)
    name = c.get('name') or c.get('value') or None
    file = c.get('file')
    if name and file:
      return f'{file}#{name}'
    return name
  if ptype == 'Part::PropertyPartShape':
    # the BRep blob lives in a sibling zip entry; keep its name so the
    # loader can extract a stored triangulation from it
    return c.get('file') or None
  if ptype in ('App::PropertyLinkList', 'App::PropertyLinkListHidden'):
    return [e.get('value') for e in c if e.get('value')]
  if ptype == 'App::PropertyLinkSubList':
    out = []
    for e in c:
      obj = e.get('obj') or e.get('value')
      subs = [sub.get('value') for sub in e if sub.get('value')]
      out.append((obj, subs))
    return out
  return None


class _FcObject:
  def __init__(self, name, type_):
    self.name = name
    self.type = type_
    self.props = {}
    self.label = name

  def get(self, key, default=None):
    return self.props.get(key, default)


def parseDocumentXml(xmlBytes):
  '''Parse Document.xml into {name: _FcObject}.'''
  root = ET.parse(_io.BytesIO(xmlBytes)).getroot()
  objects = {}
  for obj in root.iter('Object'):
    name, type_ = obj.get('name'), obj.get('type')
    if name and type_ and name not in objects:
      objects[name] = _FcObject(name, type_)
  # ObjectData section repeats Object elements with Properties
  for obj in root.iter('Object'):
    name = obj.get('name')
    if name not in objects:
      continue
    for prop in obj.iter('Property'):
      val = _parseProperty(prop)
      if val is not None:
        objects[name].props[prop.get('name')] = val
  for o in objects.values():
    o.label = o.get('Label', o.name)
  return objects


def _mergeExternal(objects, blobs, baseDir, _depth=0):
  '''Load FCStd documents referenced by cross-document XLinks
  ('file.FCStd#name' values, _parseProperty) and merge their objects and
  shape blobs into the host dicts under 'file.FCStd#'-prefixed keys, so
  container/link/geometry resolution works uniformly across document
  boundaries. Mirrors the reference, whose find._allObjects walks the
  host document PLUS every linked external document (find.py:24-56) —
  which also means optical groups and sources living in an external
  document are simulated (nested-structure.FCStd in the reference CI
  keeps its lens boolean in external-file2.FCStd). Internal references
  of an external document are prefixed too: object names are only unique
  per document ("Part002" exists in both test/22 files).'''
  if _depth > 8:
    raise RuntimeError('external-document recursion depth exceeded')
  refs = set()

  def scan(v):
    if isinstance(v, str) and '#' in v \
        and v.split('#', 1)[0].lower().endswith('.fcstd'):
      refs.add(v.split('#', 1)[0])
    elif isinstance(v, (list, tuple)):
      for x in v:
        scan(x)

  for o in objects.values():
    for k, v in o.props.items():
      if k != 'Label':
        scan(v)
  merged = False
  for f in sorted(refs):
    pre = f + '#'
    if any(k.startswith(pre) for k in objects):
      continue                                    # already merged
    p = os.path.join(baseDir, f)
    if not os.path.exists(p):
      io.warn(f'external document {f!r} not found next to the host '
              f'FCStd; its cross-document links stay unresolved')
      continue
    with zipfile.ZipFile(p) as z:
      extXml = z.read('Document.xml')
      extBlobs = {n: z.read(n) for n in z.namelist()
                  if n.endswith('.brp') or 'Shape' in n}
    ext = parseDocumentXml(extXml)
    extNames = set(ext)
    blobNames = set(extBlobs)

    def rewrite(v):
      if isinstance(v, str):
        return pre + v if (v in extNames or v in blobNames) else v
      if isinstance(v, list):
        return [rewrite(x) for x in v]
      if isinstance(v, tuple):
        return tuple(rewrite(x) for x in v)
      return v

    for name, o in ext.items():
      o.name = pre + name
      o.props = {k: (v if k == 'Label' else rewrite(v))
                 for k, v in o.props.items()}
      objects[o.name] = o
    for bn, data in extBlobs.items():
      blobs[pre + bn] = data
    merged = True
    io.verb(f'merged external document {f!r}: {len(ext)} objects')
  if merged:
    # external documents may themselves link further documents
    # (resolved relative to the SAME directory, like FreeCAD does for
    # sibling project files)
    _mergeExternal(objects, blobs, baseDir, _depth + 1)


# ------------------------------------------------------- geometry conversion

def _boxSurfaces(obj, elem):
  L = float(obj.get('Length', 10.))
  W = float(obj.get('Width', 10.))
  H = float(obj.get('Height', 10.))
  placement = obj.get('Placement', np.eye(4))
  cx, cy, cz = L / 2, W / 2, H / 2
  from ..geometry import transforms as T
  faces = [
      # (+z, -z) faces
      (T.compose(T.translation(cx, cy, H)), (cx, cy), +1),
      (T.compose(T.translation(cx, cy, 0), T.rotation((1, 0, 0), 180)),
       (cx, cy), +1),
      # (+x, -x)
      (T.compose(T.translation(L, cy, cz), T.rotation((0, 1, 0), 90)),
       (cz, cy), +1),
      (T.compose(T.translation(0, cy, cz), T.rotation((0, 1, 0), -90)),
       (cz, cy), +1),
      # (+y, -y)
      (T.compose(T.translation(cx, W, cz), T.rotation((1, 0, 0), -90)),
       (cx, cz), +1),
      (T.compose(T.translation(cx, 0, cz), T.rotation((1, 0, 0), 90)),
       (cx, cz), +1),
  ]
  return [S.plane(placement @ m, elem=elem, halfExtents=he, orient=orient)
          for m, he, orient in faces]


def _sphereSurfaces(obj, elem):
  R = float(obj.get('Radius', 5.))
  placement = obj.get('Placement', np.eye(4))
  return [S.sphere(placement, elem=elem, radius=R, orient=+1)]


def _cylinderSurfaces(obj, elem):
  R = float(obj.get('Radius', 2.))
  H = float(obj.get('Height', 10.))
  placement = obj.get('Placement', np.eye(4))
  from ..geometry import transforms as T
  return [
      S.cylinder(placement, elem=elem, radius=R, zRange=(0., H), orient=+1),
      S.plane(placement @ T.translation(0, 0, H), elem=elem, radius=R,
              orient=+1),
      S.plane(placement @ T.compose(T.translation(0, 0, 0),
                                    T.rotation((1, 0, 0), 180)),
              elem=elem, radius=R, orient=+1),
  ]


_GEOMETRY_BUILDERS = {
    'Part::Box': _boxSurfaces,
    'Part::Sphere': _sphereSurfaces,
    'Part::Cylinder': _cylinderSurfaces,
}

_SKIP_TYPES = ('App::Origin', 'App::Line', 'App::Plane',
               'App::Point', 'Sketcher::SketchObject')


def _brepAnalytic(member, elem, readBlob, label):
  '''Exact analytic surfaces (+ per-face tessellation fallbacks) from an
  object's stored BRep blob (geometry/brep.py). Returns None when the
  object carries no shape blob.'''
  shapeFile = member.get('Shape')
  if not isinstance(shapeFile, str) or readBlob is None:
    return None
  try:
    text = readBlob(shapeFile).decode('latin-1')
  except KeyError:
    return None
  from ..geometry import brep as B
  # NOTE: FreeCAD saves Part shapes WITH their placement baked in as the
  # BRep root location (verified: Cut.Shape.brp root loc == Cut.Placement),
  # so the member placement must NOT be applied again here
  surfs, notes = B.brepToSurfaces(text, elem=elem, transform=np.eye(4),
                                  label=member.label)
  nAna = sum(1 for s in surfs if s['kind'] != S.TRIANGLE)
  nTri = len(surfs) - nAna
  io.verb(f'{member.label!r} ({member.type}): {nAna} analytic faces'
          + (f' + {nTri} fallback triangles' if nTri else ''))
  return surfs


def _brepMesh(member, elem, readBlob, label):
  '''Mesh surfaces from a stored BRep display triangulation
  (geometry/mesh.py); None when the object carries no shape blob.'''
  shapeFile = member.get('Shape')
  if not isinstance(shapeFile, str) or readBlob is None:
    return None
  try:
    text = readBlob(shapeFile).decode('latin-1')
  except KeyError:
    return None
  from ..geometry import mesh as M
  placement = member.get('Placement', np.eye(4))
  return M.brepMeshSurfaces(text, elem=elem, transform=placement)


_CONTAINER_TYPES = ('App::Part', 'App::LinkGroup', 'App::LinkGroupPython',
                    'App::DocumentObjectGroup', 'PartDesign::Body')

_PLACEMENT_CONTAINERS = ('App::Part', 'App::DocumentObjectGroup',
                         'App::LinkGroup')


def _groupChildren(obj):
  '''Names claimed by a container: Group for containers, ElementList for
  link groups.'''
  out = list(obj.get('Group', []) or [])
  out += list(obj.get('ElementList', []) or [])
  return out


def allPlacementsAndPaths(objects, name, ignoreLinks=False, _depth=0):
  '''Every global placement of object `name`, resolved through nested
  containers (App::Part / DocumentObjectGroup) and App::Link instances —
  one object can exist at several global transforms (reference:
  common.py:36-109; CI-asserted as 8 exact matrices for test/22's
  ShiftedCube). Returns [(4x4 matrix, "dot.path")]. Semantics validated
  against the reference fixture:
    * a container parent contributes parentGlobal @ ownPlacement;
    * a DocumentObjectGroup carries no placement (transparent);
    * App::Link with LinkTransform=False REPLACES the target's own
      placement by the link's, True composes link @ target;
    * transitively-duplicated container parents (a Part lists the members
      of a group nested inside it) are resolved to the DEEPEST parent so
      each physical path is counted once.'''
  if _depth > 64:
    raise RuntimeError('placement recursion depth exceeded')
  obj = objects[name]
  own = np.asarray(obj.get('Placement', np.eye(4)), dtype=float)

  parents = [p for p in objects.values()
             if p.type in _PLACEMENT_CONTAINERS
             and name in _groupChildren(p)]
  # drop a parent that also (transitively) contains another parent of ours:
  # its listing is the transitive duplicate
  def containsTransitively(a, b, seen=None):
    seen = seen or set()
    if a.name in seen:
      return False
    seen.add(a.name)
    kids = _groupChildren(a)
    if b.name in kids:
      return True
    return any(containsTransitively(objects[k], b, seen) for k in kids
               if k in objects
               and objects[k].type in _PLACEMENT_CONTAINERS)
  parents = [p for p in parents
             if not any(q is not p and containsTransitively(p, q)
                        for q in parents)]

  results = []
  if not parents:
    results.append((own, name))
  for p in parents:
    for gp, path in allPlacementsAndPaths(objects, p.name,
                                          ignoreLinks=ignoreLinks,
                                          _depth=_depth + 1):
      results.append((gp @ own, f'{path}.{name}'))

  if not ignoreLinks:
    for link in objects.values():
      if link.type != 'App::Link' or link.get('LinkedObject') != name:
        continue
      for gl, path in allPlacementsAndPaths(objects, link.name,
                                            _depth=_depth + 1):
        if link.get('LinkTransform', False):
          results.append((gl @ own, f'{path}.{name}'))
        else:
          results.append((gl, f'{path}.{name}'))
  return sorted(results, key=lambda e: e[1])


def _collectGeometry(objects, memberNames, elem, label, skipUnsupported,
                     readBlob=None, _depth=0):
  '''Resolve member objects to device surfaces, mirroring how FreeCAD
  resolves an optical group's compound shape (reference: ray.py:342 uses
  cachedShape(group); App::Part containers contribute their VISIBLE
  children recursively, App::Links their target at the link placement,
  booleans/bodies their stored evaluated BRep).'''
  if _depth > 32:
    raise RuntimeError('containment recursion depth exceeded')
  surfs = []
  for name in memberNames:
    member = objects.get(name)
    if member is None:
      continue
    if member.type in _SKIP_TYPES:
      continue
    if member.type == 'App::Link':
      targetName = member.get('LinkedObject')
      target = objects.get(targetName) if isinstance(targetName, str) \
          else None
      if target is not None:
        linkPlacement = member.get('Placement', np.eye(4))
        inner = _collectGeometry(objects, [target.name], elem, label,
                                 skipUnsupported, readBlob, _depth + 1)
        # LinkTransform=False (default): the link's own placement REPLACES
        # the target's placement
        if not member.get('LinkTransform', False):
          targetPlacement = target.get('Placement', np.eye(4))
          linkPlacement = linkPlacement @ np.linalg.inv(targetPlacement)
        for s in inner:
          s['transform'] = linkPlacement @ s['transform']
        surfs.extend(inner)
      continue
    if member.type == 'App::Part' or (
        member.type in _CONTAINER_TYPES and not member.get('Shape')):
      # container: visible children, placed by the container's placement
      children = [n for n in member.get('Group', [])
                  if objects.get(n) is not None
                  and objects[n].get('Visibility', True)]
      inner = _collectGeometry(objects, children, elem, label,
                               skipUnsupported, readBlob, _depth + 1)
      placement = member.get('Placement', np.eye(4))
      for s in inner:
        s['transform'] = placement @ s['transform']
      surfs.extend(inner)
      continue
    builder = _GEOMETRY_BUILDERS.get(member.type)
    if builder is not None:
      surfs.extend(builder(member, elem))
      continue
    # anything else with a shape blob (booleans, bodies, pads, scaled
    # shapes, Part::Feature...): exact analytic BRep ingestion, falling
    # back to the stored display triangulation, then to error/skip
    errs = []
    for attempt in (_brepAnalytic, _brepMesh):
      try:
        got = attempt(member, elem, readBlob, label)
      except Exception as e:
        errs.append(f'{attempt.__name__}: {e}')
        continue
      if got:
        surfs.extend(got)
        break
      errs.append(f'{attempt.__name__}: no shape blob')
    else:
      msg = (f'cannot rebuild geometry of {member.label!r} '
             f'({member.type}) in optical group {label!r}: not an '
             f'elementary Part primitive and its BRep could not be '
             f'ingested ({"; ".join(errs)}). Build this element with the '
             f'models API (geometry.surfaces / geometry.mesh) instead.')
      if skipUnsupported:
        io.warn(msg)
        continue
      raise NotImplementedError(msg)
  return surfs


def loadFCStd(path, skipUnsupported=False):
  '''Load an FCStd project of the reference workbench into a Scene.

  Geometry sources, in order of fidelity: elementary Part primitives
  (Box/Sphere/Cylinder) rebuild as exact analytic surfaces; any other
  solid (booleans, pads, sketch-based shapes) loads as a triangle mesh
  from the BRep blob's stored triangulation when FreeCAD saved one
  (geometry/mesh.py); otherwise it raises (or is skipped with
  skipUnsupported=True) with a pointer to the models/mesh APIs.'''
  with zipfile.ZipFile(path) as z:
    xmlBytes = z.read('Document.xml')
    blobs = {n: z.read(n) for n in z.namelist()
             if n.endswith('.brp') or 'Shape' in n}

  def readBlob(name):
    return blobs[name]

  objects = parseDocumentXml(xmlBytes)
  _mergeExternal(objects, blobs, os.path.dirname(os.path.abspath(path)))
  scene = Scene(label=os.path.splitext(os.path.basename(path))[0],
                path=os.path.splitext(path)[0])

  def popProps(fc, instance):
    '''Copy matching FCStd properties onto a models object.'''
    for key in instance.propertyNames():
      if key in fc.props:
        setattr(instance, key, fc.props[key])
    instance.Label = fc.label

  def sourcePlacement(fc):
    '''Sources resolve their global placement through containers but not
    links (reference: generic_source.py:53 uses the WithoutLinks variant).'''
    paths = allPlacementsAndPaths(objects, fc.name, ignoreLinks=True)
    return paths[0][0] if paths else fc.get('Placement', np.eye(4))

  for fc in objects.values():
    if fc.type != 'App::LinkGroupPython' and fc.type != 'Part::FeaturePython':
      continue
    name = fc.name
    if 'SimulationSettings' in name:
      settings = SimulationSettings()
      popProps(fc, settings)
      scene.addSimulationSettings(settings=settings)
    elif 'PointSource' in name:
      src = PointSource(placement=sourcePlacement(fc))
      popProps(fc, src)
      scene.addSource(src)
    elif 'SurfaceSource' in name:
      src = SurfaceSource(placement=sourcePlacement(fc))
      popProps(fc, src)
      active = fc.get('ActiveSurfaces', [])
      # keep the reference's (object, subElements) selection: whole bodies
      # or explicitly picked FaceN subs (surface_source.py:437-457)
      resolved = []
      for entry in (active or []):
        obj, subs = entry if isinstance(entry, tuple) else (entry, [])
        label = objects[obj].label if isinstance(obj, str) \
            and obj in objects else obj
        faceIdx = [int(s[4:]) - 1 for s in (subs or [])
                   if isinstance(s, str) and s.startswith('Face')]
        resolved.append((label, faceIdx) if faceIdx else label)
      src.ActiveSurfaces = resolved
      scene.addSource(src)
    elif 'ReplaySource' in name:
      src = ReplaySource(placement=sourcePlacement(fc))
      popProps(fc, src)
      scene.addSource(src)
    elif any(f'Optical{t}Group' in name for t in OPTICAL_TYPES):
      optType = next(t for t in OPTICAL_TYPES if f'Optical{t}Group' in name)
      group = OpticalGroup(OpticalType=fc.get('OpticalType', optType))
      popProps(fc, group)
      group.OpticalType = fc.get('OpticalType', optType)
      members = fc.get('ElementList', [])
      group.surfaces = _collectGeometry(objects, members, 0, fc.label,
                                        skipUnsupported, readBlob)
      # multi-placement semantics: the group (one shape) may exist at
      # several global transforms through containers and Links
      # (reference: common.py:36-109)
      group.placements = [m for m, _p in
                          allPlacementsAndPaths(objects, fc.name)]
      scene.addOpticalGroup(group)
  if not scene.opticalObjects() and not skipUnsupported:
    raise ValueError(f'no optical groups could be ingested from {path}')
  return scene
