'''
Triangle meshes as scene geometry (counterpart of the JAX package's
geometry/mesh.py, host numpy only): a mesh becomes a list of TRIANGLE
surfaces with its placement baked into the vertices. Loaders: binary and
ASCII STL, OBJ (polygons fan-triangulated, negative indices counted from
the end), and the stored face triangulations of an OpenCASCADE ASCII BRep
blob (the `*.brp` payloads inside FCStd archives).

On the card a mesh of up to 128 triangles keeps one surface row per
triangle; a larger one is swept from the kernels' triangle table
(ops/cuda_trace.py, ROADMAP B7), so a mesh may have any number of
triangles.
'''

import struct

import numpy as np

from . import surfaces as S


def meshSurfaces(vertices, faces, elem, transform=None, orient=+1):
  '''Triangle-surface dicts for a (V, 3) x (F, 3) indexed mesh.

  transform: optional 4x4 applied to the vertices on the host (a mesh bakes
  its placement into its vertex coordinates instead of carrying one
  transform per triangle).
  orient: +1 keeps each triangle's winding-order normal as "outward".'''
  vertices = np.asarray(vertices, dtype=float)
  faces = np.asarray(faces, dtype=int)
  if vertices.ndim != 2 or vertices.shape[1] != 3:
    raise ValueError(f'vertices must be (V, 3), got {vertices.shape}')
  if faces.ndim != 2 or faces.shape[1] != 3:
    raise ValueError(f'faces must be (F, 3), got {faces.shape}')
  if faces.size and (faces.min() < 0 or faces.max() >= len(vertices)):
    raise ValueError('face indices out of range')
  if transform is not None:
    m = np.asarray(transform, dtype=float)
    vertices = vertices @ m[:3, :3].T + m[:3, 3]
  tris = vertices[faces]          # (F, 3, 3)
  return [S.triangle(t[0], t[1], t[2], elem=elem, orient=orient)
          for t in tris]


# ---------------------------------------------------------------- STL ----

def loadSTL(path):
  '''(vertices, faces) from a binary or ASCII STL file. Vertices are not
  deduplicated (3 per triangle): the tracer never needs shared vertices.'''
  with open(path, 'rb') as f:
    data = f.read()
  if data[:5].lower() == b'solid' and b'facet' in data[:1024]:
    return _parseAsciiSTL(data.decode('latin-1'))
  return _parseBinarySTL(data)


def _parseBinarySTL(data):
  if len(data) < 84:
    raise ValueError('not a binary STL: file shorter than its header')
  (n,) = struct.unpack_from('<I', data, 80)
  need = 84 + 50 * n
  if len(data) < need:
    raise ValueError(f'binary STL truncated: {n} triangles need {need} '
                     f'bytes, file has {len(data)}')
  raw = np.frombuffer(data, dtype=np.uint8, count=50 * n, offset=84)
  rec = raw.reshape(n, 50)[:, 12:48].copy()   # skip normal, drop attribute
  verts = rec.view('<f4').reshape(n * 3, 3).astype(float)
  faces = np.arange(n * 3).reshape(n, 3)
  return verts, faces


def _parseAsciiSTL(text):
  verts = []
  for line in text.splitlines():
    parts = line.split()
    if len(parts) == 4 and parts[0] == 'vertex':
      verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
  if not verts or len(verts) % 3:
    raise ValueError(f'ASCII STL: vertex count {len(verts)} is not a '
                     f'multiple of 3')
  verts = np.asarray(verts)
  faces = np.arange(len(verts)).reshape(-1, 3)
  return verts, faces


def writeBinarySTL(path, vertices, faces):
  '''Write an indexed mesh as a binary STL (zero facet normals: readers
  take the winding order).'''
  vertices = np.asarray(vertices, dtype='<f4')
  faces = np.asarray(faces, dtype=int)
  rec = np.zeros((len(faces), 50), np.uint8)
  rec[:, 12:48] = vertices[faces].reshape(len(faces), 9).view(np.uint8)
  with open(path, 'wb') as f:
    f.write(b'\0' * 80)
    f.write(struct.pack('<I', len(faces)))
    f.write(rec.tobytes())


# ---------------------------------------------------------------- OBJ ----

def loadOBJ(path):
  '''(vertices, faces) from a Wavefront OBJ; polygons are fan-triangulated.
  Only `v` and `f` records are used (normals, UVs, materials ignored).'''
  verts, faces = [], []
  with open(path) as f:
    for line in f:
      parts = line.split()
      if not parts:
        continue
      if parts[0] == 'v':
        verts.append([float(x) for x in parts[1:4]])
      elif parts[0] == 'f':
        idx = []
        for tok in parts[1:]:
          i = int(tok.split('/')[0])
          idx.append(i - 1 if i > 0 else len(verts) + i)
        for k in range(1, len(idx) - 1):
          faces.append([idx[0], idx[k], idx[k + 1]])
  if not faces:
    raise ValueError('OBJ file contains no faces')
  return np.asarray(verts, dtype=float), np.asarray(faces, dtype=int)


# ------------------------------------------------- OCC BRep (*.brp) ----

def parseBRepTriangulations(text):
  '''The stored face triangulations of an OpenCASCADE ASCII BRep (the
  "DBRep_DrawableShape" / "CASCADE Topology" format, the `PartShape.brp`
  payload inside FCStd archives), as far as they can be read.

  Returns a list of (vertices (N, 3), faces (F, 3)), one per triangulated
  face. Raises ValueError when the blob stores no triangulation (FreeCAD
  embeds one only when its "save triangulation" preference is on or the
  shape was displayed before saving) or when the section cannot be decoded.

  Node coordinates are taken as they are, in the shape's frame: locations
  on sub-shapes (nested compound placements inside one BRep) are not
  applied, so single-solid results of booleans and pads, which carry the
  identity location, load exactly.'''
  marker = 'Triangulations'
  pos = text.find(marker)
  if pos < 0:
    raise ValueError(
        'BRep blob has no Triangulations section: FreeCAD saved this shape '
        'without its triangulation. Re-save with triangulation enabled, or '
        'export the element as STL/OBJ and load it with geometry.mesh.')
  it = iter(text[pos + len(marker):].split())

  def nxt():
    return next(it)

  try:
    count = int(nxt())
  except (StopIteration, ValueError) as e:
    raise ValueError(f'unreadable Triangulations header: {e}') from e
  if count == 0:
    raise ValueError(
        'BRep blob declares 0 triangulations: FreeCAD saved this shape '
        'without mesh data. Re-save with triangulation enabled, or export '
        'the element as STL/OBJ and load it with geometry.mesh.')
  out = []
  try:
    for _ in range(count):
      nNodes = int(nxt())
      nTris = int(nxt())
      hasUV = int(nxt())
      nxt()                                   # the deflection
      # OCC >= 7.6 (format version 3) puts a normals flag after the
      # deflection; older writers go straight to the coordinates. A 0 / 1
      # token here is that flag.
      probe = nxt()
      hasNormals = 0
      if probe in ('0', '1'):
        hasNormals = int(probe)
        firstCoord = float(nxt())
      else:
        firstCoord = float(probe)
      coords = [firstCoord]
      coords.extend(float(nxt()) for _ in range(3 * nNodes - 1))
      verts = np.asarray(coords, dtype=float).reshape(nNodes, 3)
      for _ in range(2 * nNodes * hasUV + 3 * nNodes * hasNormals):
        nxt()
      tris = np.asarray([int(nxt()) for _ in range(3 * nTris)],
                        dtype=int).reshape(nTris, 3) - 1   # 1-based
      if tris.size and (tris.min() < 0 or tris.max() >= nNodes):
        raise ValueError('triangle node index out of range')
      out.append((verts, tris))
  except (StopIteration, ValueError) as e:
    raise ValueError(
        f'failed to decode BRep triangulation section ({e}); this OCC '
        f'format variant is not understood — export the element as '
        f'STL/OBJ and load it with geometry.mesh instead') from e
  return out


def brepMeshSurfaces(text, elem, transform=None, orient=+1):
  '''Triangle surfaces for every stored face triangulation of a BRep blob
  (see parseBRepTriangulations for what is read).'''
  surfs = []
  for verts, tris in parseBRepTriangulations(text):
    surfs.extend(meshSurfaces(verts, tris, elem=elem, transform=transform,
                              orient=orient))
  return surfs
