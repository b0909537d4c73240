'''
Headless ray drawing — the port's stand-in for the reference's GUI ray
view (reference: freecad_elements/generic_source.py:86-140, which builds
Part::Feature line compounds in the FreeCAD 3D view, and ray.py:136-142,
which emits colorChange events from the hit object's ViewObject
Weight/Color).

Instead of a live 3D view, `DrawnRays` collects the traced polylines of a
single-shot run (with per-segment colors following the exact reference
blend rule `color = (1-w)*color + w*objectColor`) and exports them to
standard viewers:

  * `writePLY(path)`  — ASCII PLY with colored vertices + edge elements
                        (opens in MeshLab / Blender / Open3D next to the
                        exported scene geometry)
  * `writeOBJ(path)`  — Wavefront OBJ polylines (`v`/`l` records)
  * `save(folder)`    — `drawn-rays.npz` snapshot + the PLY, written into
                        the simulation run folder by the runner when
                        `runSimulation(..., draw=True)`
  * `plot(...)`       — matplotlib view (3-D, or a 2-D projection)

The files are the JAX package's, byte for byte (its header comment
included).

Color sources: the light source's `ViewColor` property plays the role of
the reference's ShapeMaterial.DiffuseColor starting color
(generic_source.py:89-94); an optical group's `ViewColor`/`ViewColorWeight`
play ViewObject Color/Weight (ray.py:136-142; weight 0 disables blending).
'''

import json
import os

import numpy as np

from .. import hostArray
from ..utils import io


def sceneDrawParams(scene):
  '''Per-element color/weight arrays in scene.compile() element order.'''
  groups = scene.opticalObjects()
  colors = np.array([_rgb(getattr(g, 'ViewColor', None) or (0.35, 0.35, 0.4))
                     for g in groups], dtype=float).reshape(-1, 3)
  weights = np.array([float(getattr(g, 'ViewColorWeight', 0.) or 0.)
                      for g in groups], dtype=float)
  return dict(elementColors=colors, elementWeights=weights)


def _rgb(c):
  c = tuple(float(v) for v in c)[:3]
  if len(c) != 3:
    raise ValueError(f'expected an RGB triple, got {c!r}')
  return c


def plyVertexBlock(points, colors01):
  '''ASCII PLY vertex lines (x y z r g b) as one string — shared by
  DrawnRays.writePLY and geometry.tessellate.writeScenePLY so the two
  stay byte-format compatible; np.savetxt with a fixed format beats a
  per-row python f-string loop on large batches.'''
  import io as _io
  rgb = np.clip(np.asarray(colors01) * 255. + .5, 0, 255).astype(np.uint8)
  buf = _io.StringIO()
  np.savetxt(buf, np.column_stack([points, rgb]),
             fmt='%.6g %.6g %.6g %d %d %d')
  return buf.getvalue()


def plyEdgeBlock(offsets, indexOffset=0):
  '''ASCII PLY edge lines for ragged polylines delimited by `offsets`
  (consecutive-point pairs within each polyline), 'v1 v2' per line.'''
  import io as _io
  offsets = np.asarray(offsets, dtype=np.int64)
  V = int(offsets[-1]) if len(offsets) else 0
  keep = np.ones(max(V - 1, 0), dtype=bool)
  keep[offsets[1:-1] - 1] = False      # no edge across polylines
  v1 = np.nonzero(keep)[0] + int(indexOffset)
  buf = _io.StringIO()
  np.savetxt(buf, np.column_stack([v1, v1 + 1]), fmt='%d %d')
  return buf.getvalue()


class DrawnRays:
  '''Accumulates traced ray polylines across sources/iterations.

  Storage is the same ragged encoding as SimulationResults.addRayBatch:
  `points` (V, 3) with `offsets` delimiting polylines; per-SEGMENT
  `colors` (S, 3), `powers` (S,) and `sourceIdx` (rays,).
  '''

  def __init__(self):
    self.points = np.zeros((0, 3))
    self.offsets = np.array([0], dtype=np.int64)
    self.colors = np.zeros((0, 3))
    self.powers = np.zeros((0,))
    self.sourceIdx = np.zeros((0,), dtype=np.int32)
    self.sourceLabels = []

  # ------------------------------------------------------------ collection

  def add(self, records, sourceLabel='source', sourceColor=(1., 0., 0.),
          elementColors=None, elementWeights=None):
    '''Append the rays of one traced batch.

    records: the bounce-major segment records of tracing.trace (segP1/segP2
    (B, N, 3), segValid/segPower (B, N), hitElem (B, N)). Colors follow the
    reference rule: a segment's color is the source color blended with the
    ViewColor of every element hit BEFORE the segment started (the
    colorChange of generic_source.py:106-140 applies from the next drawn
    line element onward).
    '''
    segValid = hostArray(records['segValid'])             # (B, N)
    if not segValid.any():
      return self
    p1 = hostArray(records['segP1']).astype(float)        # (B, N, 3)
    p2 = hostArray(records['segP2']).astype(float)
    power = hostArray(records['segPower']).astype(float)
    hitElem = hostArray(records['hitElem'])               # (B, N)
    B, N = segValid.shape

    # running per-ray color, advanced bounce-by-bounce (B is small)
    color = np.broadcast_to(np.asarray(_rgb(sourceColor)), (N, 3)).copy()
    segColors = np.empty((B, N, 3))
    for b in range(B):
      segColors[b] = color
      if elementWeights is not None and elementWeights.size:
        e = hitElem[b]
        hit = e >= 0
        eSafe = np.maximum(e, 0)
        w = np.clip(elementWeights[eSafe], 0., 1.)[:, None]
        blend = hit[:, None] & (w > 0)
        color = np.where(blend,
                         (1. - w) * color + w * elementColors[eSafe],
                         color)

    counts = segValid.sum(axis=0)                          # (N,)
    rays = np.nonzero(counts > 0)[0]
    k = counts[rays].astype(np.int64)   # valid segments are a prefix
    # vectorized ragged assembly (single-shot batches can be large):
    # polyline n = [p1[0..k-1, n], p2[k-1, n]] since p1[b+1] == p2[b]
    nPts = k + 1
    starts = np.cumsum(nPts) - nPts
    rayIdxP = np.repeat(rays, nPts)
    j = np.arange(int(nPts.sum())) - np.repeat(starts, nPts)
    jb = np.minimum(j, np.repeat(k - 1, nPts))
    isLast = j == np.repeat(k, nPts)
    pts = np.where(isLast[:, None], p2[jb, rayIdxP], p1[jb, rayIdxP])
    segStarts = np.cumsum(k) - k
    rayIdxS = np.repeat(rays, k)
    js = np.arange(int(k.sum())) - np.repeat(segStarts, k)

    srcIdx = self._sourceIndex(sourceLabel)
    self.points = np.concatenate([self.points, pts])
    self.offsets = np.concatenate(
        [self.offsets, self.offsets[-1] + np.cumsum(nPts)])
    self.colors = np.concatenate([self.colors, segColors[js, rayIdxS]])
    self.powers = np.concatenate([self.powers, power[js, rayIdxS]])
    self.sourceIdx = np.concatenate(
        [self.sourceIdx, np.full(len(rays), srcIdx, dtype=np.int32)])
    return self

  def _sourceIndex(self, label):
    if label not in self.sourceLabels:
      self.sourceLabels.append(label)
    return self.sourceLabels.index(label)

  # ------------------------------------------------------------- accessors

  @property
  def rayCount(self):
    return len(self.offsets) - 1

  @property
  def segmentCount(self):
    return len(self.colors)

  def polyline(self, i):
    '''(points (k+1, 3), colors (k, 3), powers (k,)) of ray i.'''
    a, b = self.offsets[i], self.offsets[i + 1]
    sa, sb = a - i, b - i - 1       # each prior polyline has 1 more point
    return self.points[a:b], self.colors[sa:sb], self.powers[sa:sb]

  def segments(self):
    '''Flat (S, 2, 3) segment view with (S, 3) colors and (S,) powers.'''
    V = len(self.points)
    keep = np.ones(max(V - 1, 0), dtype=bool)
    keep[self.offsets[1:-1] - 1] = False   # no segment across polylines
    segs = np.stack([self.points[:-1][keep], self.points[1:][keep]], axis=1)
    return segs, self.colors, self.powers

  def vertexColors(self):
    '''(V, 3) per-vertex colors: each vertex takes its incoming segment's
    color (a polyline's first vertex takes its first segment's color).'''
    ptRay = np.repeat(np.arange(self.rayCount, dtype=np.int64),
                      np.diff(self.offsets))
    segIdx = np.arange(len(self.points), dtype=np.int64) - ptRay - 1
    firstSeg = self.offsets[:-1][ptRay] - ptRay
    return self.colors[np.maximum(segIdx, firstSeg)]

  def clear(self):
    '''Drop all collected rays (the reference's `clear` action deletes the
    drawn Part::Feature objects, generic_source.py:onDelete).'''
    self.__init__()
    return self

  # --------------------------------------------------------------- exports

  def writePLY(self, path):
    '''ASCII PLY: colored vertices + edge list (MeshLab/Blender-ready).
    Per-vertex color is the color of the incoming segment (the last
    segment's color for a polyline's final vertex).'''
    with open(path, 'w') as f:
      f.write('ply\nformat ascii 1.0\n'
              f'comment optics_design_workbench_tpu drawn rays\n'
              f'element vertex {len(self.points)}\n'
              'property float x\nproperty float y\nproperty float z\n'
              'property uchar red\nproperty uchar green\n'
              'property uchar blue\n'
              f'element edge {self.segmentCount}\n'
              'property int vertex1\nproperty int vertex2\n'
              'end_header\n')
      f.write(plyVertexBlock(self.points, self.vertexColors()))
      f.write(plyEdgeBlock(self.offsets))
    return path

  def writeOBJ(self, path):
    '''Wavefront OBJ polylines (no color; for viewers without edge-PLY).'''
    with open(path, 'w') as f:
      f.write('# optics_design_workbench_tpu drawn rays\n')
      np.savetxt(f, self.points, fmt='v %.6g %.6g %.6g')
      for i in range(self.rayCount):
        a, b = int(self.offsets[i]), int(self.offsets[i + 1])
        idx = ' '.join(str(v + 1) for v in range(a, b))   # OBJ is 1-based
        f.write(f'l {idx}\n')
    return path

  def save(self, folder):
    '''Write drawn-rays.npz + drawn-rays.ply into a run folder.'''
    os.makedirs(folder, exist_ok=True)
    np.savez_compressed(
        os.path.join(folder, 'drawn-rays.npz'),
        points=self.points, offsets=self.offsets, colors=self.colors,
        powers=self.powers, sourceIdx=self.sourceIdx,
        sourceLabels=json.dumps(self.sourceLabels))
    self.writePLY(os.path.join(folder, 'drawn-rays.ply'))
    io.verb(f'wrote {self.rayCount} drawn rays '
            f'({self.segmentCount} segments) to {folder}')
    return folder

  @classmethod
  def fromRays(cls, rays, sourceColor=(1., 0., 0.), sourceLabel='source'):
    '''Build a DrawnRays from stored ray polylines (the list-of-dicts
    encoding of RawFolder.loadRays / results_store ray files:
    dict(points (K+1, 3), powers (K,), media)) so RecordRays runs can be
    drawn/exported after the fact. Stored rays carry no color events;
    every segment gets the source color.'''
    self = cls()
    rays = [r for r in rays if len(r['points']) >= 2]
    if not rays:
      return self
    self.points = np.concatenate([np.asarray(r['points'], dtype=float)
                                  for r in rays])
    nPts = np.array([len(r['points']) for r in rays], dtype=np.int64)
    self.offsets = np.concatenate([[0], np.cumsum(nPts)])
    self.powers = np.concatenate([np.asarray(r['powers'], dtype=float)
                                  for r in rays])
    self.colors = np.broadcast_to(np.asarray(_rgb(sourceColor)),
                                  (len(self.powers), 3)).copy()
    self.sourceIdx = np.zeros(len(rays), dtype=np.int32)
    self.sourceLabels = [sourceLabel]
    return self

  @classmethod
  def load(cls, folder):
    '''Reload a save()d snapshot from a run folder.'''
    z = np.load(os.path.join(folder, 'drawn-rays.npz'))
    self = cls()
    self.points = z['points']
    self.offsets = z['offsets']
    self.colors = z['colors']
    self.powers = z['powers']
    self.sourceIdx = z['sourceIdx']
    self.sourceLabels = json.loads(str(z['sourceLabels']))
    return self

  # ------------------------------------------------------------------ plot

  def plot(self, ax=None, plane=None, powerAlpha=True, lineWidth=0.8,
           maxRays=None):
    '''Matplotlib view of the drawn rays.

    plane: None for 3-D, or 'xy'/'xz'/'yz' for a 2-D projection. With
    powerAlpha, segment opacity tracks remaining ray power (the GUI analog
    is rays visually fading into absorbers).
    '''
    import matplotlib.pyplot as plt
    from matplotlib.collections import LineCollection
    segs, colors, powers = self.segments()
    if maxRays is not None and self.rayCount > maxRays:
      # keep whole polylines, not a random segment subset
      keepSegs = np.zeros(self.segmentCount, bool)
      s = 0
      stride = -(-self.rayCount // maxRays)     # ceil: keep <= maxRays rays
      for i in range(self.rayCount):
        k = int(self.offsets[i + 1] - self.offsets[i]) - 1
        keepSegs[s:s + k] = (i % stride == 0)
        s += k
      segs, colors, powers = segs[keepSegs], colors[keepSegs], \
          powers[keepSegs]
    alpha = (np.clip(powers / max(powers.max(), 1e-30), 0.08, 1.)
             if powerAlpha and len(powers) else
             np.ones(len(segs)))
    rgba = np.concatenate([colors, alpha[:, None]], axis=1)
    if plane is None:
      from mpl_toolkits.mplot3d.art3d import Line3DCollection
      if ax is None:
        ax = plt.figure().add_subplot(projection='3d')
      ax.add_collection3d(Line3DCollection(segs, colors=rgba,
                                           linewidths=lineWidth))
      lo, hi = self.points.min(axis=0), self.points.max(axis=0)
      pad = 0.05 * max(float((hi - lo).max()), 1.)
      ax.set_xlim(lo[0] - pad, hi[0] + pad)
      ax.set_ylim(lo[1] - pad, hi[1] + pad)
      ax.set_zlim(lo[2] - pad, hi[2] + pad)
      ax.set_xlabel('x'), ax.set_ylabel('y'), ax.set_zlabel('z')
    else:
      cols = {'xy': (0, 1), 'xz': (0, 2), 'yz': (1, 2)}[plane]
      if ax is None:
        _, ax = plt.subplots()
      ax.add_collection(LineCollection(segs[..., cols], colors=rgba,
                                       linewidths=lineWidth))
      ax.autoscale()
      ax.set_aspect('equal')
      ax.set_xlabel(plane[0]), ax.set_ylabel(plane[1])
    return ax
