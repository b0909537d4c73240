'''
Surface light source — rays emitted from the faces of scene geometry with an
angular power density in theta per surface element (counterpart of the JAX
package's models/surface_source.py; reference semantics:
freecad_elements/surface_source.py):

  * ActiveSurfaces: whole optical groups or individual face indices
    (surface_source.py:35-37, 437-457);
  * area-correct position sampling: faces chosen with probability
    proportional to their area, positions drawn in closed form per kind
    (plane rectangle / disc / annulus, sphere zone, cylinder, cone,
    triangle), aspheres and tori through a tabulated inverse CDF of their
    radius / tube angle (`rInv`; the kernels' sampler takes its piecewise
    polynomial fit, `rSpec`);
  * PowerDensity in theta only (default cos(theta)**2, :38-43); phi
    uniform; direction = Rot(normal, phi) Rot(tangent, theta) normal
    (:85-111).

The device path of the source is `samplerSpec()` (the JAX package's
`pallasSamplerSpec`, named as the port names the point source's),
`deviceColumnsGenerator()`, `deviceGenerator()` (the columns with their
metadata), `emissionBound()` and the column maths the trace kernels'
sampler repeats (`surfaceSampleColumns`), for faces of every kind; the host
path is `generateRays()`: fans on a deterministic surface grid, and true /
pseudo draws on the host.
'''

import numpy as np
import torch

from .. import distributions, resolveDevice
from ..distributions.device_sampler import (buildDeviceTables, deviceDraw,
                                            evalPwpoly, fitPiecewisePoly)
from ..geometry import surfaces as GS
from ..utils import io
from .common import parseDomain
from .generic_source import GenericSource

# the in-kernel sampler's face limit (the reference's)
MAX_SAMPLER_FACES = 32


def _torusTubeAngleCdf(face, quantileRes=257):
  '''Inverse CDF v(u) of the torus tube-angle area element
  dA ~ (R + r cos v) dv on the face's v band, tabulated on a uniform
  quantile grid.'''
  R0, rT = float(face.params[0]), float(face.params[1])
  v1 = max(float(face.trim[1]), -np.pi)
  v2 = min(float(face.trim[2]), np.pi)
  vGrid = np.linspace(v1, v2, 2001)
  cdf = R0 * (vGrid - v1) + rT * (np.sin(vGrid) - np.sin(v1))
  cdf /= cdf[-1]
  return np.interp(np.linspace(0., 1., quantileRes), cdf, vGrid)


def _asphereRadiusCdf(face, quantileRes=257):
  '''Inverse CDF r(u) of the area element dA(r) of an asphere face,
  tabulated on a uniform quantile grid.'''
  t = face.trim
  r1, r2 = t[1], min(t[2], 1e6)
  rGrid = np.linspace(r1, r2, 2001)
  gr = face._sagPrimeOverR(rGrid ** 2) * rGrid
  dens = 2 * np.pi * rGrid * np.sqrt(1 + gr ** 2)
  cdf = np.concatenate([[0], np.cumsum((dens[1:] + dens[:-1]) / 2
                                       * np.diff(rGrid))])
  cdf /= cdf[-1]
  return np.interp(np.linspace(0., 1., quantileRes), cdf, rGrid)


def _rodrigues(v, axis, angle):
  axis = axis / np.linalg.norm(axis)
  c, s = np.cos(angle), np.sin(angle)
  return (v * c + np.cross(axis, v) * s
          + axis * (axis @ v) * (1 - c))


class _Face:
  '''Host-side sampling adapter for one analytic surface instance.'''

  def __init__(self, spec, placement):
    self.transform = np.asarray(placement, float) @ \
        np.asarray(spec['transform'], float)
    self.kind = spec['kind']
    self.params = np.asarray(spec['params'], float)
    self.trim = np.asarray(spec['trim'], float)
    self.orient = float(spec['orient'])

  def area(self):
    k, p, t = self.kind, self.params, self.trim
    if k == GS.PLANE:
      if t[0] > 0.5:
        return 4 * t[1] * t[2]
      rOut = t[2] if np.isfinite(t[2]) else 0.
      return np.pi * (rOut ** 2 - t[1] ** 2)
    if k in (GS.SPHERE, GS.CYLINDER):
      return 2 * np.pi * p[0] * (t[2] - t[1])     # zone area = 2 pi R dz
    if k == GS.ASPHERE:
      r1, r2 = t[1], min(t[2], 1e6)
      r = np.linspace(r1, r2, 2001)
      g = self._sagPrimeOverR(r ** 2) * r
      return float(np.trapezoid(2 * np.pi * r * np.sqrt(1 + g ** 2), r))
    if k == GS.TRIANGLE:
      v0, v1, v2 = p[0:3], p[3:6], p[6:9]
      return 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0))
    if k == GS.CONE:
      # dA = 2 pi r(z) sqrt(1 + tanA^2) dz with r(z) = r0 + z tanA
      r0, tanA = p[0], p[1]
      z1, z2 = t[1], t[2]
      return float(2 * np.pi * np.sqrt(1 + tanA ** 2)
                   * (r0 * (z2 - z1) + tanA * (z2 ** 2 - z1 ** 2) / 2))
    if k == GS.TORUS:
      # dA = r (R + r cos v) du dv, u full circle, v band
      R0, rT = p[0], p[1]
      v1, v2 = max(t[1], -np.pi), min(t[2], np.pi)
      return float(2 * np.pi * rT
                   * (R0 * (v2 - v1) + rT * (np.sin(v2) - np.sin(v1))))
    raise ValueError(f'unknown surface kind {k}')

  def _sagPrimeOverR(self, r2):
    c, kk = self.params[0], self.params[1]
    a4, a6, a8 = self.params[2], self.params[3], self.params[4]
    root = np.sqrt(np.maximum(1 - (1 + kk) * c * c * r2, 1e-12))
    return (c * (2 / (1 + root) + (1 + kk) * c * c * r2
                 / (root * (1 + root) ** 2))
            + 4 * a4 * r2 + 6 * a6 * r2 * r2 + 8 * a8 * r2 ** 3)


  def samplePositions(self, n, rng):
    '''(n,3) local points distributed with uniform area density, plus local
    normals (n,3) (canonical, orient applied).'''
    k, p, t = self.kind, self.params, self.trim
    u = rng.random(n)
    v = rng.random(n)
    if k == GS.PLANE:
      if t[0] > 0.5:
        pts = np.stack([(2 * u - 1) * t[1], (2 * v - 1) * t[2],
                        np.zeros(n)], -1)
      else:
        r = np.sqrt(u * (t[2] ** 2 - t[1] ** 2) + t[1] ** 2)
        phi = 2 * np.pi * v
        pts = np.stack([r * np.cos(phi), r * np.sin(phi), np.zeros(n)], -1)
      normals = np.tile([0., 0., 1.], (n, 1))
    elif k == GS.SPHERE:
      R = p[0]
      z = t[1] + u * (t[2] - t[1])      # uniform z = uniform zone area
      phi = 2 * np.pi * v
      rr = np.sqrt(np.maximum(R ** 2 - z ** 2, 0.))
      pts = np.stack([rr * np.cos(phi), rr * np.sin(phi), z], -1)
      normals = pts / R
    elif k == GS.CYLINDER:
      R = p[0]
      z = t[1] + u * (t[2] - t[1])
      phi = 2 * np.pi * v
      pts = np.stack([R * np.cos(phi), R * np.sin(phi), z], -1)
      normals = np.stack([np.cos(phi), np.sin(phi), np.zeros(n)], -1)
    elif k == GS.ASPHERE:
      r1, r2 = t[1], min(t[2], 1e6)
      rGrid = np.linspace(r1, r2, 2001)
      gr = self._sagPrimeOverR(rGrid ** 2) * rGrid
      dens = 2 * np.pi * rGrid * np.sqrt(1 + gr ** 2)
      cdf = np.concatenate([[0], np.cumsum((dens[1:] + dens[:-1]) / 2
                                           * np.diff(rGrid))])
      cdf /= cdf[-1]
      r = np.interp(u, cdf, rGrid)
      phi = 2 * np.pi * v
      r2v = r ** 2
      z = self._sag(r2v)
      pts = np.stack([r * np.cos(phi), r * np.sin(phi), z], -1)
      g = self._sagPrimeOverR(r2v)
      normals = np.stack([-g * r * np.cos(phi), -g * r * np.sin(phi),
                          np.ones(n)], -1)
      normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    elif k == GS.TRIANGLE:
      v0, v1, v2 = p[0:3], p[3:6], p[6:9]
      a, b = u, v
      flip = a + b > 1
      a = np.where(flip, 1 - a, a)
      b = np.where(flip, 1 - b, b)
      pts = v0 + a[:, None] * (v1 - v0) + b[:, None] * (v2 - v0)
      nrm = np.cross(v1 - v0, v2 - v0)
      normals = np.tile(nrm / np.linalg.norm(nrm), (n, 1))
    elif k == GS.CONE:
      # area density over z is linear in r(z) = r0 + z tanA: invert the
      # quadratic CDF in closed form
      r0, tanA = p[0], p[1]
      z1, z2 = t[1], t[2]
      A = lambda z: r0 * z + tanA * z * z / 2      # noqa: E731
      target = A(z1) + u * (A(z2) - A(z1))
      if abs(tanA) < 1e-12:
        z = z1 + u * (z2 - z1)
      else:
        disc = np.maximum(r0 ** 2 + 2 * tanA * target, 0.)
        z = (-r0 + np.sqrt(disc)) / tanA
      phi = 2 * np.pi * v
      rr = r0 + z * tanA
      pts = np.stack([rr * np.cos(phi), rr * np.sin(phi), z], -1)
      normals = np.stack([np.cos(phi), np.sin(phi),
                          np.full(n, -tanA)], -1)
      normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    elif k == GS.TORUS:
      vInv = _torusTubeAngleCdf(self)
      vT = np.interp(u, np.linspace(0., 1., len(vInv)), vInv)
      phi = 2 * np.pi * v
      R0, rT = p[0], p[1]
      rad = R0 + rT * np.cos(vT)
      pts = np.stack([rad * np.cos(phi), rad * np.sin(phi),
                      rT * np.sin(vT)], -1)
      normals = np.stack([np.cos(vT) * np.cos(phi),
                          np.cos(vT) * np.sin(phi), np.sin(vT)], -1)
    else:
      raise ValueError(f'unknown surface kind {k}')
    return pts, normals * self.orient

  def _sag(self, r2):
    c, kk = self.params[0], self.params[1]
    a4, a6, a8 = self.params[2], self.params[3], self.params[4]
    root = np.sqrt(np.maximum(1 - (1 + kk) * c * c * r2, 1e-12))
    return c * r2 / (1 + root) + r2 * r2 * (a4 + r2 * (a6 + r2 * a8))

  def gridPositions(self, n):
    '''Deterministic approximately-uniform surface grid of ~n points (fan
    mode, reference: surface_source.py:122-267). Returns (points, normals)
    in local frame.'''
    n = max(1, int(n))
    k, p, t = self.kind, self.params, self.trim
    if k == GS.PLANE and t[0] > 0.5:
      nx = max(1, int(round(np.sqrt(n * t[1] / t[2]))))
      ny = max(1, int(round(n / nx)))
      xs = np.linspace(-t[1], t[1], nx + 2)[1:-1]
      ys = np.linspace(-t[2], t[2], ny + 2)[1:-1]
      X, Y = np.meshgrid(xs, ys, indexing='ij')
      pts = np.stack([X.ravel(), Y.ravel(), np.zeros(X.size)], -1)
      normals = np.tile([0., 0., 1.], (len(pts), 1))
    elif k in (GS.PLANE, GS.ASPHERE):
      # concentric rings with ring point counts proportional to radius
      rIn = t[1]
      rOut = t[2] if np.isfinite(t[2]) else 1.
      nRings = max(1, int(round(np.sqrt(n / np.pi))))
      rs = np.linspace(rIn, rOut, nRings + 1)[:-1] + \
          (rOut - rIn) / (2 * nRings + 1e-30)
      pts, normals = [], []
      total = sum(max(1, int(round(2 * np.pi * r / max(rOut - rIn, 1e-9)
                                   * nRings))) for r in rs)
      for r in rs:
        m = max(1, int(round(2 * np.pi * r / max(rOut - rIn, 1e-9)
                             * nRings * n / max(total, 1))))
        phis = np.linspace(0, 2 * np.pi, m + 1)[:-1]
        if k == GS.PLANE:
          ring = np.stack([r * np.cos(phis), r * np.sin(phis),
                           np.zeros(m)], -1)
          nrm = np.tile([0., 0., 1.], (m, 1))
        else:
          z = self._sag(np.full(m, r ** 2))
          ring = np.stack([r * np.cos(phis), r * np.sin(phis), z], -1)
          g = self._sagPrimeOverR(np.full(m, r ** 2))
          nrm = np.stack([-g * r * np.cos(phis), -g * r * np.sin(phis),
                          np.ones(m)], -1)
          nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
        pts.append(ring)
        normals.append(nrm)
      pts = np.concatenate(pts)
      normals = np.concatenate(normals)
    elif k in (GS.SPHERE, GS.CYLINDER):
      R = p[0]
      span = t[2] - t[1]
      nz = max(1, int(round(np.sqrt(n * span / (2 * np.pi * R)))))
      nphi = max(1, int(round(n / nz)))
      zs = np.linspace(t[1], t[2], nz + 2)[1:-1]
      phis = np.linspace(0, 2 * np.pi, nphi + 1)[:-1]
      Z, PHI = np.meshgrid(zs, phis, indexing='ij')
      Z, PHI = Z.ravel(), PHI.ravel()
      if k == GS.SPHERE:
        rr = np.sqrt(np.maximum(R ** 2 - Z ** 2, 0.))
        pts = np.stack([rr * np.cos(PHI), rr * np.sin(PHI), Z], -1)
        normals = pts / R
      else:
        pts = np.stack([R * np.cos(PHI), R * np.sin(PHI), Z], -1)
        normals = np.stack([np.cos(PHI), np.sin(PHI),
                            np.zeros(len(PHI))], -1)
    elif k == GS.TRIANGLE:
      v0, v1, v2 = p[0:3], p[3:6], p[6:9]
      m = max(1, int(round(np.sqrt(n))))
      pts, normals = [], []
      nrm = np.cross(v1 - v0, v2 - v0)
      nrm = nrm / np.linalg.norm(nrm)
      for i in range(m):
        for j in range(m - i):
          a, b = (i + 0.5) / m, (j + 0.5) / m
          pts.append(v0 + a * (v1 - v0) + b * (v2 - v0))
          normals.append(nrm)
      pts, normals = np.array(pts), np.array(normals)
    else:
      raise ValueError(f'unknown surface kind {k}')
    return pts, normals * self.orient


class SurfaceSource(GenericSource):

  def _properties(self):
    return [
        ('OpticalEmission', [
            ('ActiveSurfaces', [],
             'list of group labels (all faces emit) or (groupLabel, '
             'surfaceIndex) pairs for individual faces (reference: '
             'surface_source.py:35-37)'),
            ('PowerDensity', 'cos(theta)**2',
             'emitted power per solid angle per surface element, in theta'),
            ('Wavelength', 500., 'emission wavelength in nm'),
            ('ThetaDomain', '0, pi/2', ''),
        ]),
        ('OpticalSimulationSettings', [
            ('RandomNumberGeneratorMode', '?', ''),
            ('ThetaResolutionNumericMode', '1e5', ''),
            ('UVSamplingInitialResolution', '5', 'parity; analytic faces '
                                                 'sample in closed form'),
            ('UVSamplingMaxRelAreaElementChange', '0.1', 'parity'),
            ('FanModeRayCount', 100,
             'total rays over all emitting faces in fan mode'),
        ]),
    ] + self._baseProperties()

  def __init__(self, scene=None, placement=None, **kwargs):
    self._scene = scene
    super().__init__(placement=placement, **kwargs)
    self._vrv = None
    self._deviceTables = None

  def attachScene(self, scene):
    self._scene = scene

  def parsedThetaDomain(self):
    return parseDomain(self.ThetaDomain, default='0,pi/2',
                       limits=('-20*pi', '20*pi'), spanLimits=(0, '20*pi'))[1]

  def emissionBound(self):
    '''Conservative world-frame emission envelope (originCenter, axis,
    cosAlpha, originRadius), the contract of PointSource.emissionBound.
    Only flat emitters (plane faces: constant normal) are bounded; curved
    faces return None. The direction cone is the cone around the mean face
    normal widened by the per-face normal spread plus the theta-domain
    maximum. The input of the trace steps' per-bounce surface culls.'''
    try:
      faces = self._activeFaces()
      _t1, t2 = self.parsedThetaDomain()
    except Exception:
      return None
    if not faces or not np.isfinite(t2):
      return None
    centers, radii, normals = [], [], []
    for f in faces:
      t = f.trim
      if f.kind != GS.PLANE or abs(t[0] - 2.) < .5:
        return None               # curved emitter, or a bitmap-trim chart
      rho = float(np.hypot(t[1], t[2])) if t[0] > 0.5 else float(t[2])
      if not np.isfinite(rho):
        return None
      nL = np.array([0., 0., 1.]) * (f.orient or 1.)
      M = np.asarray(f.transform, float)
      R, off = M[:3, :3], M[:3, 3]
      nW = R @ nL
      centers.append(off)
      radii.append(rho)
      normals.append(nW / max(np.linalg.norm(nW), 1e-30))
    axis = np.sum(normals, axis=0)
    nAxis = np.linalg.norm(axis)
    if nAxis < 1e-12:
      return None                 # opposing emitters: no useful cone
    axis = axis / nAxis
    spread = max(float(np.arccos(np.clip(float(n @ axis), -1., 1.)))
                 for n in normals)
    alpha = spread + min(float(t2), np.pi)
    if alpha >= np.pi:
      return None
    o = np.mean(centers, axis=0)
    rO = max(float(np.linalg.norm(c - o)) + r
             for c, r in zip(centers, radii))
    return o, axis, float(np.cos(alpha)), float(rO)

  def _getVrv(self):
    if self._vrv is None:
      self._vrv = distributions.ScalarRandomVariable(
          self.PowerDensity, variable='theta',
          variableDomain=self.parsedThetaDomain(),
          numericalResolution=float(self.ThetaResolutionNumericMode))
      self._vrv.compile()
      self.RandomNumberGeneratorMode = self._vrv.mode()
    return self._vrv

  def _getDeviceTables(self):
    if self._deviceTables is None:
      self._deviceTables = buildDeviceTables(self._getVrv())
    return self._deviceTables

  def _activeFaces(self):
    '''Resolve ActiveSurfaces into _Face adapters, one per (face,
    placement) instance.'''
    if self._scene is None:
      raise ValueError('SurfaceSource needs attachScene(scene) before '
                       'generating rays')
    faces = []
    for entry in self.ActiveSurfaces:
      if isinstance(entry, str):
        label, indices = entry, None
      else:
        label, indices = entry
        if np.isscalar(indices):
          indices = [indices]
      group = self._scene.getObject(label)
      specs = group.surfaces if indices is None else \
          [group.surfaces[i] for i in indices]
      for placement in group.placements:
        faces.extend(_Face(spec, placement) for spec in specs)
    if not faces:
      io.warn(f'surface source {self.Label} has no ActiveSurfaces selected '
              f'for emission')
    return faces

  def _makeBatch(self, faces, localPoints, localNormals, thetas, phis,
                 metadata):
    '''Transform per-face local samples to world rays.'''
    origins, directions = [], []
    for face, pts, nrm, th, ph in zip(faces, localPoints, localNormals,
                                      thetas, phis):
      R, off = face.transform[:3, :3], face.transform[:3, 3]
      ptsW = pts @ R.T + off
      nrmW = nrm @ R.T
      dirs = np.empty_like(nrmW)
      for i in range(len(ptsW)):
        n = nrmW[i] / np.linalg.norm(nrmW[i])
        # tangent: any stable vector orthogonal to n (reference uses the
        # face u-derivative; phi is uniform so the choice cancels out)
        ref = np.array([1., 0., 0.]) if abs(n[0]) < 0.9 \
            else np.array([0., 1., 0.])
        tang = np.cross(n, ref)
        tang /= np.linalg.norm(tang)
        d = _rodrigues(n, tang, th[i])
        d = _rodrigues(d, n, ph[i])
        dirs[i] = d
      origins.append(ptsW)
      directions.append(dirs)
    origins = np.concatenate(origins) if origins else np.zeros((0, 3))
    directions = np.concatenate(directions) if directions \
        else np.zeros((0, 3))
    n = len(origins)
    return dict(origins=origins, directions=directions,
                powers=np.ones(n),
                wavelengths=np.full(n, float(self.Wavelength)),
                metadata={k: np.concatenate(v) if len(v) else np.zeros(0)
                          for k, v in metadata.items()})

  def generateRays(self, mode, settings=None, maxFanCount=np.inf,
                   maxRaysPerFan=np.inf, rng=None):
    rng = rng or np.random.default_rng()
    faces = self._activeFaces()
    if not faces:
      return dict(origins=np.zeros((0, 3)), directions=np.zeros((0, 3)),
                  powers=np.zeros(0), wavelengths=np.zeros(0), metadata={})
    areas = np.array([f.area() for f in faces])
    weights = areas / areas.sum()

    if mode == 'fans':
      total = int(self.FanModeRayCount)

      def customRound(x):
        # {1,4,9} quantization (reference: surface_source.py:474-476)
        if x > 9:
          return int(round(x))
        return [1, 4, 9][int(np.argmin(np.abs(x - np.array([1, 4, 9]))))]

      counts = [customRound(w * total) for w in weights]
      skipFraction = max(0., 1 - total / max(sum(counts), 1))
      if skipFraction > 0.3:
        io.warn(f'cannot place rays on all surfaces within '
                f'FanModeRayCount={total}; skipping '
                f'{1e2*skipFraction:.0f}% of faces')
      pts, nrms, ths, phs = [], [], [], []
      meta = dict(initTheta=[], initPhi=[])
      faceI = 0.
      usedFaces = []
      for w, face, cnt in zip(weights, faces, counts):
        if skipFraction > 0:
          step = skipFraction / max(w * len(faces), 1e-12)
          if round(faceI) != round(faceI + step):
            faceI += step
            continue
          faceI += step
        p, nr = face.gridPositions(cnt)
        usedFaces.append(face)
        pts.append(p)
        nrms.append(nr)
        ths.append(np.zeros(len(p)))
        phs.append(np.zeros(len(p)))
        meta['initTheta'].append(np.zeros(len(p)))
        meta['initPhi'].append(np.zeros(len(p)))
      return self._makeBatch(usedFaces, pts, nrms, ths, phs, meta)

    if mode in ('true', 'pseudo'):
      raysPerIteration = 100
      if settings is not None:
        raysPerIteration = settings.raysPerIteration()
      n = max(1, int(round(raysPerIteration
                           * float(self.RaysPerIterationScale))))
      vrv = self._getVrv()
      # choose faces by area, then draw per-face positions in one batch each
      choice = rng.choice(len(faces), size=n, p=weights)
      pts, nrms, ths, phs = [], [], [], []
      meta = dict(initTheta=[], initPhi=[])
      usedFaces = []
      for fi in range(len(faces)):
        m = int(np.sum(choice == fi))
        if m == 0:
          continue
        p, nr = faces[fi].samplePositions(m, rng)
        if mode == 'pseudo':
          th = vrv.drawPseudo(N=m, rng=rng)[0] if m > 1 else \
              np.atleast_1d(vrv.draw(N=1, rng=rng))
        else:
          th = np.atleast_1d(vrv.draw(N=m, rng=rng))
        ph = rng.random(m) * 2 * np.pi
        usedFaces.append(faces[fi])
        pts.append(p)
        nrms.append(nr)
        ths.append(th)
        phs.append(ph)
        meta['initTheta'].append(th)
        meta['initPhi'].append(ph)
      return self._makeBatch(usedFaces, pts, nrms, ths, phs, meta)

    raise ValueError(f'unexpected ray placement mode {mode}')

  # ------------------------------------------------------------- device path

  def supportsDeviceSampling(self):
    try:
      return bool(self._scene is not None and self._activeFaces())
    except Exception:
      return False

  def _faceConstants(self):
    '''Per-face python-float constants for the device and kernel samplers:
    area-CDF windows, placement, kind parameters, and (aspheres, tori) the
    tabulated inverse area CDF `rInv`.'''
    faces = self._activeFaces()
    if not faces:
      return []
    areas = np.array([f.area() for f in faces])
    cum = np.concatenate([[0.], np.cumsum(areas / areas.sum())])
    cum[-1] = 1.0 + 1e-7      # catch u == 1 - ulp in the last window
    out = []
    for i, f in enumerate(faces):
      d = dict(kind=int(f.kind),
               params=tuple(float(x) for x in f.params),
               trim=tuple(float(x) for x in f.trim),
               orient=float(f.orient),
               R=tuple(tuple(float(x) for x in row)
                       for row in f.transform[:3, :3]),
               off=tuple(float(x) for x in f.transform[:3, 3]),
               cumLo=float(cum[i]), cumHi=float(cum[i + 1]))
      if f.kind == GS.ASPHERE:
        d['rInv'] = _asphereRadiusCdf(f)
      elif f.kind == GS.TORUS:
        d['rInv'] = _torusTubeAngleCdf(f)
      out.append(d)
    return out

  def _thetaSpec(self):
    '''The theta marginal as the kernel's sampler takes it: an affine map
    or a piecewise Horner fit of the inverse CDF; None when the density has
    discrete events or its inverse is too sharp to fit.'''
    t = self._getDeviceTables()['tables'][0]
    if int(t['discreteVals'].shape[0]):
      return None
    affine, lo, hi = t['affine']
    if affine:
      return ('affine', float(lo), float(hi))
    return fitPiecewisePoly(np.asarray(t['invCdf'][0], float))

  def samplerSpec(self):
    '''In-kernel sampling descriptor for the trace kernels (ops/cuda_trace,
    `type='surface'`): the per-face closed-form position constants and the
    theta marginal. Same dict as the JAX package's `pallasSamplerSpec()`.
    None when there are no faces or more than 32, or the theta inverse
    cannot be represented in the kernel — callers then feed the kernel ray
    columns from `deviceColumnsGenerator`.'''
    faces = self._faceConstants()
    if not faces or len(faces) > MAX_SAMPLER_FACES:
      return None
    thetaSpec = self._thetaSpec()
    if thetaSpec is None:
      return None
    specFaces = []
    for f in faces:
      f = dict(f)
      if 'rInv' in f:       # tabulated-parameter kinds (asphere r, torus v)
        rSpec = fitPiecewisePoly(f.pop('rInv'))
        if rSpec is None:
          return None
        f['rSpec'] = rSpec
      specFaces.append(f)
    return dict(type='surface', faces=tuple(specFaces), theta=thetaSpec,
                wavelength=float(self.Wavelength))

  def deviceColumnsGenerator(self, device='cuda'):
    '''Column-form device generator (the twin of
    PointSource.deviceColumnsGenerator): returns
    `generate(generator, N, stratified=False, uniforms=None) ->
    dict(ox..dz, pw, wl, _theta, _phi, _face)`, every field a flat float32
    (N,) tensor on `device`: faces area-proportionally, positions
    area-uniformly per kind in closed form, theta from the compiled
    PowerDensity inverse CDF, phi uniformly. `generator` is a
    torch.Generator on that device; `uniforms` ((5, N): face, u, v, theta
    quantile, phi quantile — the kernel sampler's draw order) replaces its
    draws (the tests' seam).'''
    dev = resolveDevice(device)
    faces = self._faceConstants()
    if not faces:
      raise ValueError('surface source has no active faces')
    tables = self._getDeviceTables()
    wavelength = float(self.Wavelength)

    def generate(generator, N, stratified=False, uniforms=None):
      if uniforms is None:
        uF, u, v = torch.rand((3, N), generator=generator, device=dev,
                              dtype=torch.float32)
        theta = deviceDraw(tables, generator, N, stratified=stratified,
                           device=dev)[0]
        uP = torch.rand((N,), generator=generator, device=dev,
                        dtype=torch.float32)
      else:
        uF, u, v, uT, uP = uniforms
        theta = deviceDraw(tables, None, N, device=dev, uniforms=uT[None])[0]
      phi = uP * _f32(2. * np.pi)
      cols = surfaceSampleColumns(faces, uF, u, v, theta, phi, wavelength)
      cols['_theta'] = theta
      cols['_phi'] = phi
      cols['_face'] = faceIndexColumn(faces, uF)
      return cols

    return generate

  def deviceGenerator(self, device='cuda'):
    '''Like `deviceColumnsGenerator`, plus each ray's metadata:
    `generate(generator, N, stratified=False) -> (columns, metadata)` with
    metadata initTheta, initPhi and faceIndex (the JAX package's
    `deviceGenerator` metadata).'''
    columns = self.deviceColumnsGenerator(device=device)

    def generate(generator, N, stratified=False):
      c = columns(generator, N, stratified=stratified)
      return c, dict(initTheta=c['_theta'], initPhi=c['_phi'],
                     faceIndex=c['_face'])

    return generate


def _f32(x):
  return float(np.float32(x))


def faceIndexColumn(faces, uF):
  '''The index of the face each face quantile `uF` selects (float32).'''
  idx = torch.zeros_like(uF)
  for i, f in enumerate(faces[1:], start=1):
    idx = torch.where(uF >= _f32(f['cumLo']), float(i), idx)
  return idx


def faceSamplingConstants(face):
  '''The four float32 constants of a face's closed-form position sampling,
  each formed in double from the face's parameters and rounded once, as the
  reference's python constants are (the kernel's sampler block holds the
  same four):
    plane rectangle  (half-width x, half-width y, 0, 0)
    plane disc       (rOut**2 - rIn**2, rIn**2, 0, 0)
    sphere zone      (z1, z2 - z1, R**2, 1 / R)
    cylinder         (z1, z2 - z1, R, 0)
    cone             (A1, A2 - A1, r0**2, 2 tanA) with A = r0 z + tanA z^2 / 2
    other kinds      (0, 0, 0, 0): see `faceExtraConstants`'''
  k, p, t = face['kind'], face['params'], face['trim']
  if k == GS.PLANE:
    if t[0] > 0.5:
      return (t[1], t[2], 0., 0.)
    return (t[2] ** 2 - t[1] ** 2, t[1] ** 2, 0., 0.)
  if k == GS.SPHERE:
    return (t[1], t[2] - t[1], p[0] ** 2, 1.0 / p[0])
  if k == GS.CYLINDER:
    return (t[1], t[2] - t[1], p[0], 0.)
  if k == GS.CONE:
    r0, tanA, z1, z2 = p[0], p[1], t[1], t[2]
    A1 = r0 * z1 + tanA * z1 * z1 / 2.
    A2 = r0 * z2 + tanA * z2 * z2 / 2.
    return (A1, A2 - A1, r0 ** 2, 2. * tanA)
  return (0., 0., 0., 0.)


def faceExtraConstants(face):
  '''The twelve further float32 constants of a face of kind cone,
  asphere, torus or triangle (the kernel's face row from F_X), each formed
  in double and rounded once:
    cone      r0, 1 / tanA, tanA, 1 / sqrt(1 + tanA^2), tanA times that,
              z1, z2 - z1, 1 where |tanA| < 1e-12 (z is then linear in u)
    asphere   (offset of its radius marginal), c, (1 + k) c^2, a4, a6, a8,
              4 a4, 6 a6, 8 a8
    torus     (offset of its tube-angle marginal), R, r
    triangle  v0, v1 - v0, v2 - v0, the unit normal'''
  k, p, t = face['kind'], face['params'], face['trim']
  out = np.zeros(12)
  if k == GS.CONE:
    r0, tanA = p[0], p[1]
    small = abs(tanA) < 1e-12
    ninv = 1.0 / np.sqrt(1. + tanA * tanA)
    out[:8] = (r0, 0. if small else 1.0 / tanA, tanA, ninv, tanA * ninv,
               t[1], t[2] - t[1], float(small))
  elif k == GS.ASPHERE:
    c0, kk, a4, a6, a8 = p[0:5]
    out[1:9] = (c0, (1. + kk) * c0 * c0, a4, a6, a8, 4. * a4, 6. * a6,
                8. * a8)
  elif k == GS.TORUS:
    out[1:3] = (p[0], p[1])
  elif k == GS.TRIANGLE:
    v0, v1, v2 = (np.array(p[i:i + 3], float) for i in (0, 3, 6))
    nrm = np.cross(v1 - v0, v2 - v0)
    out[:] = np.concatenate([v0, v1 - v0, v2 - v0, nrm / np.linalg.norm(nrm)])
  return tuple(float(x) for x in out)


def localSampleColumns(face, u, v, rCol=None):
  '''Local position + canonical normal of one face from two float32
  uniform columns, in closed form per kind, in the reference's operation
  order (`_localSampleColumns`); `rCol` is an asphere's radius or a torus's
  tube angle, drawn from the face's inverse CDF by the caller. `face` is a
  dict of python floats. Returns (lx, ly, lz, nlx, nly, nlz) with the
  orient flip NOT yet applied.'''
  k, t = face['kind'], face['trim']
  c0, c1, c2, c3 = (_f32(c) for c in faceSamplingConstants(face))
  X = [_f32(c) for c in faceExtraConstants(face)]
  one = torch.ones_like(u)
  zero = torch.zeros_like(u)
  a = _f32(2. * np.pi) * v
  if k == GS.PLANE:
    if t[0] > 0.5:
      return ((2. * u - 1.) * c0, (2. * v - 1.) * c1, zero, zero, zero, one)
    r = torch.sqrt(u * c0 + c1)
    return r * torch.cos(a), r * torch.sin(a), zero, zero, zero, one
  if k in (GS.SPHERE, GS.CYLINDER):
    z = c0 + u * c1
    if k == GS.SPHERE:
      rr = torch.sqrt(torch.clamp(c2 - z * z, min=0.))
      lx, ly = rr * torch.cos(a), rr * torch.sin(a)
      return lx, ly, z, lx * c3, ly * c3, z * c3
    ca, sa = torch.cos(a), torch.sin(a)
    return c2 * ca, c2 * sa, z, ca, sa, zero
  if k == GS.CONE:
    r0, invTan, tanA, ninv, tanNinv, z1, dz, small = X[:8]
    if small:
      z = z1 + u * dz
    else:
      target = c0 + u * c1
      disc = torch.fmax(c2 + c3 * target, zero)
      z = (-r0 + torch.sqrt(disc)) * invTan
    ca, sa = torch.cos(a), torch.sin(a)
    rr = r0 + z * tanA
    return rr * ca, rr * sa, z, ca * ninv, sa * ninv, zero - tanNinv
  if k == GS.ASPHERE:
    r = rCol
    _off, cc, K1, a4, a6, a8, K4, K6, K8 = X[:9]
    r2 = r * r
    root = torch.sqrt(torch.fmax(1. - K1 * r2, torch.full_like(r2, 1e-12)))
    opr = 1. + root
    sag = cc * r2 / opr + r2 * r2 * (a4 + r2 * (a6 + r2 * a8))
    g = (cc * (torch.full_like(opr, 2.) / opr + K1 * r2 / (root * (opr * opr)))
         + K4 * r2 + K6 * r2 * r2 + K8 * (r2 * (r2 * r2)))
    ca, sa = torch.cos(a), torch.sin(a)
    ninv = torch.rsqrt(g * g * r2 + 1. + 1e-20)
    return (r * ca, r * sa, sag, -g * r * ca * ninv, -g * r * sa * ninv,
            ninv)
  if k == GS.TORUS:
    R0, rT = X[1], X[2]
    ca, sa = torch.cos(a), torch.sin(a)
    cv, sv = torch.cos(rCol), torch.sin(rCol)
    rad = R0 + rT * cv
    return rad * ca, rad * sa, rT * sv, cv * ca, cv * sa, sv
  if k == GS.TRIANGLE:
    flip = u + v > 1.
    aa = torch.where(flip, 1. - u, u)
    bb = torch.where(flip, 1. - v, v)
    v0, e1, e2, n = X[0:3], X[3:6], X[6:9], X[9:12]
    return (v0[0] + aa * e1[0] + bb * e2[0],
            v0[1] + aa * e1[1] + bb * e2[1],
            v0[2] + aa * e1[2] + bb * e2[2],
            n[0] * one, n[1] * one, n[2] * one)
  raise ValueError(f'unknown surface kind {k}')


def faceParameterColumn(face, u):
  '''An asphere's radius or a torus's tube angle from the uniform `u`:
  the face's tabulated inverse CDF `rInv` interpolated as the reference's
  device generator does, or, in a kernel sampler spec, its piecewise
  polynomial fit `rSpec`. None for the closed-form kinds.'''
  if face['kind'] not in (GS.ASPHERE, GS.TORUS):
    return None
  if 'rInv' in face:
    tab = torch.as_tensor(np.asarray(face['rInv'], np.float32),
                          device=u.device)
    K = tab.shape[0]
    pos = u * float(K - 1)
    j = torch.clamp(pos.to(torch.int32), 0, K - 2).to(torch.int64)
    return tab[j] + (pos - j.to(u.dtype)) * (tab[j + 1] - tab[j])
  return evalPwpoly(face['rSpec'], u)


def rotColumns(vx, vy, vz, ax, ay, az, ang):
  '''Rodrigues rotation of column vectors v about unit axes a by `ang`.'''
  c, s = torch.cos(ang), torch.sin(ang)
  cx = ay * vz - az * vy
  cy = az * vx - ax * vz
  cz = ax * vy - ay * vx
  dot = ax * vx + ay * vy + az * vz
  return (vx * c + cx * s + ax * dot * (1. - c),
          vy * c + cy * s + ay * dot * (1. - c),
          vz * c + cz * s + az * dot * (1. - c))


def surfaceSampleColumns(faces, uF, u, v, theta, phi, wavelength):
  '''World-frame ray columns from the per-face constants and the uniform /
  theta / phi columns (float32 tensors): the face whose area-CDF window
  [cumLo, cumHi) holds uF (scanned in face order; none: origin 0, normal
  +z), its closed-form local position and normal, the placement, `orient`;
  then direction = Rot(n, phi) Rot(tangent, theta) n with the tangent
  cross(n, x-hat), or cross(n, y-hat) where |n_x| >= 0.9. The reference's
  `_surfaceSampleColumns`, operation for operation; the kernels' sampler
  repeats it.'''
  zero = torch.zeros_like(uF)
  ox, oy, oz = zero, zero, zero
  nx, ny, nz = zero, zero, zero + 1.
  for f in faces:
    m = (uF >= _f32(f['cumLo'])) & (uF < _f32(f['cumHi']))
    lx, ly, lz, nlx, nly, nlz = localSampleColumns(
        f, u, v, faceParameterColumn(f, u))
    R = [[_f32(x) for x in row] for row in f['R']]
    off = [_f32(x) for x in f['off']]
    orient = _f32(f['orient'])
    wx = R[0][0] * lx + R[0][1] * ly + R[0][2] * lz + off[0]
    wy = R[1][0] * lx + R[1][1] * ly + R[1][2] * lz + off[1]
    wz = R[2][0] * lx + R[2][1] * ly + R[2][2] * lz + off[2]
    wnx = (R[0][0] * nlx + R[0][1] * nly + R[0][2] * nlz) * orient
    wny = (R[1][0] * nlx + R[1][1] * nly + R[1][2] * nlz) * orient
    wnz = (R[2][0] * nlx + R[2][1] * nly + R[2][2] * nlz) * orient
    ox = torch.where(m, wx, ox)
    oy = torch.where(m, wy, oy)
    oz = torch.where(m, wz, oz)
    nx = torch.where(m, wnx, nx)
    ny = torch.where(m, wny, ny)
    nz = torch.where(m, wnz, nz)
  ninv = torch.rsqrt(nx * nx + ny * ny + nz * nz + 1e-20)
  nx, ny, nz = nx * ninv, ny * ninv, nz * ninv
  useX = torch.abs(nx) < 0.9
  tx = torch.where(useX, zero, -nz)
  ty = torch.where(useX, nz, zero)
  tz = torch.where(useX, -ny, nx)
  tinv = torch.rsqrt(tx * tx + ty * ty + tz * tz + 1e-20)
  tx, ty, tz = tx * tinv, ty * tinv, tz * tinv
  dx, dy, dz = rotColumns(nx, ny, nz, tx, ty, tz, theta)
  dx, dy, dz = rotColumns(dx, dy, dz, nx, ny, nz, phi)
  dinv = torch.rsqrt(dx * dx + dy * dy + dz * dz + 1e-20)
  return dict(ox=ox, oy=oy, oz=oz,
              dx=dx * dinv, dy=dy * dinv, dz=dz * dinv,
              pw=torch.ones_like(uF),
              wl=torch.full_like(uF, wavelength))
