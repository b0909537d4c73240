'''
Hit-cloud analysis: plane detection, 2-D projection, histograms and the
ray-fan math used by the physics-validation notebooks (reference:
jupyter_utils/hits.py:21-428).
'''

import functools

import numpy as np

from ..utils import io
from . import histogram

_NX, _NY, _NZ = (np.array([1., 0, 0]), np.array([0, 1., 0]),
                 np.array([0, 0, 1.]))


class Hits:
  '''Dict-like wrapper around a columnar hit record: points (N,3),
  directions (N,3), powers, isEntering + metadata columns.'''

  def __init__(self, hits):
    self.hits = dict(hits)

  def __iter__(self):
    return iter(self.hits.keys())

  def __len__(self):
    return len(self.points())

  def __getitem__(self, key):
    return self.hits[key]

  def items(self):
    return self.hits.items()

  def keys(self):
    return self.hits.keys()

  def values(self):
    return self.hits.values()

  def points(self):
    return np.asarray(self.hits.get('points', np.zeros((0, 3))))

  def directions(self):
    return np.asarray(self.hits.get('directions', np.zeros((0, 3))))

  def isEntering(self):
    return np.asarray(self.hits.get('isEntering', np.zeros(0)))

  def powers(self):
    return np.asarray(self.hits.get('powers', np.zeros(0)))

  # -------------------------------------------------------- point cloud math

  def planeProject3dPoints(self, points=None, planeNormal=None,
                           xInPlaneVec=None, returnZ=False):
    '''Project a 3-D point cloud onto the detector plane, returning (N,2)
    in-plane coordinates (reference: hits.py:58-90).'''
    if points is None:
      points = self.points()
    points = np.asarray(points, float)
    if planeNormal is None or xInPlaneVec is None:
      planeNormal, xInPlaneVec = self.detectPlaneNormal(
          planeNormal=planeNormal, xInPlaneVec=xInPlaneVec)
    projX = np.asarray(xInPlaneVec, float)
    X = points @ (projX / np.linalg.norm(projX))
    projY = np.cross(planeNormal, xInPlaneVec)
    Y = points @ (projY / np.linalg.norm(projY))
    if returnZ:
      n = np.asarray(planeNormal, float)
      Z = points @ (n / np.linalg.norm(n))
      return np.array([X, Y, Z]).T
    return np.array([X, Y]).T

  def detectPlaneNormal(self, points=None, directions=None, planeNormal=None,
                        xInPlaneVec=None, maxPointCountConsidered=300,
                        angleTol=1e-9):
    '''Coarse-to-fine spherical search for the normal minimizing the point
    cloud's span along it; sign disambiguated against the hit directions
    with the entering-ray heuristic (reference: hits.py:92-170).'''
    if points is None:
      points = self.points()
    if directions is None:
      directions = self.directions()
      isEntering = self.isEntering()
      if len(isEntering) and np.sum(isEntering == 0) < .51 * len(isEntering):
        directions = directions[isEntering != 0]
    points = np.asarray(points, float)
    directions = np.asarray(directions, float)
    checkPoints = points[::1 + points.shape[0] // maxPointCountConsidered]
    checkDirs = (directions[::1 + directions.shape[0]
                            // maxPointCountConsidered]
                 if len(directions) else np.zeros((0, 3)))

    if planeNormal is None:
      phis = np.linspace(0, np.pi, 30)
      dphi = phis[1] - phis[0]
      thetas = np.linspace(-np.pi / 2, np.pi / 2, 30)
      dtheta = thetas[1] - thetas[0]
      while True:
        P, T = np.meshgrid(phis, thetas)
        P, T = P.ravel(), T.ravel()
        normals = np.stack([np.cos(P) * np.sin(T), np.sin(P) * np.sin(T),
                            np.cos(T)], axis=-1)
        spans = np.ptp(checkPoints @ normals.T, axis=0)
        best = int(np.argmin(spans))
        phiOpt, thetaOpt = P[best], T[best]
        phis = np.linspace(phiOpt - 1.1 * dphi, phiOpt + 1.1 * dphi, 10)
        dphi = phis[1] - phis[0]
        thetas = np.linspace(thetaOpt - 1.1 * dtheta,
                             thetaOpt + 1.1 * dtheta, 10)
        dtheta = thetas[1] - thetas[0]
        if dphi < angleTol and dtheta < angleTol:
          break
      planeNormal = np.array([np.cos(phiOpt) * np.sin(thetaOpt),
                              np.sin(phiOpt) * np.sin(thetaOpt),
                              np.cos(thetaOpt)])
    planeNormal = np.asarray(planeNormal, float)

    # sign: point the normal against the incoming ray directions
    if len(checkDirs):
      projDirs = checkDirs @ planeNormal
      if np.quantile(projDirs, 0.1) > 0:
        planeNormal = -planeNormal
      elif np.quantile(projDirs, 0.9) < 0:
        pass
      else:
        if np.quantile(projDirs, 0.5) < 0:
          planeNormal = -planeNormal
        io.warn('unsure of result when trying to auto-detect sign of plane '
                'normal, avoid relying on the sign of the planeNormal')

    candidates = [_NX, _NY, _NZ] if xInPlaneVec is None else [xInPlaneVec]
    projY = sorted([np.cross(planeNormal, n) for n in candidates],
                   key=lambda x: -np.linalg.norm(x))[0]
    xInPlaneVec = np.cross(planeNormal, projY)
    if np.sum(xInPlaneVec) < 0:
      xInPlaneVec = -xInPlaneVec
    return planeNormal, xInPlaneVec

  def histogram(self, planeNormal=None, xInPlaneVec=None, key='points',
                weights=None, **kwargs):
    '''2-D Histogram of the projected hit cloud (reference:
    hits.py:172-189). Pass weights='powers' for power-weighted bins.'''
    points = self.hits[key]
    if planeNormal is None or xInPlaneVec is None:
      planeNormal, xInPlaneVec = self.detectPlaneNormal(planeNormal,
                                                        xInPlaneVec)
    proj = self.planeProject3dPoints(points, planeNormal=planeNormal,
                                     xInPlaneVec=xInPlaneVec)
    if isinstance(weights, str):
      weights = np.asarray(self.hits[weights])
    return histogram.Histogram(proj[:, 0], proj[:, 1],
                               planeNormal=planeNormal,
                               xInPlaneVec=xInPlaneVec, weights=weights,
                               **kwargs)

  def plot(self, hueKey=None, hueLabel=None, planeNormal=None,
           xInPlaneVec=None, plotKey='points', **kwargs):
    '''Scatter plot of the projected hit cloud (reference:
    hits.py:192-218).'''
    if plotKey not in self.hits:
      return
    import matplotlib.pyplot as plt
    if planeNormal is None or xInPlaneVec is None:
      planeNormal, xInPlaneVec = self.detectPlaneNormal(
          points=self.hits[plotKey], planeNormal=planeNormal,
          xInPlaneVec=xInPlaneVec)
    XY = self.planeProject3dPoints(self.hits[plotKey],
                                   planeNormal=planeNormal,
                                   xInPlaneVec=xInPlaneVec)
    try:
      import seaborn as sns
      import pandas as pd
      data = {'projected $x$': XY[:, 0], 'projected $y$': XY[:, 1]}
      if hueKey is not None:
        data[hueLabel or hueKey] = self.hits[hueKey]
      sns.scatterplot(pd.DataFrame(data), x='projected $x$',
                      y='projected $y$',
                      **(dict(hue=hueLabel or hueKey, palette='hls')
                         if hueKey else {}), **kwargs)
    except ImportError:
      c = self.hits[hueKey] if hueKey else None
      plt.scatter(XY[:, 0], XY[:, 1], c=c, s=3, **kwargs)
    nx, ny, nz = planeNormal
    px, py, pz = xInPlaneVec
    plt.title(f'plane normal = [{nx:.2f}, {ny:.2f}, {nz:.2f}],\n'
              f'projected $x$ = [{px:.2f}, {py:.2f}, {pz:.2f}]', fontsize=10)
    plt.gca().set_aspect('equal')
    plt.tight_layout()

  # ----------------------------------------------------------------- fan math

  def supportsFanMath(self):
    return all(k in self.hits for k in
               ('rayIndex', 'fanIndex', 'totalRaysInFan'))

  def _raiseIfNotFanMath(self):
    if not len(self.hits):
      raise ValueError('keys rayIndex, fanIndex and totalRaysInFan must '
                       'exist in hits dictionary, but hits dictionary is '
                       'empty')
    if not self.supportsFanMath():
      raise ValueError('keys rayIndex, fanIndex and totalRaysInFan must '
                       'exist in hits dictionary, make sure you simulated '
                       'in fan mode and enabled storing the respective '
                       'metadata keys in the active SimulationSettings')

  def raysPerFan(self):
    self._raiseIfNotFanMath()
    return self.hits['totalRaysInFan'][0]

  def allRayIndices(self, fanI=None):
    rI = np.asarray(self.hits['rayIndex'])
    fI = np.asarray(self.hits['fanIndex'])
    if fanI is not None:
      return np.array(sorted(set(rI[fI == fanI])))
    return np.array(sorted(set(rI)))

  def fanCount(self):
    self._raiseIfNotFanMath()
    return len(set(np.asarray(self.hits['fanIndex']).tolist()))

  def fanCenter(self, **kwargs):
    '''In-plane fan center: position of the rayIndex-0 ray, or the average
    of +1/-1 (reference: hits.py:347-365).'''
    self._raiseIfNotFanMath()
    rI = np.asarray(self.hits['rayIndex']).astype(int)
    fI = np.asarray(self.hits['fanIndex']).astype(int)
    pXY = self.planeProject3dPoints(self.points(), **kwargs)
    centers = []
    for fanI in set(fI.tolist()):
      sel = fI == fanI
      if 0 in rI[sel]:
        centers.extend(pXY[sel & (rI == 0)])
      elif +1 in rI[sel] and -1 in rI[sel]:
        centers.extend((pXY[sel & (rI == +1)] + pXY[sel & (rI == -1)]) / 2)
    if centers:
      return np.mean(centers, axis=0)
    return np.array([np.nan, np.nan])

  @functools.lru_cache(maxsize=8)
  def _calcFanDensityEtc(self, pCenter=None):
    '''Per-ray-trio neighbor distances, signed center distances and
    curvatures (reference: hits.py:250-333).'''
    self._raiseIfNotFanMath()
    rI = np.asarray(self.hits['rayIndex']).astype(int)
    fI = np.asarray(self.hits['fanIndex']).astype(int)
    trf = np.asarray(self.hits['totalRaysInFan'])
    pXY = self.planeProject3dPoints(self.points())
    if pCenter is None:
      pCenter = tuple(self.fanCenter())
    pCenter = np.asarray(pCenter, float)

    centerDists, neighborDists, curvs = [], [], []
    missingRays, skippedRays = 0, 0
    for fanI in sorted(set(fI.tolist())):
      sel = fI == fanI
      rayIs = sorted(set(rI[sel].tolist()))
      missingRays += np.mean(trf[sel]) - len(rayIs)
      skippedRays += int(np.sum(np.diff(rayIs) - 1)) if len(rayIs) > 1 else 0

      # mean per-ray positions
      pos = {i: pXY[sel & (rI == i)].mean(axis=0) for i in rayIs}

      # likely directions of +/- ray indices for center-distance signs
      def meanDir(mask):
        vecs = pXY[sel & mask] - pCenter
        if not len(vecs):
          return None
        norms = np.linalg.norm(vecs, axis=1)
        norms[norms == 0] = 1
        return np.mean(vecs / norms[:, None], axis=0)

      posDir = meanDir(rI > 0)
      negDir = meanDir(rI < 0)
      if posDir is None and negDir is None:
        posDir, negDir = np.array([1., 0]), np.array([-1., 0])
      elif posDir is None:
        posDir = -negDir
      elif negDir is None:
        negDir = -posDir

      for j, i0 in enumerate(rayIs):
        p0 = pos[i0]
        i1 = rayIs[j - 1] if j > 0 else None
        i2 = rayIs[j + 1] if j + 1 < len(rayIs) else None
        if i1 is not None:
          neighborDists.append([fanI, (i0 + i1) / 2,
                                float(np.linalg.norm(pos[i1] - p0))])
        signP = float((p0 - pCenter) @ posDir)
        signN = float((p0 - pCenter) @ negDir)
        if signP > 0 and signN < 0:
          dSign = +1
        elif signP < 0 and signN > 0:
          dSign = -1
        else:
          if signP != 0 and signN != 0:
            io.warn('unsure about center distance value signs, the fan-hit '
                    'pattern is probably very asymmetric')
          dSign = np.sign(signP - signN) or 1
        centerDists.append([fanI, i0,
                            float(np.linalg.norm(p0 - pCenter)) * dSign])
        if i1 is not None and i2 is not None:
          (x0, y0), (x1, y1), (x2, y2) = p0, pos[i1], pos[i2]
          denom = np.hypot(y2 - y1, x2 - x1)
          if denom > 0:
            curvs.append([fanI, i0,
                          abs((y2 - y1) * x0 - (x2 - x1) * y0
                              + x2 * y1 - y2 * x1) / denom])
    return dict(centerDists=np.array(centerDists),
                neighborDists=np.array(neighborDists),
                curvs=np.array(curvs), missingRays=missingRays,
                skippedRays=skippedRays)

  def fanMissingRays(self):
    return self._calcFanDensityEtc()['missingRays']

  def fanSkippedRays(self):
    return self._calcFanDensityEtc()['skippedRays']

  def fanCenterDists(self, pCenter=None):
    return self._calcFanDensityEtc(
        pCenter=None if pCenter is None else tuple(pCenter))['centerDists'].T

  def fanNeighborDists(self):
    return self._calcFanDensityEtc()['neighborDists'].T

  def fanCurvs(self):
    return self._calcFanDensityEtc()['curvs'].T

  @functools.lru_cache(maxsize=8)
  def _fanPowerDensityEtc(self, pCenter=None):
    '''Per-fan reconstructed power density = 1/neighbor-spacing vs signed
    center distance, with caustic detection when the radial ordering
    reverses (reference: hits.py:370-416).'''
    if pCenter is None:
      pCenter = tuple(self.fanCenter())
    nfI, nrI, ndist = self.fanNeighborDists()
    cfI, crI, cdist = self.fanCenterDists(pCenter=pCenter)

    fanDensities, causticIntensities = {}, {}
    for fanI in sorted(set(nfI.tolist())):
      fanDensities[fanI] = []
      causticIntensities[fanI] = []
      for interRayI in sorted(nrI[nfI == fanI]):
        cr1 = int(round(interRayI - .6))
        cr2 = int(round(interRayI + .6))
        sel1 = (cfI == fanI) & (crI == cr1)
        sel2 = (cfI == fanI) & (crI == cr2)
        if not sel1.any() or not sel2.any():
          continue
        cdist1, cdist2 = np.mean(cdist[sel1]), np.mean(cdist[sel2])
        estPower = 1 / np.mean(ndist[(nfI == fanI) & (nrI == interRayI)])
        if cdist2 < cdist1:
          causticIntensities[fanI].append([cdist2, cdist1, estPower])
        else:
          fanDensities[fanI].append([np.mean([cdist1, cdist2]), estPower])

    fanDensityFuncs = {
        i: (lambda pos, _d=np.array(d).T: np.interp(pos, *_d, left=0,
                                                    right=0))
        for i, d in fanDensities.items() if len(d)}
    causticIntensityFuncs = {
        i: (lambda p1, p2, _d=np.array(d): sum(
            p for r1, r2, p in _d
            if r1 <= max(p1, p2) and min(p1, p2) <= r2))
        for i, d in causticIntensities.items()}
    return dict(fanDensities=fanDensities, fanDensityFuncs=fanDensityFuncs,
                causticIntensities=causticIntensities,
                causticIntensityFuncs=causticIntensityFuncs,
                pCenter=pCenter)

  def fanEstimatedPowerDensities(self, pCenter=None):
    d = self._fanPowerDensityEtc(
        pCenter=None if pCenter is None else tuple(pCenter))
    return {i: np.array(v).T for i, v in d['fanDensities'].items()}

  def fanEstimatedPowerDensityFuncs(self, pCenter=None):
    return self._fanPowerDensityEtc(
        pCenter=None if pCenter is None else tuple(pCenter))['fanDensityFuncs']

  def fanEstimatedCausticIntensities(self, pCenter=None):
    d = self._fanPowerDensityEtc(
        pCenter=None if pCenter is None else tuple(pCenter))
    return {i: np.array(v).T for i, v in d['causticIntensities'].items()}

  def fanEstimatedCausticIntensityFuncs(self, pCenter=None):
    return self._fanPowerDensityEtc(
        pCenter=None if pCenter is None else tuple(pCenter))[
            'causticIntensityFuncs']
