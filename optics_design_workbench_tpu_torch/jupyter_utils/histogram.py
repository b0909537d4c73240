'''
2-D histograms of projected hit clouds, cartesian or polar with proper
annular bin areas (reference: jupyter_utils/histogram.py:20-162).
'''

import numpy as np


class Histogram:

  def __init__(self, X, Y, planeNormal=None, xInPlaneVec=None, radius=None,
               bins=51, binCoords='cartesian', origin=None, weights=None):
    '''
    binCoords='cartesian': regular 2-D histogram over (X, Y).
    binCoords='polar': (phi, r) bins around `origin` (default median of the
    cloud) with bin values normalized by the true annular-sector areas.
    '''
    self.X, self.Y = np.asarray(X, float), np.asarray(Y, float)
    self.planeNormal = planeNormal
    self.xInPlaneVec = xInPlaneVec
    self.binCoords = binCoords
    if origin is None:
      origin = (np.median(self.X), np.median(self.Y)) if len(self.X) else (0., 0.)
    self.origin = np.asarray(origin, float)

    if binCoords == 'cartesian':
      rng = None
      if radius is not None:
        rng = [[self.origin[0] - radius, self.origin[0] + radius],
               [self.origin[1] - radius, self.origin[1] + radius]]
      self.hist, self.xEdges, self.yEdges = np.histogram2d(
          self.X, self.Y, bins=bins, range=rng, weights=weights)
      binArea = np.outer(np.diff(self.xEdges), np.diff(self.yEdges))
      self.density = self.hist / np.maximum(binArea, 1e-300)
    elif binCoords == 'polar':
      dx, dy = self.X - self.origin[0], self.Y - self.origin[1]
      r = np.hypot(dx, dy)
      phi = np.arctan2(dy, dx)
      if np.isscalar(bins):
        bins = (bins, bins)
      # radius=None spans the DATA's radial range like the reference's
      # numpy-default binning (histogram.py:74-76) — an annular hit cloud
      # gets bins over (rMin, rMax), not (0, rMax), so empty inner bins
      # don't exist
      rRange = [r.min(), r.max()] if len(r) else [0., 1.]
      if radius is not None:
        rRange = [0., radius]
      self.hist, self.phiEdges, self.rEdges = np.histogram2d(
          phi, r, bins=bins, range=[[-np.pi, np.pi], rRange],
          weights=weights)
      # annular sector areas: dphi/2 * (r2^2 - r1^2)
      dphi = np.diff(self.phiEdges)
      areas = np.outer(dphi / 2, self.rEdges[1:] ** 2 - self.rEdges[:-1] ** 2)
      self.density = self.hist / np.maximum(areas, 1e-300)
      self.xEdges, self.yEdges = self.phiEdges, self.rEdges
    else:
      raise ValueError(f'unknown binCoords {binCoords!r}')

  def centers(self):
    return ((self.xEdges[1:] + self.xEdges[:-1]) / 2,
            (self.yEdges[1:] + self.yEdges[:-1]) / 2)

  def byAzimuth(self, bins=None):
    '''Radial density profile per azimuth bin (polar mode), or averaged over
    all azimuths (reference: histogram.py:146-162). Returns (rCenters,
    profile (nPhi, nR)).'''
    if self.binCoords != 'polar':
      raise ValueError('byAzimuth requires binCoords="polar"')
    _, rC = self.centers()
    return rC, self.density

  def plot(self, ax=None, logScale=False, upsamplePhi=4, **kwargs):
    '''Plot the histogram; polar histograms use a polar projection with
    phi-upsampling for round plots (reference: histogram.py:87-144).'''
    import matplotlib.pyplot as plt
    if self.binCoords == 'cartesian':
      if ax is None:
        ax = plt.gca()
      data = np.log10(self.density + 1e-300) if logScale else self.density
      mesh = ax.pcolormesh(self.xEdges, self.yEdges, data.T, **kwargs)
      ax.set_aspect('equal')
      plt.colorbar(mesh, ax=ax)
      return ax
    # polar
    if ax is None or ax.name != 'polar':
      fig = plt.gcf()
      ax = fig.add_subplot(projection='polar')
    phiE = np.linspace(-np.pi, np.pi, (len(self.phiEdges) - 1)
                       * upsamplePhi + 1)
    dens = np.repeat(self.density, upsamplePhi, axis=0)
    data = np.log10(dens + 1e-300) if logScale else dens
    mesh = ax.pcolormesh(phiE, self.rEdges, data.T, **kwargs)
    plt.colorbar(mesh, ax=ax)
    return ax

  def plotByAzimuth(self, ax=None, **kwargs):
    import matplotlib.pyplot as plt
    if ax is None:
      ax = plt.gca()
    rC, prof = self.byAzimuth()
    phiC = (self.phiEdges[1:] + self.phiEdges[:-1]) / 2
    for i, row in enumerate(prof):
      ax.plot(rC, row, label=f'$\\phi$={phiC[i]:.2f}', **kwargs)
    ax.set_xlabel('r')
    ax.set_ylabel('density')
    return ax
