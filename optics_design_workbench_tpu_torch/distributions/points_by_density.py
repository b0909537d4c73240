'''
Deterministic 1-D grid generation with point density proportional to a given
density function (reference: distributions/points_by_density.py:25-38).
Used by ray-fan mode to place a fixed number of rays per fan such that their
local spacing follows the emission power density.
'''

import numpy as np


def calcHistDensity(X, bins=None):
  '''Normalized histogram density of samples X (reference:
  points_by_density.py:14-17).'''
  H, edges = np.histogram(X, **({} if bins is None else {'bins': bins}))
  return (edges[1:] + edges[:-1]) / 2, H / np.sum(H)


def calcDiffDensity(X):
  '''Density estimate from inverse neighbor spacing of sorted samples
  (reference: points_by_density.py:19-23).'''
  X = np.array(sorted(X))
  diffs = X[1:] - X[:-1]
  density = 1 / np.maximum(diffs, 1e-30)
  return (X[1:] + X[:-1]) / 2, density / np.sum(density)


def generatePointsWithGivenDensity1D(density, N, startFrom=None):
  '''
  Return N points in the domain of the sampled density `(X, Y)` whose local
  spacing is inversely proportional to Y: integrate Y cumulatively, normalize
  the integral to [0,1], then inverse-map N equally spaced quantiles. The
  domain endpoints are pinned as first/last point (reference:
  points_by_density.py:25-38; `startFrom` is accepted for signature parity
  but, exactly as in the reference, does not alter the result).
  '''
  X, Y = np.asarray(density[0], dtype=float), np.asarray(density[1], dtype=float)
  # integration nodes sit between the sample positions, plus half-step
  # extensions at both ends so the CDF brackets the full domain
  Xi = np.concatenate([[X[0] - (X[1] - X[0]) / 2],
                       (X[:-1] + X[1:]) / 2,
                       [X[-1] + (X[-1] - X[-2]) / 2]])
  Yi = np.concatenate([[0], np.cumsum(Y)])
  Yi = (Yi - Yi.min()) / (Yi.max() - Yi.min())
  # inverse-map equally spaced quantiles; endpoints pinned explicitly
  Ypick = np.linspace(0, 1, int(round(N)))[1:-1]
  return np.concatenate([[X[0]], np.interp(Ypick, Yi, Xi), [X[-1]]])
