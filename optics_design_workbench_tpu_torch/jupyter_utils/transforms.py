'''Small transform helpers (reference: jupyter_utils/transforms.py:3-8).'''

import numpy as np


def applyTransformation(points, matrix):
  '''Apply a 4x4 affine transform to an (N,3) point cloud.'''
  points = np.asarray(points, dtype=float)
  matrix = np.asarray(matrix, dtype=float)
  return points @ matrix[:3, :3].T + matrix[:3, 3]
