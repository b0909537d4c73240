'''
Histogram configuration of the fused Monte-Carlo path (counterpart of the
JAX package's tracing/fused.py `makeHistogramSpec` / `initHistograms`): one
(H, W) power + count histogram per recording element, binned in the
recording surface's local (x, y) frame. The fused step itself is
ops/cuda_trace.makeTraceStep.
'''

import numpy as np
import torch

from .. import hostArray, resolveDevice


def makeHistogramSpec(scene, info, recordElems=None, bounds=None,
                      bins=(128, 128)):
  '''Build the histogram config: which elements accumulate, one (H, W)
  histogram per recording element, binned over local-frame (x, y) `bounds`
  = (x0, x1, y0, y1) (shared, or dict label->bounds). Host numpy arrays:
  the spec is baked into the kernel's element table.'''
  elemLabels = info['elementLabels']
  recordFlags = hostArray(scene['elements']['recordHits'])
  if recordElems is None:
    recordElems = [i for i in range(len(elemLabels)) if recordFlags[i]]
  elemToDet = np.full(len(elemLabels), -1, dtype=np.int32)
  allBounds = []
  for d, e in enumerate(recordElems):
    elemToDet[e] = d
    b = bounds
    if isinstance(bounds, dict):
      b = bounds.get(elemLabels[e])
    if b is None:
      b = (-50., 50., -50., 50.)
    allBounds.append(b)
  return dict(elemToDet=elemToDet,
              bounds=np.asarray(allBounds, dtype=np.float32).reshape(-1, 4),
              bins=tuple(bins),
              detLabels=[elemLabels[e] for e in recordElems])


def initHistograms(histSpec, dtype=torch.float32, device='cuda'):
  '''Zeroed (D, H, W) power and count histograms on `device`. The trace
  step accumulates into these tensors IN PLACE (where the JAX step relied
  on buffer donation).'''
  dev = resolveDevice(device)
  D = histSpec['bounds'].shape[0]
  H, W = histSpec['bins']
  return dict(power=torch.zeros((D, H, W), dtype=dtype, device=dev),
              counts=torch.zeros((D, H, W), dtype=dtype, device=dev))
