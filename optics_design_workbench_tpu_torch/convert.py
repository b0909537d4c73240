'''
State carried across from the JAX package: turn what it produces — as plain
numpy arrays and python values, handed over by the caller — into the port's
kernel tables. The port itself never imports that package; the tests pull
the arrays out of it and call this.
'''

import numpy as np
import torch

from . import resolveDevice
from .ops import cuda_trace


def sceneFromReference(deviceNp, histSpecNp, samplerSpec=None, device='cuda'):
  '''Build the trace kernel's tables from the JAX package's outputs:

    deviceNp     the dict of numpy arrays from
                 `Scene.compile(devicePut=False)`: `surfaces` with `packed`,
                 `trim`, `kind`; `elements` with `packed`, `optType`,
                 `recordHits` (extra keys are ignored, except that
                 `scatter`, `seqMask`, `surfMask` and `nTable` are refused
                 as not ported yet);
    histSpecNp   the histogram spec: `elemToDet`, `bounds`, `bins`;
    samplerSpec  optionally the dict from `pallasSamplerSpec()`.

  Returns what `ops.cuda_trace.buildTraceTables` returns, on `device`.'''
  scene = dict(
      surfaces={k: np.asarray(deviceNp['surfaces'][k])
                for k in ('packed', 'trim', 'kind')},
      elements={k: np.asarray(deviceNp['elements'][k])
                for k in ('packed', 'optType', 'recordHits')})
  for key in ('scatter', 'seqMask', 'surfMask'):
    if key in deviceNp:
      scene[key] = deviceNp[key]
  if 'nTable' in deviceNp['elements']:
    scene['elements']['nTable'] = deviceNp['elements']['nTable']
  histSpec = dict(elemToDet=np.asarray(histSpecNp['elemToDet']),
                  bounds=np.asarray(histSpecNp['bounds'],
                                    dtype=np.float32).reshape(-1, 4),
                  bins=tuple(int(b) for b in histSpecNp['bins']))
  return cuda_trace.buildTraceTables(scene, histSpec,
                                     samplerSpec=samplerSpec, device=device)


_RECORD_DTYPES = dict(recordHit=torch.bool, hitElem=torch.int32,
                      power=torch.float32, isEntering=torch.bool,
                      point=torch.float32, direction=torch.float32)


def recordsFromReference(recordsNp, device='cuda'):
  '''Hit records of the JAX package's raw step (`makePallasRawStep`, or
  the record tracer), handed over as numpy arrays, as the dict of tensors
  that `ops.cuda_trace.makeRawStep` returns: `recordHit`, `hitElem`,
  `power`, `isEntering` (S, N) and `point`, `direction` (S, N, 3).'''
  dev = resolveDevice(device)
  return {k: torch.as_tensor(np.array(recordsNp[k]), device=dev).to(dtype)
          for k, dtype in _RECORD_DTYPES.items()}


def recordsToNumpy(records):
  '''The records of `makeRawStep` (or the JAX package's, or anything
  array-like with the same keys) as host numpy arrays, so a test can put
  the two packages' records side by side.'''
  return {k: (records[k].detach().cpu().numpy()
              if isinstance(records[k], torch.Tensor)
              else np.asarray(records[k])) for k in _RECORD_DTYPES}
