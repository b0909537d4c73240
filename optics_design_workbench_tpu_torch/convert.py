'''
State carried across from the JAX package: turn what it produces — as plain
numpy arrays and python values, handed over by the caller — into the port's
kernel tables. The port itself never imports that package; the tests pull
the arrays out of it and call this.
'''

import numpy as np

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
