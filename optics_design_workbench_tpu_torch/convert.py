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


def sceneFromReference(deviceNp, histSpecNp, samplerSpec=None, device='cuda',
                       emissionBound=None, maxIntersections=0):
  '''Build the trace kernel's tables from the JAX package's outputs:

    deviceNp     the dict of numpy arrays from
                 `Scene.compile(devicePut=False)`: `surfaces` with `packed`,
                 `trim`, `kind` and, for bitmap or hole-primitive trims,
                 `trimMasks`, `trimMaskIdx`, `trimPrims`; `elements` with
                 `packed`, `optType`,
                 `recordHits` and, for a dispersive scene, `nLambda`,
                 `nTable`, `hasDispersion`; the sequential-mode mask
                 `seqMask`, a source's `surfMask` (as the JAX runner's
                 `sceneFor` adds it) and the stochastic scatter tables
                 `scatter` where present (carried over as numpy, so both
                 packages fit the same tables). Other keys are ignored;
    histSpecNp   the histogram spec: `elemToDet`, `bounds`, `bins`;
    samplerSpec  optionally the dict from `pallasSamplerSpec()` of a point
                 or a surface source (`samplerSpecFromReference`);
    emissionBound, maxIntersections
                 optionally the source's `emissionBound()` and the bounces
                 its per-bounce culls cover.

  Returns what `ops.cuda_trace.buildTraceTables` returns, on `device`.'''
  scene, histSpec = _sceneAndSpec(deviceNp, histSpecNp)
  return cuda_trace.buildTraceTables(
      scene, histSpec, samplerSpec=samplerSpecFromReference(samplerSpec),
      device=device, emissionBound=emissionBound,
      maxIntersections=maxIntersections)



def recordSceneFromReference(deviceNp, device='cuda'):
  '''The record tracer's scene (`tracing/batch_tracer.prepareScene`) from
  the JAX package's `Scene.compile(devicePut=False)` dict: `surfaces`
  (`packed`, `kind`, `params`, `trim`, `w2lRot`, `w2lOff` and the bitmap
  and primitive trims), `elements` (`packed` and the dispersion table),
  `seqMask`, `surfMask`, `scatter` (with its (lo, hi) pair rows) and
  `powerTol`, on `device`.'''
  from .tracing.batch_tracer import prepareScene
  return prepareScene(deviceNp, resolveDevice(device))

def _plain(x):
  '''`x` with every array and number turned into python floats / ints,
  tuples and dicts (a spec's leaves may be numpy scalars or arrays).'''
  if isinstance(x, dict):
    return {k: _plain(v) for k, v in x.items()}
  if isinstance(x, (str, bool)) or x is None:
    return x
  if isinstance(x, (list, tuple, np.ndarray)):
    return tuple(_plain(v) for v in x)
  if isinstance(x, (int, np.integer)):
    return int(x)
  return float(x)


def samplerSpecFromReference(spec):
  '''The in-kernel sampler spec of the JAX package's
  `pallasSamplerSpec()` as plain python values, the form of the port's
  `samplerSpec()`: a point source's marginals and placement, or a surface
  source's faces (kind, params, trim, orient, R, off, area-CDF window) and
  theta marginal. None stays None.'''
  if spec is None:
    return None
  out = _plain(spec)
  if out.get('type') == 'surface':
    out['faces'] = tuple(dict(f, kind=int(f['kind'])) for f in out['faces'])
  return out


def _sceneAndSpec(deviceNp, histSpecNp):
  '''The port's host scene dict and histogram spec from the JAX package's
  numpy outputs.'''
  scene = dict(
      surfaces={k: np.asarray(deviceNp['surfaces'][k])
                for k in ('packed', 'trim', 'kind', 'trimMasks',
                          'trimMaskIdx', 'trimPrims')
                if k in deviceNp['surfaces']},
      elements={k: np.asarray(deviceNp['elements'][k])
                for k in ('packed', 'optType', 'recordHits')})
  for key in ('seqMask', 'surfMask'):
    if key in deviceNp:
      scene[key] = np.asarray(deviceNp[key])
  if 'scatter' in deviceNp:
    scene['scatter'] = {k: np.asarray(v)
                        for k, v in deviceNp['scatter'].items()}
  for key in ('nLambda', 'nTable', 'hasDispersion'):
    if key in deviceNp['elements']:
      scene['elements'][key] = np.asarray(deviceNp['elements'][key])
  histSpec = dict(elemToDet=np.asarray(histSpecNp['elemToDet']),
                  bounds=np.asarray(histSpecNp['bounds'],
                                    dtype=np.float32).reshape(-1, 4),
                  bins=tuple(int(b) for b in histSpecNp['bins']))
  return scene, histSpec


def sweepFromReference(hostScenesNp, histSpecNp, samplerSpec, geomRows=None,
                       device='cuda'):
  '''Build the sweep kernel's stacked tables from the JAX package's sweep
  inputs (what it hands `makePallasSweepStep`):

    hostScenesNp  one `Scene.compile(devicePut=False)` dict per variant;
    histSpecNp    the histogram spec of the first variant;
    samplerSpec   the dict from `pallasSamplerSpec()` of the sweep's source;
    geomRows      optionally the (V, 13) rows of its geometry mode
                  (`_sourceGeomRow`: R row-major, offset, wavelength), which
                  replace the spec's placement and wavelength per variant.

  Returns what `ops.cuda_trace.buildSweepTables` returns, on `device`.'''
  scenes = [_sceneAndSpec(d, histSpecNp)[0] for d in hostScenesNp]
  histSpec = _sceneAndSpec(hostScenesNp[0], histSpecNp)[1]
  specs = [samplerSpec] * len(scenes)
  if geomRows is not None:
    specs = [cuda_trace.samplerSpecWithGeom(samplerSpec, r)
             for r in np.asarray(geomRows).reshape(len(scenes), 13)]
  return cuda_trace.buildSweepTables(scenes, histSpec, specs, device=device)


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
