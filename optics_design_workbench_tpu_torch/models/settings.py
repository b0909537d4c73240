'''
Simulation settings object (reference: freecad_elements/simulation_settings.py
:20-77): end criteria, per-iteration ray budget, tracing limits, worker
count, sequential mode element lists and the ten StoreHit* metadata toggles.
Values keep the reference's string-typed-numeric semantics ('inf', '1e-6',
'num_cpus').
'''

import numpy as np

from .common import PropertyMixin, evalExpr

STORE_HIT_KEYS = ('InitPoint', 'InitDirection', 'InitPower', 'InitWavelength',
                  'InitPhi', 'InitTheta', 'RayIndex', 'FanIndex',
                  'TotalFanCount', 'TotalRaysInFan')


class SimulationSettings(PropertyMixin):

  def _properties(self):
    return [
        ('Simulation', [
            ('Label', 'SimulationSettings', 'object label'),
            ('Active', True, 'exactly one settings object may be active '
                             '(reference: find.py:116-141)'),
            ('EnableStoreSingleShotData', False,
             'store rays/hits for single-shot modes'),
            ('EndAfterIterations', 'inf', 'stop after this many iterations'),
            ('EndAfterRays', '1e4', 'stop after this many traced rays'),
            ('EndAfterHits', 'inf', 'stop after this many recorded hits'),
            ('RaysPerIteration', 100, 'rays per iteration per source'),
            ('MaxIntersections', 100, 'per-ray bounce limit'),
            ('DistanceTolerance', '1e-6',
             'intersection distance tolerance (clamped to [1e-9, 1])'),
            ('MaxRayLength', 1000, 'per-segment length limit (mm)'),
            ('ShowRaysInContinuousMode', True, 'GUI-only in the reference'),
            ('WorkerProcessCount', 'num_cpus',
             "shard count: 'num_cpus' = all local devices"),
            ('SequentialMode', False, 'restrict intersection candidates per '
                                      'bounce to SequentialModeElements'),
            ('SequentialModeElements', [],
             'list of element-label lists, one per sequence index '
             '(reference: SequentialModeElements_NN LinkLists)'),
        ]),
        ('StoreMetadata', [
            (f'StoreHit{k}', False, f'record {k} metadata column with hits')
            for k in STORE_HIT_KEYS
        ]),
    ]

  def __init__(self, **kwargs):
    self._applyProperties(kwargs)

  # ---- parsed accessors (sanitized like simulation_settings.py:109-151) ----

  def endAfterIterations(self):
    return max(1., evalExpr(self.EndAfterIterations))

  def endAfterRays(self):
    return max(1., evalExpr(self.EndAfterRays))

  def endAfterHits(self):
    return max(1., evalExpr(self.EndAfterHits))

  def raysPerIteration(self):
    return max(1, int(round(float(self.RaysPerIteration))))

  def maxIntersections(self):
    return max(1, int(round(float(self.MaxIntersections))))

  def distanceTolerance(self):
    return float(np.clip(evalExpr(self.DistanceTolerance), 1e-9, 1.))

  def maxRayLength(self):
    return max(1e-9, float(self.MaxRayLength))

  def workerCount(self, deviceCount=None):
    '''Number of parallel shards. 'num_cpus' maps to the local device count
    (the accelerator analog of the reference's physical-core count,
    simulation_loop.py:778-810).'''
    if deviceCount is None:
      import torch
      deviceCount = max(1, torch.cuda.device_count())
    raw = self.WorkerProcessCount
    if isinstance(raw, str) and raw.strip() == 'num_cpus':
      return deviceCount
    try:
      count = int(float(raw))
    except (TypeError, ValueError):
      return deviceCount
    if count <= 0:
      count = deviceCount + count
    return int(np.clip(count, 1, 10 * deviceCount))

  def enabledMetadataKeys(self):
    '''Lower-cased metadata keys enabled for hit storage (the reference
    filters metadata by StoreHit* flags, ray.py:56-66).'''
    return [k.lower() for k in STORE_HIT_KEYS
            if getattr(self, 'StoreHit' + k)]
