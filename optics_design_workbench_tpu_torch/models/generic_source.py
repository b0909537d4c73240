'''
Base class for light sources (reference: freecad_elements/generic_source.py:
23-46): per-source record toggle, ignore list and the scale factors applied
on top of the global simulation settings.
'''

import numpy as np

from .common import PropertyMixin


class GenericSource(PropertyMixin):

  def _baseProperties(self):
    return [
        ('OpticalSimulationSettings', [
            ('Label', None, 'object label'),
            ('RecordRays', False,
             'store full ray polylines (not only hits) to disk'),
            ('IgnoredOpticalElements', [],
             'labels of optical groups this source\'s rays ignore'),
            ('RaysPerIterationScale', 1.0, ''),
            ('MaxIntersectionsScale', 1.0, ''),
            ('MaxRayLengthScale', 1.0, ''),
        ]),
        ('View', [
            ('ViewColor', (1., 0., 0.),
             'starting RGB color of drawn rays — the headless analog of '
             'the source ShapeMaterial DiffuseColor the reference reads '
             'in generic_source.py:89-94'),
        ]),
    ]

  def __init__(self, placement=None, **kwargs):
    self._applyProperties(kwargs)
    if self.Label is None:
      self.Label = type(self).__name__
    self.placement = (np.eye(4) if placement is None
                      else np.asarray(placement, dtype=float))

  def clear(self):
    '''GUI-only in the reference (deletes drawn ray objects); no-op here.'''

  def supportsDeviceSampling(self):
    '''True when this source can export a device generator
    (deviceGenerator / deviceColumnsGenerator) for the fused on-device
    Monte-Carlo fast path; sources answering False run through the
    host-side generateRays path.'''
    return False

  def onInitializeSimulation(self, state=None, ident=None):
    pass

  def onExitSimulation(self, ident=None):
    pass
