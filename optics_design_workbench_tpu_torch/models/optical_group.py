'''
Optical element groups — ONE class for Mirror / Lens / Grating / Absorber /
Vacuum-detector, exactly like the reference's OpticalGroupProxy (reference:
freecad_elements/optical_group.py:27-96): optical behavior properties,
stochastic scatter probability densities in (theta, phi) conditioned on the
incidence angle, grating parameters, and the RecordHits toggle. The group
owns geometry (a list of analytic surface specs in the group's local frame)
and one or more placements (multi-placement App::Link semantics,
common.py:36-47).
'''

import numpy as np

from .common import PropertyMixin, parseDomain, evalExpr

OPTICAL_TYPES = ('Mirror', 'Lens', 'Grating', 'Absorber', 'Vacuum')


class OpticalGroup(PropertyMixin):

  def _properties(self):
    return [
        ('OpticalProperties', [
            ('Label', None, 'object label'),
            ('OpticalType', 'Mirror', 'Mirror|Lens|Grating|Absorber|Vacuum'),
            ('RefractiveIndex', 2.0,
             'refractive index; may be an expression in "wavelength" (nm) '
             'for dispersive media (extension; the reference only allows a '
             'constant, optical_group.py:36)'),
            ('ReflectedProbabilityDensity', '',
             'stochastic scatter PDF for mirrors, variables theta/phi with '
             'theta_in/phi_in/theta_refl/phi_refl constants'),
            ('RefractedProbabilityDensity', '',
             'stochastic scatter PDF for lenses (theta_refr analog)'),
            ('PowerThetaDomain', '-pi/2, pi/2', ''),
            ('PowerPhiDomain', '0, 2*pi', ''),
            ('RayModificationProbabilityDensity', '',
             'post-hoc ray rotation PDF in theta/phi'),
            ('ModifyThetaDomain', '-pi/2, pi/2', ''),
            ('ModifyPhiDomain', '0, 2*pi', ''),
            ('Reflectivity', 1.0, ''),
            ('AbsorptionLength', 'inf', '1/mm'),
            ('GratingType', 'Reflection', 'Reflection|Transmission'),
            ('GratingLinesPerMillimeter', 1000.0, ''),
            ('GratingLinesOrientation', (0., 0., 1.), ''),
            ('GratingDiffractionOrder', 1, ''),
        ]),
        ('OpticalSimulationSettings', [
            ('RecordHits', None,
             'record ray hits on this group (defaults per type like '
             'optical_group.py:141-160: True for Absorber/Vacuum)'),
        ]),
        ('View', [
            ('ViewColor', (0.35, 0.35, 0.4),
             'RGB color blended into drawn rays after a hit on this group '
             '(reference: ViewObject.Color, ray.py:136-142)'),
            ('ViewColorWeight', 0.0,
             'blend weight in [0, 1]; 0 disables the color change '
             '(reference: ViewObject.Weight, ray.py:136-142)'),
        ]),
    ]

  def __init__(self, surfaces=None, placements=None, **kwargs):
    self._applyProperties(kwargs)
    if self.OpticalType not in OPTICAL_TYPES:
      raise ValueError(f'invalid optical type {self.OpticalType!r}')
    if self.RecordHits is None:
      self.RecordHits = self.OpticalType in ('Absorber', 'Vacuum')
    if self.Label is None:
      self.Label = self.OpticalType
    self.surfaces = list(surfaces or [])
    self.placements = ([np.eye(4)] if placements is None
                       else [np.asarray(p, dtype=float) for p in placements])

  def addSurface(self, surf):
    self.surfaces.append(surf)
    return self

  # ------------------------------------------------------------- compilation

  def refractiveIndexOf(self, wavelengthNm=None):
    '''Constant n, or n(lambda) when RefractiveIndex is an expression.'''
    try:
      return float(self.RefractiveIndex)
    except (TypeError, ValueError):
      import sympy as sy
      expr = sy.sympify(self.RefractiveIndex)
      lam = sy.Symbol('wavelength')
      if wavelengthNm is None:
        raise ValueError('dispersive RefractiveIndex needs a wavelength')
      return float(expr.subs(lam, wavelengthNm).evalf())

  def dispersionTable(self, lambdaGridNm):
    '''Tabulate n(lambda) when dispersive, else None.'''
    try:
      float(self.RefractiveIndex)
      return None
    except (TypeError, ValueError):
      return (np.asarray(lambdaGridNm, dtype=float),
              np.array([self.refractiveIndexOf(l) for l in lambdaGridNm]))

  def toElementDict(self, lambdaGridNm=None):
    '''Convert to the tracer's element() dict.'''
    from ..tracing import element
    try:
      n0 = float(self.RefractiveIndex)
      dispersion = None
    except (TypeError, ValueError):
      if lambdaGridNm is None:
        lambdaGridNm = np.linspace(300., 1100., 161)
      dispersion = self.dispersionTable(lambdaGridNm)
      n0 = dispersion[1][len(dispersion[1]) // 2]
    return element(
        opticalType=self.OpticalType,
        refractiveIndex=n0,
        reflectivity=float(self.Reflectivity),
        absorptionLength=evalExpr(self.AbsorptionLength),
        gratingType=self.GratingType,
        gratingLinesPerMillimeter=float(self.GratingLinesPerMillimeter),
        gratingLinesOrientation=tuple(self.GratingLinesOrientation),
        gratingDiffractionOrder=float(self.GratingDiffractionOrder),
        recordHits=bool(self.RecordHits),
        dispersion=dispersion,
        label=self.Label)

  def scatterKinds(self):
    '''Which stochastic scatter PDFs are configured (reference:
    optical_group.py:214-271 — 'reflect' applies to mirrors, 'refract' to
    lenses, 'modify' to both).'''
    kinds = {}
    if self.OpticalType == 'Mirror' and self.ReflectedProbabilityDensity:
      kinds['reflect'] = (self.ReflectedProbabilityDensity,
                          parseDomain(self.PowerThetaDomain)[1],
                          parseDomain(self.PowerPhiDomain)[1])
    if self.OpticalType == 'Lens' and self.RefractedProbabilityDensity:
      kinds['refract'] = (self.RefractedProbabilityDensity,
                          parseDomain(self.PowerThetaDomain)[1],
                          parseDomain(self.PowerPhiDomain)[1])
    if self.RayModificationProbabilityDensity:
      kinds['modify'] = (self.RayModificationProbabilityDensity,
                         parseDomain(self.ModifyThetaDomain)[1],
                         parseDomain(self.ModifyPhiDomain)[1])
    return kinds
