'''
Point light source with symbolic power density (counterpart of the JAX
package's models/point_source.py; reference semantics:
freecad_elements/point_source.py):

  * PowerDensity expression in theta/phi/r/x/y; FocalLength 0 (pure point),
    finite (converging/diverging through a focus) or 'inf' (collimated beam,
    cylinder-coordinate sampling),
  * coordinate substitutions + Jacobians building the random variable
    (_rvArgs, point_source.py:273-362),
  * ray placement so all rays pass through the focal point / run parallel
    (point_source.py:407-456).

The device path of the source is `samplerSpec()` (the JAX package's
`pallasSamplerSpec`, renamed because nothing here is Pallas),
`deviceColumnsGenerator()`, `deviceGenerator()` (the columns with their
metadata) and `emissionBound()`; the host path is `generateRays()`: the
deterministic ray fans and the host-side Monte-Carlo modes. The
divergence/focal-length syncing is not ported yet.
'''

import numpy as np
import torch

from .. import distributions, resolveDevice
from ..distributions.device_sampler import (buildDeviceTables, deviceDraw,
                                            fitPiecewisePoly)
from ..utils import io
from .common import parseDomain, evalExpr
from .generic_source import GenericSource


class PointSource(GenericSource):

  def _properties(self):
    return [
        ('OpticalEmission', [
            ('PowerDensity', 'exp(-theta^2/0.01)',
             'emitted optical power per solid angle; variables theta, phi, '
             'r, x, y (point_source.py:35-44)'),
            ('Wavelength', 500., 'emission wavelength in nm'),
            ('FocalLength', '0', "0 = point source, finite = focused beam, "
                                 "'inf' = collimated"),
            ('Divergence', '-', '1/e half-angle, synced with FocalLength'),
            ('ThetaDomain', '0, pi/4', ''),
            ('PhiDomain', '0, 2*pi', ''),
            ('RadiusDomain', '0, 10', ''),
        ]),
        ('OpticalSimulationSettings', [
            ('RandomNumberGeneratorMode', '?', 'readonly compile-mode echo'),
            ('ThetaResolutionNumericMode', '1e5', ''),
            ('RadiusResolutionNumericMode', '1e5', ''),
            ('PhiResolutionNumericMode', '1e2', ''),
            ('Fans', 2, 'number of ray fans in fan mode'),
            ('FanPhi0', '0', 'fan azimuth offset'),
            ('RaysPerFan', 20, ''),
        ]),
    ] + self._baseProperties()

  def __init__(self, placement=None, **kwargs):
    super().__init__(placement=placement, **kwargs)
    self._vrv = None
    self._deviceTables = None

  # ---------------------------------------------------------------- domains

  def parsedThetaDomain(self):
    return parseDomain(self.ThetaDomain, default='0,pi/4',
                       limits=('-20*pi', '20*pi'),
                       spanLimits=(0, '20*pi'))[1]

  def parsedPhiDomain(self):
    return parseDomain(self.PhiDomain, default='0,2*pi',
                       limits=('-20*pi', '20*pi'),
                       spanLimits=(0, '20*pi'))[1]

  def parsedRadiusDomain(self):
    return parseDomain(self.RadiusDomain, default='0,10',
                       limits=(-np.inf, np.inf), spanLimits=(0, np.inf))[1]

  def parsedFanPhi0(self):
    return evalExpr(self.FanPhi0)

  def focalLength(self):
    return evalExpr(self.FocalLength)

  def emissionBound(self):
    '''Conservative world-frame emission envelope (originCenter (3,),
    axis (3,), cosAlpha, originRadius): EVERY emitted ray starts within
    `originRadius` of `originCenter` and points within arccos(cosAlpha) of
    `axis`. Matches deviceColumnsGenerator's exact origin math: f = 0 emits
    from the point, finite f from the |lo| = 2|f| sin(theta/2) cap, f = inf
    collimated from the theta-radius disc. Returns None when no finite
    bound exists. The input of the trace steps' per-bounce surface culls
    (`cuda_trace.makeTraceStep(..., emissionBound=)`).'''
    try:
      t1, t2 = self.parsedThetaDomain()
      f = self.focalLength()
    except Exception:
      return None
    if not np.isfinite(t2) or t2 < 0:
      return None
    R = np.asarray(self.placement[:3, :3], dtype=float)
    off = np.asarray(self.placement[:3, 3], dtype=float)
    axis = R @ np.array([0., 0., 1.])
    if not np.isfinite(f):
      # collimated: theta doubles as the aperture radius
      return off, axis, 1.0, float(abs(t2))
    alpha = min(float(t2), np.pi)
    rO = 2. * abs(float(f)) * np.sin(alpha / 2.)
    return off, axis, float(np.cos(alpha)), rO

  # ----------------------------------------------------- random variable ctor

  def _rvArgs(self, densityString, variableDomain=None, scalarRandomVar=False):
    '''Build the kwargs for the (scalar/vector) random variable from the
    power density string — coordinate substitutions and Jacobians exactly as
    the reference (point_source.py:273-362).'''
    import sympy as sy
    f = self.focalLength()
    if np.isfinite(f):
      if np.isclose(f, 0):
        stripped = densityString
        for fn in ('exp', 'arcsin', 'arccos', 'arctan2', 'arctan', 'arccot',
                   'arsinh', 'arcosh', 'artanh', 'arcoth', 'DiracDelta',
                   'Piecewise', 'Heaviside', 'True', 'False'):
          stripped = stripped.replace(fn, '')
        for c in 'rxy':
          if c in stripped:
            raise ValueError(f'Variable {c} in power density expression '
                             f'{self.PowerDensity} is forbidden if focal '
                             f'length is zero')
      if not scalarRandomVar:
        densityString = '(' + densityString + ')*abs(sin(theta))'
      fAbs = f'{abs(f):.8e}'
      expr = (sy.sympify(densityString)
              .subs('r', sy.sympify(f'(tan(theta)*{fAbs})'))
              .subs('x', sy.sympify(f'(tan(theta)*cos(phi)*{fAbs})'))
              .subs('y', sy.sympify(f'(tan(theta)*sin(phi)*{fAbs})')))
      if scalarRandomVar:
        return dict(probabilityDensity=str(expr), variable='theta',
                    variableDomain=variableDomain,
                    numericalResolution=float(self.ThetaResolutionNumericMode))
      return dict(
          probabilityDensity=str(expr),
          variableOrder=('theta', 'phi'),
          variableDomains=dict(theta=self.parsedThetaDomain(),
                               phi=self.parsedPhiDomain()),
          numericalResolutions=dict(
              theta=float(self.ThetaResolutionNumericMode),
              phi=float(self.PhiResolutionNumericMode)))
    else:
      if 'theta' in densityString:
        raise ValueError(f'Variable theta in power density expression '
                         f'{self.PowerDensity} is forbidden if focal length '
                         f'is infinite.')
      if not scalarRandomVar:
        densityString = '(' + densityString + ')*abs(r)'
      expr = (sy.sympify(densityString)
              .subs('x', sy.sympify('(r*cos(phi))'))
              .subs('y', sy.sympify('(r*sin(phi))')))
      if scalarRandomVar:
        return dict(probabilityDensity=str(expr), variable='r',
                    variableDomain=variableDomain,
                    numericalResolution=float(self.RadiusResolutionNumericMode))
      return dict(
          probabilityDensity=str(expr),
          variableOrder=('r', 'phi'),
          variableDomains=dict(r=self.parsedRadiusDomain(),
                               phi=self.parsedPhiDomain()),
          numericalResolutions=dict(
              r=float(self.RadiusResolutionNumericMode),
              phi=float(self.PhiResolutionNumericMode)))

  def _getVrv(self):
    if self._vrv is None:
      self._vrv = distributions.VectorRandomVariable(
          **self._rvArgs(self.PowerDensity))
      self._vrv.compile()
      self.RandomNumberGeneratorMode = self._vrv.mode()
    return self._vrv

  def _getDeviceTables(self):
    if self._deviceTables is None:
      self._deviceTables = buildDeviceTables(self._getVrv())
    return self._deviceTables

  def makeRaysHost(self, thetasOrRadii, phis):
    '''Vectorized world-frame ray batch from sampled coordinates (host).'''
    t = np.asarray(thetasOrRadii, dtype=float)
    p = np.asarray(phis, dtype=float)
    f = self.focalLength()
    if np.isfinite(f):
      st, ct = np.sin(t), np.cos(t)
      d = np.stack([st * np.sin(p), -st * np.cos(p), ct], axis=-1)
      o = (np.array([0., 0., 1.]) - d) * f
      theta, radius = t, np.tan(t) * f
    else:
      d = np.broadcast_to(np.array([0., 0., 1.]), (len(t), 3)).copy()
      o = np.stack([t * np.cos(p), -t * np.sin(p), np.zeros_like(t)], axis=-1)
      theta, radius = np.full_like(t, np.nan), t
    R, off = self.placement[:3, :3], self.placement[:3, 3]
    origins = o @ R.T + off
    directions = d @ R.T
    directions /= np.linalg.norm(directions, axis=-1, keepdims=True)
    return dict(origins=origins, directions=directions,
                powers=np.ones(len(t)),
                wavelengths=np.full(len(t), float(self.Wavelength)),
                metadata=dict(initPhi=p, initTheta=theta, initRadius=radius))

  # -------------------------------------------------------------- generation

  def generateRays(self, mode, settings=None, maxFanCount=np.inf,
                   maxRaysPerFan=np.inf, rng=None):
    '''Host-side ray batch for one iteration; mode in
    {'fans', 'true', 'pseudo'} (reference: point_source.py:459-657); the Monte-Carlo modes draw on
    the host with `rng` (a numpy Generator).'''
    if mode == 'fans':
      return self._generateFans(maxFanCount, maxRaysPerFan)
    if mode in ('true', 'pseudo'):
      raysPerIteration = 100
      if settings is not None:
        raysPerIteration = settings.raysPerIteration()
      raysPerIteration = max(1, int(round(
          raysPerIteration * float(self.RaysPerIterationScale))))
      vrv = self._getVrv()
      if mode == 'true':
        tp = vrv.draw(N=raysPerIteration, rng=rng)
      else:
        tp = vrv.drawPseudo(N=raysPerIteration, rng=rng)
      return self.makeRaysHost(tp[0], tp[1])
    raise ValueError(f'unexpected ray placement mode {mode}')

  def _generateFans(self, maxFanCount, maxRaysPerFan):
    '''Deterministic ray fans (reference: point_source.py:469-634).'''
    raysPerFan = int(min(self.RaysPerFan, maxRaysPerFan))
    totalFanCount = int(min(self.Fans, maxFanCount))
    f = self.focalLength()
    if np.isfinite(f):
      l1, l2 = self.parsedThetaDomain()
    else:
      l1, l2 = self.parsedRadiusDomain()
    phiL1, phiL2 = self.parsedPhiDomain()

    if (l1 > 0 and l2 > 0) or (l1 < 0 and l2 < 0):
      fanMode = 'gapped'
      raysPerFan = max(4, int(np.ceil(raysPerFan / 2) * 2))
    elif l1 == 0 or l2 == 0:
      fanMode = 'stitched'
    elif l1 < 0 and l2 > 0:
      fanMode = 'theta-sign-change'
    else:
      raise ValueError(f'{l1=}, {l2=}')
    io.verb(f'using fan generation mode "{fanMode}"')

    allT, allPhi, meta = [], [], dict(fanIndex=[], rayIndex=[],
                                      totalFanCount=[], totalRaysInFan=[])
    import sympy as sy
    for fanIndex, basePhi in enumerate(
        self.parsedFanPhi0() + np.linspace(0, np.pi, totalFanCount + 1)[:-1]):
      cands = [phi for phi in np.arange(basePhi - 30 * np.pi,
                                        basePhi + 31 * np.pi, np.pi)
               if phiL1 - 1e-9 <= phi <= phiL2 + 1e-9]
      if not cands:
        io.verb(f'skipping fan {fanIndex}: no suitable phi in phi domain')
        continue
      phiA = cands[int(np.argmin(np.abs(basePhi - np.array(cands))))]
      cands = [phi for phi in np.arange(phiA + np.pi - 30 * np.pi,
                                        phiA + np.pi + 31 * np.pi, 2 * np.pi)
               if phiL1 - 1e-9 <= phi <= phiL2 + 1e-9]
      phiB = (np.nan if not cands else
              cands[int(np.argmin(np.abs(phiA + np.pi - np.array(cands))))])

      if fanMode == 'gapped':
        srv = distributions.ScalarRandomVariable(
            **self._rvArgs(self.PowerDensity, variableDomain=(l1, l2),
                           scalarRandomVar=True))
        srv.compile(phi=phiA)
        side1 = srv.findGrid(N=raysPerFan // 2)
        srv.compile(phi=phiB)
        side2 = srv.findGrid(N=raysPerFan // 2)
      elif fanMode == 'stitched':
        limit = max(abs(l1), abs(l2))
        var = 'theta' if np.isfinite(f) else 'r'
        base = (sy.sympify(self.PowerDensity)
                .subs('theta', 'abs(theta)').subs('r', 'abs(r)'))
        if np.isfinite(phiB):
          dens = str(base.subs('phi', sy.sympify(
              f'Piecewise( ( ({phiA}), ({var})>0 ), ( ({phiB}), True ) )')))
          domain = (-limit, limit)
        else:
          dens = str(base)
          domain = (0, limit)
        srv = distributions.ScalarRandomVariable(
            **self._rvArgs(dens, variableDomain=domain, scalarRandomVar=True))
        srv.compile(phi=phiA)
        side1, side2 = srv.findGrid(N=raysPerFan), []
      elif fanMode == 'theta-sign-change':
        srv = distributions.ScalarRandomVariable(
            **self._rvArgs(self.PowerDensity, variableDomain=(l1, l2),
                           scalarRandomVar=True))
        srv.compile(phi=phiA)
        side1, side2 = srv.findGrid(N=raysPerFan), []

      if len(side2) > 0:
        side1 = sorted(side1, key=abs)
        side2 = sorted(side2, key=abs)
        idx1 = list(1 + np.arange(len(side1)))
        idx2 = list(-(1 + np.arange(len(side2))))
      else:
        side1 = np.array(sorted(side1))
        i0 = int(np.argmin(np.abs(side1)))
        idx1 = list(np.arange(len(side1)) - i0)
        idx2 = []

      packed = (list(zip(idx1, side1, [phiA] * len(side1)))
                + list(zip(idx2, side2, [phiB] * len(side2))))
      for rayIndex, val, phi in sorted(packed, key=lambda e: abs(e[0]) - .1):
        allT.append(val)
        allPhi.append(phi)
        meta['fanIndex'].append(int(fanIndex))
        meta['rayIndex'].append(int(rayIndex))
        meta['totalFanCount'].append(int(totalFanCount))
        meta['totalRaysInFan'].append(len(packed))

    batch = self.makeRaysHost(np.array(allT), np.array(allPhi))
    batch['metadata'].update({k: np.array(v) for k, v in meta.items()})
    return batch

  # ------------------------------------------------------------- device path

  def supportsDeviceSampling(self):
    return True

  def samplerSpec(self):
    '''In-kernel sampling descriptor for the fused trace kernel
    (ops/cuda_trace): the (theta|r, phi) inverse-CDF marginals as affine
    maps or piecewise Horner polynomials, plus the placement/focal geometry.
    Same dict as the JAX package's `pallasSamplerSpec()`. Returns None when
    the source needs features the in-kernel sampler does not cover
    (conditioned joints, discrete Heaviside events, >2 variables, inverses
    too sharp to fit) — callers then feed the kernel ray columns from
    `deviceColumnsGenerator`.'''
    tables = self._getDeviceTables()['tables']
    order = self._getDeviceTables()['order']
    if len(tables) != 2:
      return None
    specs = []
    for t in tables:
      if int(t['discreteVals'].shape[0]):
        return None
      affine, lo, hi = t['affine']
      if affine:
        specs.append(('affine', float(lo), float(hi)))
      elif t['rowsEqual']:
        spec = fitPiecewisePoly(np.asarray(t['invCdf'][0], float))
        if spec is None:
          return None   # inverse too sharp for the piecewise fit
        specs.append(spec)
      else:
        return None     # conditioned joint: needs the row-indexed inverse
    specs = [specs[i] for i in order]
    f = self.focalLength()
    P = np.asarray(self.placement, float)
    return dict(first=specs[0], phi=specs[1],
                finite=bool(np.isfinite(f)),
                f=float(f) if np.isfinite(f) else 0.,
                R=tuple(tuple(float(x) for x in row) for row in P[:3, :3]),
                off=tuple(float(x) for x in P[:3, 3]),
                wavelength=float(self.Wavelength))

  def deviceColumnsGenerator(self, device='cuda'):
    '''Column-form device generator: returns
    `generate(generator, N, stratified=False) -> dict(ox..dz, pw, wl)` with
    every field a flat float32 (N,) tensor on `device`. `generator` is a
    torch.Generator on that device (the explicit stand-in for a jax key);
    `uniforms=` hands deviceDraw its quantiles instead (the tests' seam).'''
    drawn = self._drawnColumns(device)

    def generate(generator, N, stratified=False, uniforms=None):
      return drawn(generator, N, stratified, uniforms)[0]

    return generate

  def deviceGenerator(self, device='cuda'):
    '''Like `deviceColumnsGenerator`, plus each ray's metadata:
    `generate(generator, N, stratified=False) -> (columns, metadata)` with
    metadata initPhi, initTheta (NaN for a collimated source) and
    initRadius, float32 (N,) tensors on `device` (the JAX package's
    `deviceGenerator` metadata, for runs that store StoreHit* columns).'''
    drawn = self._drawnColumns(device)
    f = self.focalLength()

    def generate(generator, N, stratified=False):
      cols, t, p = drawn(generator, N, stratified, None)
      if np.isfinite(f):
        meta = dict(initPhi=p, initTheta=t, initRadius=torch.tan(t) * f)
      else:
        meta = dict(initPhi=p, initTheta=torch.full_like(t, float('nan')),
                    initRadius=t)
      return cols, meta

    return generate

  def _drawnColumns(self, device):
    '''`generate(generator, N, stratified, uniforms) -> (columns, t, p)`:
    the ray columns with the two drawn coordinates they were placed from.'''
    dev = resolveDevice(device)
    tables = self._getDeviceTables()
    f = self.focalLength()
    finite = bool(np.isfinite(f))
    R = np.asarray(self.placement[:3, :3], dtype=float)
    off = np.asarray(self.placement[:3, 3], dtype=float)
    wavelength = float(self.Wavelength)

    def generate(generator, N, stratified, uniforms):
      t, p = deviceDraw(tables, generator, N, stratified=stratified,
                        device=dev, uniforms=uniforms)[:2]
      return pointColumns(t, p, finite, f, R, off, wavelength), t, p

    return generate


def pointColumns(t, p, finite, f, R, off, wavelength):
  '''Ray columns of a point source from its two drawn coordinates (theta or
  radius `t`, azimuth `p`; float32 tensors): the focal geometry, then the
  placement as component multiply-adds with host-scalar entries, in the
  reference's operation order (deviceColumnsGenerator / the in-kernel
  sampler share this maths).'''
  return placeColumns(pointLocal(t, p, finite, f), R, off, wavelength)


def pointLocal(t, p, finite, f):
  '''The first half of `pointColumns`: the ray in the source's own frame,
  (lox, loy, loz, ldx, ldy, ldz) float32 tensors, from the two drawn
  coordinates and the focal words.'''
  f32 = lambda x: float(np.float32(x))
  sp, cp = torch.sin(p), torch.cos(p)
  if finite:
    st, ct = torch.sin(t), torch.cos(t)
    ldx, ldy, ldz = st * sp, -st * cp, ct
    lox, loy, loz = f32(-f) * ldx, f32(-f) * ldy, f32(f) * (1. - ldz)
  else:
    ldx = torch.zeros_like(t)
    ldy = torch.zeros_like(t)
    ldz = torch.ones_like(t)
    lox, loy, loz = t * cp, -t * sp, torch.zeros_like(t)
  return lox, loy, loz, ldx, ldy, ldz


def placeColumns(local, R, off, wavelength):
  '''The second half of `pointColumns`: the ray of `pointLocal` placed by
  the source's rotation `R` and offset `off` (component multiply-adds with
  host-scalar entries), with unit power and `wavelength`.'''
  lox, loy, loz, ldx, ldy, ldz = local
  f32 = lambda x: float(np.float32(x))
  r = [[f32(R[i][j]) for j in range(3)] for i in range(3)]
  o = [f32(x) for x in off]
  ox = r[0][0] * lox + r[0][1] * loy + r[0][2] * loz + o[0]
  oy = r[1][0] * lox + r[1][1] * loy + r[1][2] * loz + o[1]
  oz = r[2][0] * lox + r[2][1] * loy + r[2][2] * loz + o[2]
  dx = r[0][0] * ldx + r[0][1] * ldy + r[0][2] * ldz
  dy = r[1][0] * ldx + r[1][1] * ldy + r[1][2] * ldz
  dz = r[2][0] * ldx + r[2][1] * ldy + r[2][2] * ldz
  return dict(ox=ox, oy=oy, oz=oz, dx=dx, dy=dy, dz=dz,
              pw=torch.ones_like(lox),
              wl=torch.full_like(lox, wavelength))
