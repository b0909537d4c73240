'''
Stochastic scatter compilation (counterpart of the JAX package's
models/scatter.py): per-element Reflected / Refracted / RayModification
probability densities in (theta, phi), conditioned on the incidence angle,
tabulated at scene-compile time so that the kernels draw per hit.

The conditional samplers are tabulated over a grid of incidence angles:

  phiInv   (Tin, Q)        inverse CDF of the phi marginal
  thetaInv (Tin, M, Q)     inverse CDF of theta | phi (M phi bins)
  + discrete (DiracDelta) event tables per variable

For lenses the ideal refraction angle theta_refr depends on the refraction
direction, so 'refract' builds two table sets (entering / exiting). TIR
angles fall back to the mirror angle. `tracing/scatter.scatterConstants`
fits these tables as the polynomial constants the kernels evaluate. Host
numpy / sympy only.
'''

import numpy as np
import torch

from .. import distributions, resolveDevice
from ..utils import io

THETA_IN_RES = 33
QUANTILE_RES = 257
PHI_COND_RES = 33
THETA_TAB_RES = 501

# scatter kind slots in the packed arrays
REFLECT, REFRACT_ENTER, REFRACT_EXIT, MODIFY = 0, 1, 2, 3
N_KINDS = 4


def _idealOutAngle(kind, thetaIn, n):
  '''theta of the ideal outgoing ray measured from the lobe axis: the
  incidence-side normal for reflection, the transmission-side (forward)
  normal for refraction, so that a user's DiracDelta(theta - theta_refl)
  reproduces the ideal behaviour.'''
  if kind == REFLECT:
    return thetaIn        # specular: same angle on the incidence side
  mu = 1. / n if kind == REFRACT_ENTER else n
  s2 = (mu * np.sin(thetaIn)) ** 2
  if s2 >= 1:           # total internal reflection -> mirror angle, but the
    return np.pi - thetaIn  # lobe axis is the forward normal here
  return np.arccos(np.sqrt(1 - s2))


def _conditionDependent(density):
  '''Whether the density mentions an incidence variable (then every row of
  the incidence grid compiles its own sampler).'''
  try:
    import sympy as sy
    free = {str(s) for s in
            sy.sympify(density.replace('^', '**')).free_symbols}
  except Exception:
    free = {'theta_in'}            # parse trouble: keep per-row compiles
  return bool(free & {'theta_in', 'phi_in', 'theta_refl', 'phi_refl'})


# _buildOneKind's tables by their arguments: the same density compiles to
# the same tables, and a sweep or a runner compiles its scene again and
# again (a density conditioned on theta_in costs tens of seconds of sympy)
_KIND_CACHE = {}


def _buildOneKind(density, thetaDomain, phiDomain, kind, n, dtype,
                  modes=None):
  '''Tabulate one scatter PDF over the incidence-angle grid. Returns a dict
  of stacked tables (shared with later calls of the same arguments: do not
  modify it), or None when the density is empty. `modes` (a list), when
  given, collects the compile path ('analytic' or 'numeric') of each
  sampler compiled for it.'''
  if not density:
    return None
  key = (density, tuple(thetaDomain), tuple(phiDomain), kind, float(n),
         np.dtype(dtype).str)
  if key not in _KIND_CACHE:
    kindModes = []
    _KIND_CACHE[key] = (_tabulateKind(density, thetaDomain, phiDomain, kind,
                                      n, dtype, kindModes), kindModes)
  out, kindModes = _KIND_CACHE[key]
  if modes is not None:
    modes.extend(kindModes)
  return out


def _tabulateKind(density, thetaDomain, phiDomain, kind, n, dtype, modes):
  '''`_buildOneKind` without the cache.'''
  thetaInGrid = np.linspace(0, np.pi / 2, THETA_IN_RES)
  # densities that never mention the incidence variables compile to the
  # SAME sampler for every grid row: build once and replicate
  condDependent = _conditionDependent(density)
  phiInvs, thetaInvs = [], []
  thetaDiscV, thetaDiscC, phiDiscV, phiDiscC = [], [], [], []
  maxD = 0
  raws = []
  shared = None
  for thetaIn in thetaInGrid:
    if condDependent or shared is None:
      vrv = distributions.VectorRandomVariable(
          '(' + density + ')',
          variableOrder=('theta', 'phi'),
          variableDomains=dict(theta=tuple(thetaDomain),
                               phi=tuple(phiDomain)),
          numericalResolutions=dict(theta=THETA_TAB_RES, phi=PHI_COND_RES))
      # generous budget: DiracDelta mixtures need the analytic path
      # (numeric tabulation cannot represent deltas)
      vrv.compile(timeout=20, theta_in=float(thetaIn), phi_in=0.,
                  theta_refl=float(_idealOutAngle(kind, thetaIn, n)),
                  phi_refl=0.)
      modes.append(vrv._mode)
      shared = distributions.buildDeviceTables(vrv, dtype=dtype,
                                               quantileRes=QUANTILE_RES)
    tabs = shared
    raws.append(tabs)
    tTheta, tPhi = tabs['tables'][0], tabs['tables'][1]
    phiInvs.append(np.asarray(tPhi['invCdf'][0]))
    thetaInvs.append(np.asarray(tTheta['invCdf']))
    for src, valList, cumList in ((tTheta, thetaDiscV, thetaDiscC),
                                  (tPhi, phiDiscV, phiDiscC)):
      v = np.asarray(src['discreteVals'])
      c = np.asarray(src['discreteCum'])
      valList.append(v)
      cumList.append(c)
      maxD = max(maxD, len(v))

  def pad(lists):
    # pad with the final element (cum rows must stay monotone and keep
    # their last value: zero padding would disable the discrete draw)
    return np.stack([np.concatenate(
        [x, np.full(maxD - len(x), x[-1] if len(x) else 0.)])
        for x in lists])

  npDtype = np.dtype(dtype)
  grid0 = np.asarray(raws[0]['tables'][0]['laterGrids'][0])
  out = dict(
      phiInv=np.stack(phiInvs).astype(npDtype),
      thetaInv=np.stack(thetaInvs).astype(npDtype),
      phiGridLo=float(grid0[0]),
      phiGridStep=float(np.diff(grid0[:2])[0]),
      phiGridLen=int(grid0.shape[0]),
  )
  if maxD:
    out['thetaDiscVals'] = pad(thetaDiscV).astype(npDtype)
    out['thetaDiscCum'] = pad(thetaDiscC).astype(npDtype)
    out['phiDiscVals'] = pad(phiDiscV).astype(npDtype)
    out['phiDiscCum'] = pad(phiDiscC).astype(npDtype)
  return out


def buildScatterTables(groups, dtype=np.float32, device=None, modes=None):
  '''Build the scene-level scatter tables for a list of OpticalGroups, or
  None when no group defines any scatter density. All elements share one
  stacked table per kind; elements without a given kind get zero rows
  flagged off. `device=None` keeps host numpy (what the kernels' tables
  are packed from); a torch device puts every array there. `modes` (a
  list), when given, collects the compile path of each sampler.

  `phiInvPairs` / `thetaInvPairs` are the (lo, hi) pair rows of the
  inverse CDFs that the record tracer's exact gather path reads
  (`batch_tracer._scatterDraw`: one 2-wide gather per interpolation).'''
  anyScatter = any(g.scatterKinds() for g in groups)
  if not anyScatter:
    return None
  E = len(groups)
  perKind = {}
  flags = np.zeros((E, N_KINDS), dtype=bool)
  for e, g in enumerate(groups):
    kinds = g.scatterKinds()
    try:
      n = float(g.RefractiveIndex)
    except (TypeError, ValueError):
      n = g.refractiveIndexOf(550.)
    build = lambda name, kind: _buildOneKind(*kinds[name], kind, n, dtype,
                                             modes)
    if 'reflect' in kinds:
      perKind[(e, REFLECT)] = build('reflect', REFLECT)
      flags[e, REFLECT] = True
    if 'refract' in kinds:
      perKind[(e, REFRACT_ENTER)] = build('refract', REFRACT_ENTER)
      perKind[(e, REFRACT_EXIT)] = build('refract', REFRACT_EXIT)
      flags[e, REFRACT_ENTER] = flags[e, REFRACT_EXIT] = True
    if 'modify' in kinds:
      perKind[(e, MODIFY)] = build('modify', MODIFY)
      flags[e, MODIFY] = True

  # assemble stacked (E, KINDS, ...) arrays; zero rows for absent kinds
  anyTab = next(iter(perKind.values()))
  Tin = anyTab['phiInv'].shape[0]
  Q = anyTab['phiInv'].shape[1]
  M = anyTab['thetaInv'].shape[1]
  maxD = max([t['thetaDiscVals'].shape[1] for t in perKind.values()
              if 'thetaDiscVals' in t] or [0])
  phiInv = np.zeros((E, N_KINDS, Tin, Q), dtype=np.float32)
  thetaInv = np.zeros((E, N_KINDS, Tin, M, Q), dtype=np.float32)
  discShape = (E, N_KINDS, Tin, maxD)
  tDiscV = np.zeros(discShape, dtype=np.float32)
  tDiscC = np.zeros(discShape, dtype=np.float32)
  pDiscV = np.zeros(discShape, dtype=np.float32)
  pDiscC = np.zeros(discShape, dtype=np.float32)
  meta = None
  for (e, kind), tab in perKind.items():
    if tab is None:
      flags[e, kind] = False
      continue
    if tab['thetaInv'].shape[1] != M or tab['phiInv'].shape[1] != Q:
      raise ValueError('inconsistent scatter table resolutions')
    phiInv[e, kind] = tab['phiInv']
    thetaInv[e, kind] = tab['thetaInv']
    if maxD and 'thetaDiscVals' in tab:
      d = tab['thetaDiscVals'].shape[1]
      for dst, src in ((tDiscV, 'thetaDiscVals'), (tDiscC, 'thetaDiscCum'),
                       (pDiscV, 'phiDiscVals'), (pDiscC, 'phiDiscCum')):
        dst[e, kind, :, :d] = tab[src]
        if 0 < d < maxD:
          # forward-fill so cum rows stay monotone with their final value
          dst[e, kind, :, d:] = dst[e, kind, :, d - 1:d]
    meta = tab

  phiPairs = np.stack([phiInv[..., :-1], phiInv[..., 1:]],
                      axis=-1).reshape(-1, 2)
  thetaPairs = np.stack([thetaInv[..., :-1], thetaInv[..., 1:]],
                        axis=-1).reshape(-1, 2)
  tables = dict(
      flags=flags,
      phiInv=phiInv,
      thetaInv=thetaInv,
      phiInvPairs=phiPairs.astype(np.float32),
      thetaInvPairs=thetaPairs.astype(np.float32),
      thetaInRes=np.float32(Tin),
      phiGridLo=np.float32(meta['phiGridLo']),
      phiGridStep=np.float32(meta['phiGridStep']),
      phiGridLen=np.int32(meta['phiGridLen']),
  )
  if maxD:
    tables.update(thetaDiscVals=tDiscV, thetaDiscCum=tDiscC,
                  phiDiscVals=pDiscV, phiDiscCum=pDiscC)
  io.verb(f'compiled scatter tables for {int(flags.any(axis=1).sum())} '
          f'element(s)')
  if device is None:
    return tables
  dev = resolveDevice(device)
  return {k: torch.as_tensor(v, device=dev) for k, v in tables.items()}
