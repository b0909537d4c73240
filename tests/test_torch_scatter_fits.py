'''The port's scatter fits, evaluators and compile-time constants against
the JAX package's (models/scatter.py tables -> tracing/scatter.py
constants -> the kernels' scatter block): the same fits from the same
tables, evaluators within 1e-6 on 65,536 float32 inputs, and the
reference's refusals.'''

import numpy as np
import pytest
import torch

import torch_port_helpers as H

torch.set_num_threads(1)

N_EVAL = 1 << 16


def assertSpecsEqual(a, b, path='spec'):
  '''Nested tuples of names and numbers equal in structure, the numbers to
  1e-12 relative.'''
  if isinstance(a, (tuple, list)):
    assert isinstance(b, (tuple, list)) and len(a) == len(b), path
    for i, (x, y) in enumerate(zip(a, b)):
      assertSpecsEqual(x, y, f'{path}[{i}]')
  elif isinstance(a, str):
    assert a == b, path
  else:
    assert np.isclose(float(a), float(b), rtol=1e-12, atol=1e-300), \
        (path, a, b)


def _expInverse(q, lam):
  '''Inverse CDF of exp(-lam x) truncated to [0, 1].'''
  return -np.log1p(-q * (1. - np.exp(-lam))) / lam


@pytest.fixture(scope='module')
def families():
  q = np.linspace(0., 1., 257)
  cond = np.linspace(0., np.pi / 2, 33)
  phi = np.linspace(0., 2 * np.pi, 33)
  rows = np.stack([_expInverse(q, 1. + .5 * c) for c in cond])
  # a phi profile of three periods: its first factor needs the Fourier
  # series, its second fits a polynomial
  coupled = (rows[:, None, :] * (1. + .3 * np.cos(3. * phi))[None, :, None]
             + .05 * rows[:, None, :] ** 2 * np.sin(phi)[None, :, None])
  return dict(q=q, cond=cond, phi=phi, rows=rows, coupled=coupled)


def test_fits_match_reference(families):
  from optics_design_workbench_tpu.distributions import device_sampler as J
  from optics_design_workbench_tpu_torch.distributions import \
      device_sampler as P
  f = families
  pairs = [
      (J.fitPiecewisePoly2d(f['rows'], f['cond']),
       P.fitPiecewisePoly2d(f['rows'], f['cond'])),
      (J.fitLowRankTheta(f['coupled'], f['cond'], f['phi']),
       P.fitLowRankTheta(f['coupled'], f['cond'], f['phi'])),
      (J.fitPoly1d(np.cos(f['cond']) ** 2, f['cond']),
       P.fitPoly1d(np.cos(f['cond']) ** 2, f['cond'])),
      (J.fitPoly1d(np.full(33, .25), f['cond']),
       P.fitPoly1d(np.full(33, .25), f['cond'])),
      (J.fitFourier(np.exp(np.cos(f['phi'])), f['phi']),
       P.fitFourier(np.exp(np.cos(f['phi'])), f['phi'])),
      (J.fitPiecewisePoly(f['rows'][5]), P.fitPiecewisePoly(f['rows'][5])),
  ]
  kinds = [ref[0] for ref, _port in pairs]
  assert kinds == ['pwpoly2d', 'lowrank', 'poly1d', 'const', 'fourier',
                   'pwpoly']
  for ref, port in pairs:
    assertSpecsEqual(ref, port)
  # the low-rank fit needs its second component, as the JAX package decides
  assert [b[0] for _a, b in pairs[1][1][1]] == ['fourier', 'poly1d']
  # failures are failures on both sides
  noisy = np.cumsum(np.random.default_rng(3).exponential(size=(33, 257)) ** 4,
                    axis=1)
  assert J.fitPiecewisePoly2d(noisy, f['cond'], maxRects=4) is None
  assert P.fitPiecewisePoly2d(noisy, f['cond'], maxRects=4) is None


def test_evaluators_match_reference(families):
  '''Each evaluator, and arccosApprox, within 1e-6 of the JAX package's on
  65,536 float32 inputs.'''
  import jax.numpy as jnp
  from optics_design_workbench_tpu.distributions import device_sampler as J
  from optics_design_workbench_tpu_torch.distributions import \
      device_sampler as P
  f = families
  rng = np.random.default_rng(11)
  u = rng.random(N_EVAL, dtype=np.float32)
  c = (rng.random(N_EVAL) * np.pi / 2).astype(np.float32)
  ph = (rng.random(N_EVAL) * 2 * np.pi).astype(np.float32)
  mu = rng.random(N_EVAL, dtype=np.float32)
  mu[:64] = np.float32(1.) - np.arange(64, dtype=np.float32) * 1e-7
  two = P.fitPiecewisePoly2d(f['rows'], f['cond'])
  low = P.fitLowRankTheta(f['coupled'], f['cond'], f['phi'])
  poly = P.fitPoly1d(np.cos(f['cond']) ** 2, f['cond'])
  four = P.fitFourier(np.exp(np.cos(f['phi'])), f['phi'])
  events = ((P.fitPoly1d(.2 + .1 * np.sin(f['cond']), f['cond']),
             P.fitPoly1d(f['cond'], f['cond'])),
            (('const', .5), ('const', .25)))
  cont = (rng.random(N_EVAL) * 3.).astype(np.float32)
  t = torch.as_tensor
  cases = {
      'arccosApprox': (J.arccosApprox(jnp.asarray(mu)),
                       P.arccosApprox(t(mu))),
      'evalPwpoly2d': (J.evalPwpoly2d(two, jnp.asarray(u), jnp.asarray(c)),
                       P.evalPwpoly2d(two, t(u), t(c))),
      'evalLowRankTheta': (
          J.evalLowRankTheta(low, jnp.asarray(u), jnp.asarray(c),
                             jnp.asarray(ph)),
          P.evalLowRankTheta(low, t(u), t(c), t(ph))),
      'evalFourier': (J.evalFourier(four, jnp.asarray(ph)),
                      P.evalFourier(four, t(ph))),
      'evalPoly1d': (J.evalPoly1d(poly, jnp.asarray(c)),
                     P.evalPoly1d(poly, t(c))),
      'evalDiscreteEvents': (
          J.evalDiscreteEvents(events, jnp.asarray(c), jnp.asarray(u),
                               jnp.asarray(cont)),
          P.evalDiscreteEvents(events, t(c), t(u), t(cont))),
  }
  for name, (ref, port) in cases.items():
    ref = np.asarray(ref)
    assert port.dtype == torch.float32, name
    np.testing.assert_allclose(port.numpy(), ref, rtol=0., atol=1e-6,
                               err_msg=name)
  assert P.ACOS_POLY == J._ACOS_POLY
  # arccosApprox keeps the reference's accuracy
  exact = np.arccos(mu.astype(np.float64))
  assert np.abs(cases['arccosApprox'][1].double().numpy() - exact).max() \
      < 2e-6


def test_interp_inverse_rows_matches_reference():
  import jax.numpy as jnp
  from optics_design_workbench_tpu.distributions import device_sampler as J
  from optics_design_workbench_tpu_torch.distributions import \
      device_sampler as P
  rng = np.random.default_rng(5)
  cdf = np.cumsum(rng.random((7, 65)), axis=1)
  cdf = np.concatenate([np.zeros((7, 1)), cdf], axis=1)
  cdf = (cdf / cdf[:, -1:]).astype(np.float32)
  values = np.linspace(-1., 2., 66).astype(np.float32)
  rows = rng.integers(0, 7, 4096)
  u = rng.random(4096, dtype=np.float32)
  ref = J.interpInverseRows(jnp.asarray(cdf), jnp.asarray(values),
                            jnp.asarray(rows), jnp.asarray(u))
  port = P.interpInverseRows(torch.as_tensor(cdf), torch.as_tensor(values),
                             torch.as_tensor(rows), torch.as_tensor(u))
  np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=0.,
                             atol=1e-6)


def _constants(name):
  '''(the JAX package's scatterConstants, the port's on the same tables
  carried over by `convert`, the port's tables) of a scatter scene.'''
  from optics_design_workbench_tpu.tracing.batch_tracer import \
      scatterConstants
  from optics_design_workbench_tpu_torch import convert
  scene, bounds, _maxI = H.buildScatterScene(H.jaxNs(), name)
  H.compileOnce(scene)
  deviceNp, histNp, spec = H.referenceArrays(scene, bounds)
  tables = convert.sceneFromReference(deviceNp, histNp, samplerSpec=spec,
                                      device='cpu')
  return scatterConstants(deviceNp), tables['scatterConsts'], tables


@pytest.mark.parametrize('name,forms', [
    ('diffuse', ('pwpoly', 'pwpoly', 0)),
    ('diracFloor', ('pwpoly', 'pwpoly', 1)),
])
def test_scatter_constants_match_reference(name, forms):
  '''The port's constants are the JAX package's tuple, and its packed
  table carries them (one entry, its forms and events).'''
  ref, port, tables = _constants(name)
  assert ref is not None and len(ref) == 1
  assertSpecsEqual(ref, port)
  (_e, _k, phiSpec, thetaSpec, phiDisc, thetaDisc), = port
  assert (phiSpec[0], thetaSpec[0], len(thetaDisc)) == forms
  assert tables['scatter'] and tables['scatterRows'] == (4 if forms[2]
                                                         else 2)


def test_refusals_are_the_reference_ones():
  '''A density whose fit misses tolerance is refused with the reference's
  reason (the port names where the exact gather path belongs); more than
  16 scattering (element, kind) combinations are refused by count.'''
  from optics_design_workbench_tpu.ops import pallas_trace
  from optics_design_workbench_tpu_torch import convert
  from optics_design_workbench_tpu_torch.ops import cuda_trace
  from optics_design_workbench_tpu_torch.tracing import scatter as SC
  scene, bounds, _maxI = H.buildScatterScene(H.jaxNs(), 'diffuse')
  H.compileOnce(scene)
  deviceNp, histNp, spec = H.referenceArrays(scene, bounds)
  sc = dict(deviceNp['scatter'])
  noisy = np.cumsum(np.random.default_rng(7).exponential(size=257) ** 6)
  phiInv = np.array(sc['phiInv'])
  phiInv[0, 0] = noisy / noisy[-1] * 2 * np.pi
  rough = dict(deviceNp, scatter=dict(sc, phiInv=phiInv))
  refReason = pallas_trace.pallasIneligibleReason(rough)
  assert refReason is not None and 'tolerance' in refReason
  port, _spec = convert._sceneAndSpec(rough, histNp)
  assert cuda_trace.ineligibleReason(port) == SC.GATHER_ONLY_REASON
  assert SC.GATHER_ONLY_REASON.startswith(refReason)
  assert 'A.4' in SC.GATHER_ONLY_REASON
  with pytest.raises(ValueError, match='tolerance'):
    cuda_trace.buildTraceTables(port, _spec, spec, device='cpu')
  # 17 combinations over 5 elements
  flags = np.zeros((5, 4), bool)
  flags.reshape(-1)[:17] = True
  many = {k: np.repeat(np.asarray(v)[:1], 5, axis=0) if k in (
      'phiInv', 'thetaInv') else v for k, v in sc.items()}
  many['flags'] = flags
  portMany, _spec = convert._sceneAndSpec(dict(deviceNp, scatter=many),
                                          histNp)
  assert '17 scattering (element, kind) combinations' in \
      cuda_trace.ineligibleReason(portMany)
  assert pallas_trace.pallasIneligibleReason(
      dict(deviceNp, scatter=many)) is not None
