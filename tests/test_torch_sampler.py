'''The PyTorch port's point-source sampling against the JAX package's maths
on the same numpy uniforms: `tentInterp`, `evalPwpoly`, the device draw
behind `deviceColumnsGenerator`, and the in-kernel sampler's plain version
(finite focal length and f = inf, with and without ray-index strata).

Tolerances: 1e-5 mm on positions and 1e-6 on directions (float32 sin / cos
and a handful of multiply-adds, whose rounding differs by an ulp or two
between XLA and eager torch).
'''

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_port_helpers as H
from optics_design_workbench_tpu.distributions import device_sampler as jaxDs
from optics_design_workbench_tpu.models import point_source as jaxPs
from optics_design_workbench_tpu_torch.distributions import (
    device_sampler as torchDs)
from optics_design_workbench_tpu_torch.ops import cuda_trace

torch.set_num_threads(1)

N = 4096
POS_ATOL, DIR_ATOL = 1e-5, 1e-6
SOURCES = {
    'finite': dict(PowerDensity='exp(-theta^2/0.02)', ThetaDomain='0, 0.35',
                   FocalLength='30', ThetaResolutionNumericMode='5e3'),
    'collimated': dict(PowerDensity='exp(-r^2/20)', FocalLength='inf',
                       RadiusDomain='0, 8',
                       RadiusResolutionNumericMode='5e3'),
}


def _source(ns, kind):
  placement = ns.T.compose(ns.T.translation(1., 2., 3.),
                           ns.T.rotation((1, 0, 0), 30))
  return ns.PointSource(Label='Src', Wavelength=532., placement=placement,
                        **SOURCES[kind])


@pytest.fixture(scope='module', params=sorted(SOURCES))
def sources(request):
  rng = np.random.default_rng(42)
  return dict(kind=request.param, jax=_source(H.jaxNs(), request.param),
              torch=_source(H.torchNs(), request.param),
              u=rng.random((2, N), dtype=np.float32))


def _assertColumns(port, ref):
  for k in ('ox', 'oy', 'oz'):
    np.testing.assert_allclose(port[k].numpy(), np.asarray(ref[k]),
                               atol=POS_ATOL, rtol=0, err_msg=k)
  for k in ('dx', 'dy', 'dz'):
    np.testing.assert_allclose(port[k].numpy(), np.asarray(ref[k]),
                               atol=DIR_ATOL, rtol=0, err_msg=k)
  np.testing.assert_array_equal(port['pw'].numpy(), np.asarray(ref['pw']))


def test_tent_interp_matches(sources):
  jTab = jaxDs.buildDeviceTables(sources['jax']._getVrv())
  tTab = torchDs.buildDeviceTables(sources['torch']._getVrv())
  small = np.array(jTab['tables'][0]['invCdfSmall'])
  np.testing.assert_allclose(tTab['tables'][0]['invCdfSmall'], small,
                             rtol=1e-6)
  u = sources['u'][0]
  ref = np.asarray(jaxDs.tentInterp(jnp.asarray(small), jnp.asarray(u)))
  got = torchDs.tentInterp(torch.as_tensor(small), torch.as_tensor(u))
  np.testing.assert_allclose(got.numpy(), ref, atol=1e-6 * np.ptp(small))


def test_eval_pwpoly_matches(sources):
  spec = sources['jax'].pallasSamplerSpec()['first']
  assert spec[0] == 'pwpoly'
  u = sources['u'][0]
  ref = np.asarray(jaxDs.evalPwpoly(spec, jnp.asarray(u)))
  got = torchDs.evalPwpoly(spec, torch.as_tensor(u))
  np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)


def test_device_columns_generator_matches(sources, monkeypatch):
  '''deviceDraw + the placement maths of both packages on the same
  quantiles: the JAX draw loop asks `jax.random.uniform` once per variable,
  last variable first, and gets the numpy uniforms instead.'''
  u = sources['u']
  queue = [jnp.asarray(u[1]), jnp.asarray(u[0])]
  monkeypatch.setattr(jax.random, 'uniform',
                      lambda key, shape, dtype=None: queue.pop(0))
  ref = sources['jax'].deviceColumnsGenerator()(jax.random.PRNGKey(0), N)
  assert not queue
  port = sources['torch'].deviceColumnsGenerator(device='cpu')(
      None, N, uniforms=torch.as_tensor(u))
  _assertColumns(port, ref)
  assert float(port['wl'][0]) == 532.


@pytest.mark.parametrize('strata', [None, 1024], ids=['flat', 'strata'])
def test_in_kernel_sampler_matches(sources, monkeypatch, strata):
  '''The kernel's sampler (plain version): strata remap, marginals by
  affine map / piecewise Horner, focal geometry, placement — against the
  JAX package's evalPwpoly and column maths on the same quantiles.'''
  jSpec = sources['jax'].pallasSamplerSpec()
  tSpec = sources['torch'].samplerSpec()
  assert jSpec['finite'] == (sources['kind'] == 'finite')
  u1, u2 = sources['u']
  grid = None
  if strata:
    grid = cuda_trace.tileStrata(N, strata)
    assert grid == (2, 2)
    cell = np.arange(N) // strata
    u1 = ((cell // grid[1]).astype(np.float32) + u1) * np.float32(1 / grid[0])
    u2 = ((cell % grid[1]).astype(np.float32) + u2) * np.float32(1 / grid[1])
  t = jaxDs.evalPwpoly(jSpec['first'], jnp.asarray(u1))
  _, lo, hi = jSpec['phi']
  p = lo + jnp.asarray(u2) * (hi - lo)
  monkeypatch.setattr(jaxPs, 'deviceDraw',
                      lambda tables, key, n, stratified=False:
                      jnp.stack([t, p]))
  ref = sources['jax'].deviceColumnsGenerator()(jax.random.PRNGKey(0), N)

  dummy = dict(surfaces=dict(
      packed=np.concatenate([np.eye(3).reshape(-1), np.zeros(3), [1., 0., 0.],
                             np.zeros(9)])[None].astype(np.float32),
      trim=np.array([[1., 1., 1., 0., 0., 0.]], np.float32),
      kind=np.zeros(1, np.int32)),
      elements=dict(packed=np.array([[3., 1., 1., np.inf, 0., 0., 0., 0., 0.,
                                      0., 1.]], np.float32),
                    optType=np.array([3], np.int32),
                    recordHits=np.array([True])))
  tables = cuda_trace.buildTraceTables(
      dummy, dict(elemToDet=np.array([0]), bins=(8, 8),
                  bounds=np.array([[-1., 1., -1., 1.]], np.float32)),
      samplerSpec=tSpec, device='cpu')
  cols = cuda_trace.sampleRaysPlain(
      tables, torch.as_tensor(sources['u'][0]),
      torch.as_tensor(sources['u'][1]), grid, strata or 0)
  port = dict(zip(('ox', 'oy', 'oz', 'dx', 'dy', 'dz', 'pw'), cols))
  _assertColumns(port, ref)


def test_tent_marginal_of_the_kernel_sampler(sources):
  '''The kernel sampler's third marginal kind, a tent table: the packed
  block evaluates to the JAX package's tentInterp of the same knots.'''
  jTab = jaxDs.buildDeviceTables(sources['jax']._getVrv())
  knots = np.array(jTab['tables'][0]['invCdfSmall'])
  block = cuda_trace._packMarginal(('table', tuple(float(v) for v in knots)))
  assert block[0] == 2. and block[1] == len(knots) == 257
  u = sources['u'][0]
  ref = np.asarray(jaxDs.tentInterp(jnp.asarray(knots), jnp.asarray(u)))
  got = cuda_trace._marginalPlain(block, torch.as_tensor(u))
  np.testing.assert_allclose(got.numpy(), ref, atol=1e-6 * np.ptp(knots))
  with pytest.raises(ValueError, match='tent knots'):
    cuda_trace._packMarginal(('table', (0.,) * 300))
