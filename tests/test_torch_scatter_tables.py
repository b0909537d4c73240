'''The port's scatter tables (models/scatter.buildScatterTables) against
the JAX package's from the same densities: the inverse CDFs of phi and of
theta | phi over the incidence-angle grid and the discrete-event tables,
within 1e-6, each sampler compiled along the same path (analytic or
numeric) in both packages.'''

import numpy as np
import pytest
import torch

import torch_port_helpers as H

torch.set_num_threads(1)


def _groups(ns, name):
  scene, _bounds, _maxI = H.buildScatterScene(ns, name)
  return scene.opticalObjects()


def _referenceTables(name, monkeypatch):
  '''The JAX package's tables of the scene `name` and the compile path of
  each sampler it compiled.'''
  from optics_design_workbench_tpu import distributions as J
  from optics_design_workbench_tpu.models.scatter import buildScatterTables
  modes = []
  compile_ = J.VectorRandomVariable.compile

  def recording(self, *args, **kwargs):
    out = compile_(self, *args, **kwargs)
    modes.append(self._mode)
    return out

  monkeypatch.setattr(J.VectorRandomVariable, 'compile', recording)
  tables = buildScatterTables(_groups(H.jaxNs(), name), devicePut=False)
  return tables, modes


@pytest.mark.parametrize('name,expectModes,events', [
    # theta-only: one sampler for every incidence row
    ('diffuse', {'analytic'}, False),
    # DiracDelta mixtures need the analytic path
    ('diracFloor', {'analytic'}, True),
    # conditioned on theta_in: one sampler per incidence row
    ('conditioned', {'analytic'}, False),
])
def test_tables_match_reference(name, expectModes, events, monkeypatch):
  from optics_design_workbench_tpu_torch.models import scatter as P
  ref, refModes = _referenceTables(name, monkeypatch)
  P._KIND_CACHE.clear()
  modes = []
  port = P.buildScatterTables(_groups(H.torchNs(), name), modes=modes)
  assert modes == refModes
  if expectModes is not None:
    assert set(modes) == expectModes
  if name == 'conditioned':
    assert len(modes) == P.THETA_IN_RES
    # and the rows differ: the constants fit a pwpoly2d in theta_in
    rows = port['thetaInv'][0, 0, :, 0]
    assert np.ptp(rows[:, 128]) > 0.1
  np.testing.assert_array_equal(port['flags'], np.asarray(ref['flags']))
  keys = ['phiInv', 'thetaInv']
  if events:
    keys += ['thetaDiscVals', 'thetaDiscCum', 'phiDiscVals', 'phiDiscCum']
  assert ('thetaDiscVals' in port) == events == ('thetaDiscVals' in ref)
  for k in keys:
    assert port[k].shape == np.asarray(ref[k]).shape, k
    np.testing.assert_allclose(port[k], np.asarray(ref[k]), rtol=0.,
                               atol=1e-6, err_msg=k)
  for k in ('thetaInRes', 'phiGridLo', 'phiGridStep', 'phiGridLen'):
    assert float(port[k]) == float(ref[k]), k
