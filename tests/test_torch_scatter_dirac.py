'''The reference's conditioned-Dirac scatter scene
(`DiracDelta(theta-theta_refl) + 5*exp(-(theta-theta_in)**2/0.02)`): its
constants (a theta lobe as a pwpoly2d in (quantile, theta_in), the ideal
reflection as one discrete event) equal the JAX package's, and the port's
plain trace equals the JAX Pallas kernel on the same uniforms.'''

import numpy as np
import pytest
import torch

import torch_port_helpers as H
from test_torch_scatter_fits import assertSpecsEqual

torch.set_num_threads(1)

N = 4096


@pytest.fixture(scope='module')
def jaxScene():
  scene, bounds, maxI = H.buildScatterScene(H.jaxNs(), 'dirac')
  return H.compileOnce(scene), bounds, maxI


@pytest.fixture(scope='module')
def case(jaxScene):
  # every ray ends by its second segment (the diffuser, then the detector
  # or nothing), so two bounces trace the scene whole
  return H.runUniformsCase(lambda ns: jaxScene, n=N, tile=N, maxI=2)


def test_constants_match_reference(jaxScene):
  from optics_design_workbench_tpu.tracing.batch_tracer import \
      scatterConstants
  from optics_design_workbench_tpu_torch import convert
  scene, bounds, _maxI = jaxScene
  deviceNp, histNp, spec = H.referenceArrays(scene, bounds)
  tables = convert.sceneFromReference(deviceNp, histNp, samplerSpec=spec,
                                      device='cpu')
  ref = scatterConstants(deviceNp)
  assertSpecsEqual(ref, tables['scatterConsts'])
  (_e, _k, phiSpec, thetaSpec, phiDisc, thetaDisc), = ref
  assert (phiSpec[0], thetaSpec[0], len(phiDisc), len(thetaDisc)) == \
      ('pwpoly', 'pwpoly2d', 0, 1)
  # u1, u2 and the event draws u3, u4 on each bounce
  assert tables['scatterRows'] == 4


def test_histogram_matches_reference_kernel(case):
  H.assertHistogramsMatch(case)


def test_raw_rows_match_reference_kernel(case):
  '''Rows ray by ray within 1e-4, except where the incidence angle is
  small: theta_in = arccos(d . n) takes d . n near 1, where float32 holds
  it to 6e-8 and arccos' slope 1/sin(theta_in) turns the two libraries'
  ulp of difference in the sampled direction (ROADMAP C, "Sensitivities")
  into up to 2e-5 rad of theta_in, and the ideal-reflection event, whose
  angle IS theta_in, carries that 50 mm to the detector. At most 8 of
  4,096 rows (4 on record) may differ by up to 2e-3 mm.'''
  H.assertRawRowsMatch(case, looseAtol=2e-3, maxLoose=8)
