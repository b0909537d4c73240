'''The reference's coupled scatter scene (an astigmatic diffuser,
`exp(-(theta*cos(phi))**2/0.003 - (theta*sin(phi))**2/0.05)`): its
constants (theta | phi as a low-rank sum of pwpoly2d terms with Fourier
factors in phi) equal the JAX package's, and the port's plain trace
equals the JAX Pallas kernel on the same uniforms.'''

import pytest
import torch

import torch_port_helpers as H
from test_torch_scatter_fits import assertSpecsEqual

torch.set_num_threads(1)

N = 4096


@pytest.fixture(scope='module')
def jaxScene():
  scene, bounds, maxI = H.buildScatterScene(H.jaxNs(), 'coupled')
  return H.compileOnce(scene), bounds, maxI


@pytest.fixture(scope='module')
def case(jaxScene):
  # every ray ends by its second segment, so two bounces trace it whole
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
  (_e, _k, phiSpec, thetaSpec, _pd, _td), = ref
  assert thetaSpec[0] == 'lowrank'
  assert 'fourier' in [b[0] for _a, b in thetaSpec[1]]


def test_histogram_matches_reference_kernel(case):
  H.assertHistogramsMatch(case)


def test_raw_rows_match_reference_kernel(case):
  H.assertRawRowsMatch(case)


# chip_smoke.py REF_SCATTER['coupled']: the JAX package's fused step at
# 65,536 rays, seed 0
REF_RAYS = 1 << 16
REF_COUPLED = dict(share=1.0, power=1.0, r2=35.05237400531769,
                   r4=34770.715683407616)


def test_fused_step_statistics_agree_with_reference(jaxScene):
  '''The JAX package's statistics are chip_smoke.py's constants, and the
  port's fused step on the CPU (its own draws) agrees within 3 sigma.'''
  scene = jaxScene[0]
  ref = H.scatterStatsOfReference('coupled', REF_RAYS, scene=scene)
  for k, v in REF_COUPLED.items():
    assert ref[k] == pytest.approx(v, abs=1e-9), k
  H.assertScatterStatsAgree(H.portScatterStats(scene, REF_RAYS), ref,
                            REF_RAYS, REF_RAYS)
