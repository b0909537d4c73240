'''The port's plain scatter trace against the JAX Pallas kernel (interpret
mode, `uniformProvider='input'`) on the same uniforms: the reference's
diffuse scatter scene and a scene of the kinds no reference scene reaches
(a lens scattering on entry and exit, a mirror's MODIFY); and the port's
seed mode (its own draws) against the JAX fused step's scatter on real
entropy, by distribution.'''

import numpy as np
import pytest
import torch

import torch_port_helpers as H

torch.set_num_threads(1)

N = 4096


@pytest.fixture(scope='module')
def diffuseCase():
  # every ray ends by its second segment (the diffuser, then the detector
  # or nothing), so two bounces trace the scene whole
  return H.runUniformsCase(lambda ns: H.buildScatterScene(ns, 'diffuse'),
                           n=N, tile=N, maxI=2)


@pytest.fixture(scope='module')
def kindsCase():
  return H.runUniformsCase(H.buildScatterKindsScene, n=N, tile=N)


def test_diffuse_histogram_matches_reference_kernel(diffuseCase):
  H.assertHistogramsMatch(diffuseCase)
  assert diffuseCase['tables']['scatterRows'] == 2


def test_diffuse_raw_rows_match_reference_kernel(diffuseCase):
  H.assertRawRowsMatch(diffuseCase)


def test_kinds_histogram_matches_reference_kernel(kindsCase):
  '''REFRACT_ENTER and REFRACT_EXIT on the slab, MODIFY on the fold
  mirror: three entries, each a pwpoly lobe, 2 + 2 rows per bounce.'''
  consts = kindsCase['tables']['scatterConsts']
  assert [(e, k) for e, k, *_ in consts] == [(0, 1), (0, 2), (1, 3)]
  assert kindsCase['tables']['scatterRows'] == 4
  H.assertHistogramsMatch(kindsCase)


def test_kinds_raw_rows_match_reference_kernel(kindsCase):
  H.assertRawRowsMatch(kindsCase)
  # the scatter turned the rays: the detector hits spread in y, where the
  # ideal beam stays within the source's radius of 8 mm
  (_ref, _c), (port, _pc) = kindsCase['raw']
  y = port['point'][..., 1][port['recordHit']]
  assert np.abs(y).max() > 9.


def test_seed_mode_scatter_distribution_matches_xla_tracer():
  '''The port's plain seed path (torch.Generator uniforms through the same
  draw) against the JAX fused step's scatter on real, independent entropy:
  detector marginals within the reference suite's L1 budget
  (tests/test_pallas_interpret.py, scatter distribution).'''
  import jax
  from optics_design_workbench_tpu.tracing import fused as refFused
  from optics_design_workbench_tpu_torch import benchmarks
  bounds, n = (-150., 150., -150., 150.), 1 << 13
  scene, _b, maxI = H.buildScatterScene(H.jaxNs(), 'diffuse')
  device, info = scene.compile()
  device['powerTol'] = 1e-6
  histSpec = refFused.makeHistogramSpec(device, info, bounds=bounds,
                                        bins=(16, 128))
  stepX = refFused.makeFusedStep(
      device, scene.lightSources()[0].deviceGenerator(), histSpec,
      raysPerStep=n, maxIntersections=maxI, maxRayLength=1e6, distTol=1e-4)
  hX, cX = stepX(jax.random.PRNGKey(77), refFused.initHistograms(histSpec))
  stepP, hP, _meta = benchmarks.makeBenchStep(
      scene=benchmarks.buildDiffuseScatterScene(), raysPerStep=n,
      maxIntersections=maxI, bins=(16, 128), histBounds=bounds,
      device='cpu')
  hP, cP = stepP(11, hP)
  assert int(cX['hits']) > 0.8 * n and int(cP['hits']) > 0.8 * n
  assert H.marginalsClose(hP['counts'][0].numpy(),
                          np.asarray(hX['counts'])[0])
