'''The torus (B2's quartic) and the triangle (Moeller-Trumbore) on the
PyTorch port, through the reference's throughput scenes of them
(`benchmarks.buildTorusMirrorScene`, `buildMeshFoldScene`): the plain
versions of the histogram, per-ray-bin and raw-record kernels against the
JAX package's Pallas kernels in interpret mode on the same uniforms (2,048
rays) and its XLA fused step on the same ray columns, and the torus
mirror's detected share and r^2 moments of the JAX fused step at 65,536
rays (the constants chip_smoke.py holds the card's runs to) against the
port's own draws.

Tolerances: counters equal, counts within the 2-ray bin-edge budget, raw
rows ray by ray within atol 1e-4 — except on the torus, whose reflection
turns the few-ulp root differences of the two packages (the JAX package's
CPU arithmetic contracts a * b + c and multiplies by reciprocals) into
direction differences of up to ~3e-5 and point differences of up to ~0.02
mm on the detector 150-250 mm away: there rows agree within atol 1e-4 in
direction and 0.05 mm in position.'''

import numpy as np
import pytest
import torch

import torch_port_helpers as H
from optics_design_workbench_tpu_torch import benchmarks as B

torch.set_num_threads(1)

SCENES = {'torus': (B.buildTorusMirrorScene, (-200., 200., -200., 200.), 3),
          'meshFold': (B.buildMeshFoldScene, (-300., 300., -300., 300.), 3)}
REF_RAYS = 1 << 16
# chip_smoke.py REF_TORUS
REF_TORUS = dict(share=0.57965087890625, power=1.0, r2=6995.6086050200065,
                 r4=154135922.72938535)


@pytest.fixture(scope='module', params=sorted(SCENES))
def sceneCase(request):
  case = H.portSceneCase(*SCENES[request.param])
  case['name'] = request.param
  return case


def test_histogram_plain_matches_reference_kernel(sceneCase):
  H.assertHistogramsMatch(sceneCase)
  ref, _port = sceneCase['hist']
  assert ref['counters']['hits'] > 0.25 * H.N_RAYS


def test_raw_plain_matches_reference_kernel(sceneCase):
  if sceneCase['name'] == 'meshFold':
    H.assertRawRowsMatch(sceneCase)
    return
  (refR, refC), (portR, portC) = sceneCase['raw']
  assert portC == refC or (portC['hits'] == refC['hits']
                           and abs(portC['segments'] - refC['segments']) <= 2)
  m = refR['recordHit']
  np.testing.assert_array_equal(portR['recordHit'], m)
  np.testing.assert_array_equal(portR['hitElem'][m], refR['hitElem'][m])
  # the worst gaps measured on these 2,048 rays are 3.35e-5 in direction
  # and 0.0186 mm in position: a drift shows as a shrinking margin
  np.testing.assert_allclose(portR['direction'][m], refR['direction'][m],
                             rtol=0., atol=1e-4)
  np.testing.assert_allclose(portR['point'][m], refR['point'][m], rtol=0.,
                             atol=0.05)
  np.testing.assert_array_equal(portR['power'][m], refR['power'][m])


def test_bins_plain_matches_histogram(sceneCase):
  H.assertBinsMatchHistogram(sceneCase)


@pytest.mark.parametrize('name', sorted(SCENES))
def test_plain_matches_reference_fused_step(name):
  '''On the torus the XLA step solves its own form of the quartic
  (geometry/surfaces._intersectTorus): the reference suite holds its own two
  tracers there to equal hits and counts within the budget
  (test_torus_vband_trim_matches_xla_interpret); a grazing ray may add a
  segment.'''
  ref, port, moved = H.fusedCountersMatch(*SCENES[name], seed=4)
  assert port[1] == ref[1] and moved <= 2
  assert port[0] == ref[0] if name == 'meshFold' \
      else abs(port[0] - ref[0]) <= 2


def test_torus_statistics_agree_with_reference():
  from optics_design_workbench_tpu_torch import convert
  from optics_design_workbench_tpu_torch.ops import cuda_trace
  from optics_design_workbench_tpu_torch.tracing import fused
  build, bounds, maxI = SCENES['torus']
  scene = H.jaxSceneFromPort(build())
  H.compileOnce(scene)
  ref = H.fusedStatsOfReference(scene, bounds, maxI, REF_RAYS)
  for k, v in REF_TORUS.items():
    assert ref[k] == pytest.approx(v, abs=1e-9), k
  deviceNp, histNp, spec = H.referenceArrays(scene, bounds, bins=(128, 128))
  sceneNp, histSpec = convert._sceneAndSpec(deviceNp, histNp)
  step = cuda_trace.makeTraceStep(
      sceneNp, histSpec, None, raysPerStep=REF_RAYS, maxIntersections=maxI,
      maxRayLength=1000., distTol=1e-4,
      sampler=convert.samplerSpecFromReference(spec), device='cpu')
  hist, c = step(5, fused.initHistograms(histSpec, device='cpu'))
  H.assertScatterStatsAgree(
      H.scatterStats(hist, int(c['hits']), REF_RAYS, bounds=bounds), ref,
      REF_RAYS, REF_RAYS)
