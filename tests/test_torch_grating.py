'''Gratings in the PyTorch port's trace kernels (ops/cuda_trace, the shared
body of the four CUDA kernels; on the CPU their plain versions) against the
JAX package's Pallas kernel (interpret mode) on the same inputs:

  * the reference suite's grating scene: a 600 lines/mm reflection grating
    tilted by 20 deg, first order, onto a spherical absorber around it;
  * a 300 lines/mm transmission grating on a glass plate, whose exit face
    refracts the first order like a lens face.

Both sides' in-kernel samplers are fed the uniforms the JAX steps draw for
their `uniformProvider='input'` seam; 2048 rays. Tolerances: counters
equal; histogram counts within the 2-ray bin-edge budget and power per bin
within 1 % (the reference bins in bf16); raw rows ray by ray and slot by
slot within atol 1e-4 (mm, unit power, unit direction).
'''

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (both frameworks live in this process)

import torch_port_helpers as H
from optics_design_workbench_tpu_torch import benchmarks

torch.set_num_threads(1)

GRATING_SCENES = ('grating', 'transGrating')


@pytest.fixture(scope='module', params=GRATING_SCENES)
def gratingCase(request):
  return dict(H.runB4Case(request.param), name=request.param)


def test_grating_histograms_match_reference(gratingCase):
  H.assertHistogramsMatch(gratingCase)


def test_grating_raw_rows_match_reference(gratingCase):
  H.assertRawRowsMatch(gratingCase)


def test_grating_branch_is_exercised(gratingCase):
  '''The header flag is set and every ray meets the grating: the reflection
  grating sends each ray onto the sphere (2 segments), the transmission
  grating's plate is crossed as a medium (entry, exit, detector).'''
  tables = gratingCase['tables']
  assert tables['hasGrating'] and tables['dispOff'] < 0
  assert tables['nStages'] == 0 and not tables['gate']
  _ref, (_portR, portC) = gratingCase['raw']
  _, port = gratingCase['hist']
  n = H.N_RAYS
  if gratingCase['name'] == 'grating':
    assert port['counters']['segments'] == 2 * n
  else:
    assert port['counters']['segments'] == 3 * n
  assert portC['hits'] == n and port['counters']['hits'] == n


@pytest.mark.parametrize('gratingCase', ['transGrating'], indirect=True)
def test_transmission_order_leaves_where_the_reference_puts_it(gratingCase):
  '''The detector rows' incoming directions are the diffracted ones. Rulings
  normal to x disperse along x. At normal incidence the reference's Ludwig
  form puts the first order inside the plate at a tangential component of
  lambda / d (the grating equation in glass says lambda / (n d)), and the
  exit face multiplies it by n: n lambda / d = 0.2394 after the plate, where
  the grating equation gives lambda / d = 0.1596 (ROADMAP C). The port
  follows the reference: the mean over a beam symmetric about the axis.'''
  (_r, _), (portR, _) = gratingCase['raw']
  d = portR['direction'][portR['recordHit']]
  lamOverD = 0.532 / (1000. / 300.)
  assert abs(abs(float(d[:, 0].mean())) - 1.5 * lamOverD) < 0.005
  assert abs(float(d[:, 1].mean())) < 0.005


def test_evanescent_order_carries_no_power():
  '''At 2000 lines/mm and 650 nm the first order is evanescent at normal
  incidence (sin = 1.3): the grating absorbs every ray, the detector sees
  nothing.'''
  scene = benchmarks.buildSpectrometerScene(linesPerMm=2000., wavelength=650.)
  step, hist, _meta = benchmarks.makeBenchStep(
      scene=scene, raysPerStep=2048, maxIntersections=3,
      histBounds=(-80., 80., -80., 80.), device='cpu')
  hist, counters = step(3, hist)
  assert int(counters['hits']) == 0
  assert int(counters['segments']) == 2048       # one segment: to the grating
  assert float(hist['power'].sum()) == 0.
