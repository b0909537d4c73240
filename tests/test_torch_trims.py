'''Bitmap (flag 2) and hole-primitive (flags 3, 4) trims, B3, on the
PyTorch port: the slotted mirrors of the reference's trim tests
(`benchmarks.buildBitmapSlotScene`, a 64 x 64 disc bitmap with a slot;
`buildPrimSlotScene`, a disc minus a rotated strip and a half-plane) through
the plain versions of the histogram, per-ray-bin and raw-record kernels,
held against the JAX package's Pallas kernels in interpret mode fed the
same uniforms (2,048 rays): counters equal, counts within the 2-ray
bin-edge budget, raw rows ray by ray within atol 1e-4; and against its XLA
fused step on the same ray columns: counters equal, counts bin for bin.'''

import numpy as np
import pytest
import torch

import torch_port_helpers as H
from optics_design_workbench_tpu_torch import benchmarks as B

torch.set_num_threads(1)

BOUNDS = (-300., 300., -300., 300.)
SCENES = {'bitmapSlot': B.buildBitmapSlotScene,
          'primSlot': B.buildPrimSlotScene}


@pytest.fixture(scope='module', params=sorted(SCENES))
def trimCase(request):
  case = H.portSceneCase(SCENES[request.param], BOUNDS, 4)
  case['name'] = request.param
  return case


def test_histogram_plain_matches_reference_kernel(trimCase):
  H.assertHistogramsMatch(trimCase)
  assert trimCase['tables']['geom']


def test_raw_plain_matches_reference_kernel(trimCase):
  H.assertRawRowsMatch(trimCase)


def test_bins_plain_matches_histogram(trimCase):
  H.assertBinsMatchHistogram(trimCase)


def test_rays_pass_the_slot(trimCase):
  '''Some rays cross the mirror plane inside the disc (through the slot)
  and reach the detector beyond it; others fold back.'''
  (refR, _c), (portR, _pc) = trimCase['raw']
  for rec in (refR, portR):
    hit = rec['recordHit']
    p, d = rec['point'][hit], rec['direction'][hit]
    far = p[:, 2] > 50.
    s = (p[:, 2] - 50.) / d[:, 2]
    r2 = (p[:, 0] - s * d[:, 0]) ** 2 + (p[:, 1] - s * d[:, 1]) ** 2
    assert (far & (r2 < 18. ** 2)).sum() > 10 and (~far).sum() > 100


@pytest.mark.parametrize('name', sorted(SCENES))
def test_plain_matches_reference_fused_step(name):
  ref, port, moved = H.fusedCountersMatch(SCENES[name], BOUNDS, 4, seed=3)
  assert port == ref and moved == 0
