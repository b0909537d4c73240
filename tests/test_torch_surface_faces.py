'''Surface-source faces of kind cone, asphere, torus and triangle (B2's
faces, the port's `models/surface_source.py`) and the kinds scene, on the
CPU against the JAX package:

  * the column maths on the uniform seam: the port's `surfaceSampleColumns`
    against the JAX package's `_surfaceSampleColumns` on the same uniforms,
    with each source's `_faceConstants()` (an asphere's radius and a
    torus's tube angle interpolated from their tabulated inverse CDFs: what
    `deviceColumnsGenerator` draws) and with its kernel sampler spec (their
    piecewise polynomial fits): positions and directions within 5e-7 of
    their size;
  * `samplerSpec()` against `pallasSamplerSpec()` (the fits equal to
    float32) and the faces' areas;
  * the histogram, per-ray-bin and raw-record kernels' plain versions on the
    emitter scene (`benchmarks.buildEmitterKindsScene`) against the JAX
    Pallas kernels in interpret mode fed the same five uniforms a ray
    (2,048 rays): counters equal, counts within the 2-ray budget, raw rows
    within atol 1e-4;
  * the kinds scene (`buildKindsScene`: an even asphere, a conic rewritten
    as a quadric, a cone barrel, the reference's quadric lens and a v-band
    torus) against the JAX XLA fused step on the same ray columns, three
    seeds of 2,048 rays: counts within the 2-ray budget; counters equal but
    for a ray whose path the two packages' ulps split (a ray trapped by
    total internal reflection in one and not the other), at most 8 segments
    and 1 hit of the 2,048 (every surface of the scene is held against the
    Pallas kernel's own code one by one in test_torch_kinds.py).'''

import numpy as np
import pytest
import torch

import torch_port_helpers as H
from optics_design_workbench_tpu.models.surface_source import \
    _surfaceSampleColumns as refSurfaceSampleColumns
from optics_design_workbench_tpu_torch import benchmarks as B
from optics_design_workbench_tpu_torch.models import surface_source

torch.set_num_threads(1)

N = 1 << 14
EMITTER_BOUNDS = (-200., 200., -200., 200.)


@pytest.fixture(scope='module')
def sources():
  '''(JAX source, port source) of the emitter of the four kinds.'''
  port = B.buildEmitterKindsScene()
  jaxScene = H.jaxSceneFromPort(port)
  return jaxScene.lightSources()[0], port.lightSources()[0]


def _columns(ref, port, refFaces, portFaces, seed):
  us = np.random.default_rng(seed).random((5, N)).astype(np.float32)
  theta = us[3] * np.float32(1.5)
  phi = us[4] * np.float32(2. * np.pi)
  want = refSurfaceSampleColumns(refFaces, *us[:3], theta, phi, 500.)
  t = lambda u: torch.as_tensor(np.array(u))  # noqa: E731
  got = surface_source.surfaceSampleColumns(portFaces, *(t(u) for u in us[:3]),
                                            t(theta), t(phi), 500.)
  return want, got, us


@pytest.mark.parametrize('which', ['faceConstants', 'samplerSpec'])
def test_surface_sample_columns_match_reference(sources, which):
  ref, port = sources
  if which == 'faceConstants':
    refFaces, portFaces = ref._faceConstants(), port._faceConstants()
  else:
    refFaces = ref.pallasSamplerSpec()['faces']
    portFaces = port.samplerSpec()['faces']
  want, got, us = _columns(ref, port, refFaces, portFaces, seed=7)
  for k, scale in (('ox', 100.), ('oy', 100.), ('oz', 100.), ('dx', 1.),
                   ('dy', 1.), ('dz', 1.)):
    np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0.,
                               atol=5e-7 * scale, err_msg=k)
  faces = surface_source.faceIndexColumn(portFaces, torch.as_tensor(us[0]))
  assert set(faces.numpy().astype(int).tolist()) == {0, 1, 2, 3}


def test_sampler_spec_and_areas_match_reference(sources):
  ref, port = sources
  want, got = ref.pallasSamplerSpec(), port.samplerSpec()
  f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
  assert [f['kind'] for f in got['faces']] == [5, 3, 7, 4]
  for a, b in zip(got['faces'], want['faces']):
    assert a['kind'] == b['kind'] and ('rSpec' in a) == ('rSpec' in b)
    for k in ('params', 'trim', 'orient', 'R', 'off', 'cumLo', 'cumHi'):
      np.testing.assert_array_equal(f32(a[k]), f32(b[k]), err_msg=k)
    if 'rSpec' in a:
      assert len(a['rSpec'][1]) == len(b['rSpec'][1])
      np.testing.assert_array_equal(f32(a['rSpec'][2:]), f32(b['rSpec'][2:]))
      for sa, sb in zip(a['rSpec'][1], b['rSpec'][1]):
        np.testing.assert_array_equal(f32(sa[:4]), f32(sb[:4]))
        np.testing.assert_array_equal(f32(sa[4]), f32(sb[4]))
  for a, b in zip(port._activeFaces(), ref._activeFaces()):
    assert a.area() == pytest.approx(b.area(), rel=1e-12)


@pytest.fixture(scope='module')
def emitterCase():
  return H.portSceneCase(B.buildEmitterKindsScene, EMITTER_BOUNDS, 4)


def test_histogram_plain_matches_reference_kernel(emitterCase):
  H.assertHistogramsMatch(emitterCase)
  assert emitterCase['tables']['geom']


def test_raw_plain_matches_reference_kernel(emitterCase):
  H.assertRawRowsMatch(emitterCase)


def test_bins_plain_matches_histogram(emitterCase):
  H.assertBinsMatchHistogram(emitterCase)


@pytest.mark.parametrize('seed', [5, 6, 7])
def test_kinds_scene_matches_reference_fused_step(seed):
  ref, port, moved = H.fusedCountersMatch(
      B.buildKindsScene, (-300., 300., -300., 300.), 8, seed=seed)
  assert moved <= 2
  assert abs(port[0] - ref[0]) <= 8 and abs(port[1] - ref[1]) <= 1
  assert port[1] > 0.9 * H.N_RAYS
