'''The triangle-table sweep (B7) on the PyTorch port: meshes past 128
triangles through the plain versions of the histogram, per-ray-bin and
raw-record kernels against the JAX package.

  * Same uniforms: the reference's 200-triangle dish (7 chunks), a closed
    mesh lens (224 triangles, n = 1.5) and the tie mesh (the dish with one
    triangle duplicated as an Absorber) against the JAX Pallas kernel in
    interpret mode, which sweeps its triangle table for these meshes: the
    counters equal, counts within the 2-ray bin-edge budget, power per bin
    at 1 %, raw rows ray by ray within atol 1e-4 (the worst gap measured on
    these 2,048 rays: 9.2e-5 mm in a dish's hit point, whose reflection
    turns the JAX package's CPU contractions of a * b + c into ulps of the
    detector point 60 mm away); on the lens, whose two refractions through
    facets magnify those ulps, at most 32 rows (22 measured) beyond 1e-4,
    none beyond 2e-3 mm (9.9e-4 measured).
  * Same columns: the 5000-triangle dish against the JAX package's XLA
    fused step (its kernel refuses a mesh past 1890 triangles).
  * The run: `runSimulation` on the CPU with STL-loaded mesh detectors (the
    reference's two-triangle quad, and a 200-triangle grid that rides the
    table) catching the rays an analytic plane catches.'''

import glob

import numpy as np
import pytest
import torch

import torch_port_helpers as H
from optics_design_workbench_tpu_torch import benchmarks as B
from optics_design_workbench_tpu_torch import simulation
from optics_design_workbench_tpu_torch.geometry import mesh as M
from optics_design_workbench_tpu_torch.geometry import surfaces as S
from optics_design_workbench_tpu_torch.geometry import transforms as T
from optics_design_workbench_tpu_torch.models import (OpticalGroup,
                                                      PointSource, Scene)
from optics_design_workbench_tpu_torch.ops import cuda_trace
from optics_design_workbench_tpu_torch.simulation import results_store as RS

torch.set_num_threads(1)

SCENES = {'dish200': lambda ns: (H.jaxSceneFromPort(B.buildMeshDishScene(10)),
                                 H.MESH_BOUNDS, 3),
          'meshLens': H.buildMeshLensScene,
          'tie': H.buildTieMeshScene}


@pytest.fixture(scope='module', params=sorted(SCENES))
def meshCase(request):
  case = H.runUniformsCase(SCENES[request.param])
  case['name'] = request.param
  return case


def test_histogram_plain_matches_reference_kernel(meshCase):
  assert meshCase['tables']['nTri'] > cuda_trace.TABLE_TRIANGLES
  H.assertHistogramsMatch(meshCase)
  ref, port = meshCase['hist']
  assert ref['counters']['hits'] > 0.9 * H.N_RAYS
  if meshCase['name'] == 'tie':
    # the duplicate Absorber (detector 0) loses every tie to the dish row
    # before it in the table: nothing is absorbed there in either package
    assert ref['counts'][0].sum() == port['counts'][0].sum() == 0


def test_raw_plain_matches_reference_kernel(meshCase):
  if meshCase['name'] != 'meshLens':
    H.assertRawRowsMatch(meshCase)
    return
  # two refractions through facets turn the JAX package's CPU ulps (it
  # contracts a * b + c) into direction gaps of up to 8.3e-6 and, 40-50 mm
  # on, point gaps past 1e-4 mm in a few rows: measured on these 2,048
  # rays, 22 of 2,042 rows beyond 1e-4, the worst 9.9e-4 mm
  H.assertRawRowsMatch(meshCase, looseAtol=2e-3, maxLoose=32)


def test_bins_plain_matches_histogram(meshCase):
  H.assertBinsMatchHistogram(meshCase)


def test_tie_rays_meet_the_duplicated_triangle():
  '''The tie is exercised: rays of the tie mesh's case cross the dish's
  duplicated triangle (its world (x, y) footprint) on their way up.'''
  scene, bounds, maxI = H.buildTieMeshScene(H.torchNs())
  tri = B.dishTriangles(10)[H.TIE_TRIANGLE]
  step, hist, _meta = B.makeBenchStep(scene=scene, raysPerStep=H.N_RAYS,
                                      maxIntersections=maxI,
                                      histBounds=bounds, device='cpu')
  us = torch.as_tensor(np.random.default_rng(3).random(
      (2, H.N_RAYS)).astype(np.float32))
  ox, oy, oz, dx, dy, dz, _pw = cuda_trace.samplerColumnsPlain(step.tables,
                                                               us)
  # the rays' points at the triangle's plane, in barycentric coordinates
  v0, e1, e2 = tri[0], tri[1] - tri[0], tri[2] - tri[0]
  n = np.cross(e1, e2)
  o = np.stack([ox, oy, oz], 1).astype(float)
  d = np.stack([dx, dy, dz], 1).astype(float)
  p = o + d * (((v0 - o) @ n) / (d @ n))[:, None]
  uv = np.linalg.lstsq(np.stack([e1, e2], 1), (p - v0).T, rcond=None)[0]
  inside = (uv[0] > 0) & (uv[1] > 0) & (uv.sum(0) < 1)
  assert int(inside.sum()) >= 10


@pytest.mark.parametrize('seed', [4])
def test_large_dish_matches_reference_fused_step(seed):
  '''5000 triangles (157 chunks): the JAX kernel refuses the mesh, so its
  own path there is the XLA fused step; the same ray columns through both:
  counters equal, counts within the 2-ray budget.'''
  ref, port, moved = H.fusedCountersMatch(
      lambda: B.buildMeshDishScene(50), H.MESH_BOUNDS, 3, seed=seed)
  assert port == ref and moved <= 2
  assert ref[1] > 0.9 * H.N_RAYS


def _quad(half):
  v = np.array([[-half, -half, 0.], [half, -half, 0.], [half, half, 0.],
                [-half, half, 0.]])
  return v, np.array([[0, 1, 2], [0, 2, 3]])


def _grid(half, n=10):
  '''An n x n grid of quads, two triangles each, over +-half.'''
  xs = np.linspace(-half, half, n + 1)
  v = np.array([(x, y, 0.) for y in xs for x in xs])
  f = []
  for j in range(n):
    for i in range(n):
      a, b = j * (n + 1) + i, j * (n + 1) + i + 1
      c, d = b + n + 1, a + n + 1
      f += [(a, b, c), (a, c, d)]
  return v, np.array(f)


@pytest.mark.parametrize('mesh', ['quad', 'grid'])
def test_trace_against_mesh_detector(mesh, tmp_path):
  '''An STL mesh detector at z = 50 (the reference's two-triangle quad, or
  a 200-triangle grid that rides the triangle table) catches the rays an
  analytic plane catches, through `runSimulation` (raw recording, the
  plain version on the CPU): the port's copy of tests/test_mesh.py's
  test_trace_against_mesh_detector.'''
  def run(useMesh):
    scene = Scene(label=f'meshdet{int(useMesh)}',
                  path=str(tmp_path / f'meshdet{int(useMesh)}'))
    if useMesh:
      path = tmp_path / 'det.stl'
      M.writeBinarySTL(path, *(_quad(30.) if mesh == 'quad'
                               else _grid(30.)))
      surfs = M.meshSurfaces(*M.loadSTL(path), elem=0)
    else:
      surfs = [S.plane(np.eye(4), elem=0, halfExtents=(30., 30.))]
    scene.addOpticalGroup(OpticalGroup(
        OpticalType='Absorber', Label='Det', surfaces=surfs,
        placements=[T.translation(0, 0, 50)]))
    scene.addSource(PointSource(
        Label='Src', PowerDensity='1', ThetaDomain='0, 0.3',
        Wavelength=532., ThetaResolutionNumericMode='1e3'))
    scene.addSimulationSettings(RaysPerIteration=2000, MaxIntersections=2,
                                EndAfterIterations=1,
                                EnableStoreSingleShotData=True)
    runPath = simulation.runSimulation(scene, 'true', seed=11, device='cpu')
    pts = []
    for folder in glob.glob(f'{runPath}/source-*/object-Det'):
      for f in RS.resultFilePaths(folder, 'hits'):
        pts.append(RS.loadResultFile(f)['points'])
    return np.concatenate(pts)

  ptsMesh, ptsPlane = run(True), run(False)
  assert len(ptsMesh) == len(ptsPlane) > 1000   # same seed, same coverage
  np.testing.assert_allclose(ptsMesh[:, 2], 50., atol=1e-3)
  np.testing.assert_allclose(np.sort(ptsMesh[:, 0]), np.sort(ptsPlane[:, 0]),
                             atol=1e-3)
