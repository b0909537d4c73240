'''The surface-table sweep (B8) on the PyTorch port: assemblies past 256
analytic surfaces through the plain versions of the histogram, per-ray-bin
and raw-record kernels against the JAX package.

  * Same uniforms: the reference's 522-surface wall, a slab array (264
    table rows of 88 glass slabs beside a surface row 5e-5 mm behind
    their back faces: the table's medium rule), a scene of every table
    kind (discs, cones, quadric caps, a cylinder, a sphere cap), ties (two
    equal table rows; a table row under an equal bitmap-trimmed surface
    row) and a scene of both tables (a 200-triangle dish over 257 table
    rows) against the JAX Pallas kernel in interpret mode, which sweeps its
    surface table for these scenes (one grid step of 2,048 rays: its
    interpreter reads each table value through a host callback, ~1 ms each,
    so a second tile doubles the time and tests nothing more). Counters
    equal, counts within the 2-ray bin-edge budget, power per bin at 1 %,
    raw rows ray by ray within atol 1e-4 (the worst gap measured on these
    rays: 9.2e-5 mm in a hit point of the both-tables scene); on the scene
    of every kind, whose cones and quadric caps reflect after a
    discriminant that cancels as (distance / size)^2, the JAX package's
    contractions of a * b + c move a reflected ray by up to 4.3e-4 in
    direction and 0.18 mm at the detector (measured: 213 of 1,102 rows past
    1e-4), so there the rows are held within 2e-3 in direction and 0.25 mm,
    and each table row's distance and normal are held to the reference's
    formulas run eagerly (no contraction) bit for bit.
  * Same columns: the 5,071-surface wall against the JAX package's XLA
    fused step (its kernel sends a table past 940 rows there).
  * The run: `runSimulation` on the CPU through the 522-surface wall.'''

import glob

import numpy as np
import pytest
import torch

import torch_port_helpers as H
from optics_design_workbench_tpu_torch import benchmarks as B
from optics_design_workbench_tpu_torch import simulation
from optics_design_workbench_tpu_torch.ops import cuda_trace
from optics_design_workbench_tpu_torch.simulation import results_store as RS

torch.set_num_threads(1)


@pytest.fixture(scope='module', params=sorted(H.SURFACE_TABLE_SCENES))
def tableCase(request):
  case = H.runUniformsCase(H.SURFACE_TABLE_SCENES[request.param],
                           tile=H.N_RAYS)
  case['name'] = request.param
  return case


def _detectorCounts(case, label):
  '''The (reference, port) counts binned on the detector of element
  `label`.'''
  from optics_design_workbench_tpu_torch.tracing import fused
  scene, bounds, _maxI = H.SURFACE_TABLE_SCENES[case['name']](H.torchNs())
  sceneNp, info = scene.compile(device=None)
  histSpec = fused.makeHistogramSpec(sceneNp, info, bounds=bounds,
                                     bins=H.BINS)
  det = int(histSpec['elemToDet'][list(info['elementLabels']).index(label)])
  assert det >= 0
  ref, port = case['hist']
  return ref['counts'][det].sum(), port['counts'][det].sum()


def test_histogram_plain_matches_reference_kernel(tableCase):
  assert tableCase['tables']['nSurfTable'] > 0
  H.assertHistogramsMatch(tableCase)
  ref, _port = tableCase['hist']
  assert ref['counters']['hits'] > 0.3 * H.N_RAYS
  if tableCase['name'] == 'tie':
    # the duplicate Absorber loses every tie to the wall's row before it in
    # the table; the bitmap-trimmed surface row wins its ties with the
    # table row under it
    assert _detectorCounts(tableCase, 'Dup') == (0, 0)
    ref, port = _detectorCounts(tableCase, 'Slot')
    assert ref == port >= 10
  if tableCase['name'] == 'slabArray':
    # the patch behind the central slabs' back faces absorbs what leaves
    # them; its hole lets rays through to the detector
    ref, port = _detectorCounts(tableCase, 'Patch')
    assert ref == port >= 10


def test_raw_plain_matches_reference_kernel(tableCase):
  if tableCase['name'] != 'coneQuadric':
    H.assertRawRowsMatch(tableCase)
    return
  (refR, _rc), (portR, _pc) = tableCase['raw']
  m = refR['recordHit']
  np.testing.assert_allclose(portR['direction'][m], refR['direction'][m],
                             rtol=0., atol=2e-3)
  H.assertRawRowsMatch(tableCase, looseAtol=0.25, maxLoose=400)


def test_bins_plain_matches_histogram(tableCase):
  H.assertBinsMatchHistogram(tableCase)


def test_table_rows_match_reference_formulas():
  '''Each row of the every-kind scene's table (planes, spheres, cylinders,
  cones, quadrics; both trims) against 512 rays: the port's distance and
  local normal (`_tableIntersectPlain`, `_tableNormalPlain`) equal the
  JAX package's `_intersectConst(localCoords=...)` and `_normalConst` run
  eagerly on the same float32 values: distances bit for bit, normals
  within an ulp.'''
  import jax.numpy as jnp
  from optics_design_workbench_tpu.ops import pallas_trace
  scene, _bounds, _maxI = H.buildConeQuadricWallScene(H.torchNs())
  sceneNp, info = scene.compile(device=None)
  histSpec = dict(elemToDet=np.array([-1, 0]),
                  bounds=np.array([H.WALL_BOUNDS]), bins=(8, 8))
  _t, f = cuda_trace._packTable(sceneNp, histSpec)
  rng = np.random.default_rng(9)
  o = rng.uniform(-15., 15., (3, 512)) + np.array([[0.], [0.], [5.]])
  d = rng.normal(size=(3, 512)) + np.array([[0.], [0.], [2.]])
  o = o.astype(np.float32)
  d = (d / np.linalg.norm(d, axis=0)).astype(np.float32)
  runs = [(k, t0, a, b) for k, t0, a, b in f['surfPlainRuns']] + [
      (k, t0, r0, r0 + (c1 - c0) * 16) for k, t0, c0, c1, r0 in
      f['surfChunkRuns']]
  hits = 0
  for kind, trim0, a, b in runs:
    for row in f['surfTable'][a:b]:
      cols = [torch.as_tensor(x) for x in row]
      t, *local = cuda_trace._tableIntersectPlain(
          kind, trim0, cols, *torch.as_tensor(o), *torch.as_tensor(d), 1e-4)
      r = dict(kind=kind, trim0=trim0,
               **{f'p{k}': jnp.float32(row[14 + k]) for k in range(5)},
               trim1=jnp.float32(row[19]), trim2=jnp.float32(row[20]))
      localJ = tuple(jnp.asarray(x.numpy()) for x in local)
      tJ = pallas_trace._intersectConst(r, *map(jnp.asarray, o),
                                        *map(jnp.asarray, d),
                                        jnp.float32(1e-4), localCoords=localJ)
      np.testing.assert_array_equal(t.numpy(), np.asarray(tJ))
      hit = t.numpy() < 1e30
      hits += int(hit.sum())
      lxyz = [lo + t * ld for lo, ld in zip(local[:3], local[3:])]
      n = cuda_trace._tableNormalPlain(kind, cols, *lxyz)
      nJ = pallas_trace._normalConst(r, *(jnp.asarray(x.numpy())
                                          for x in lxyz))
      # (one ulp: torch's CPU sqrt is not correctly rounded everywhere)
      for a_, b_ in zip(n, nJ):
        np.testing.assert_allclose(np.broadcast_to(a_.numpy(), (512,))[hit],
                                   np.asarray(b_)[hit], rtol=0., atol=1.2e-7)
  assert hits > 100


def test_large_wall_matches_reference_fused_step():
  '''5,071 surfaces (318 chunks): the JAX kernel sends a surface table past
  its 940 rows to the XLA fused step; the same ray columns through both:
  counters equal, counts within the 2-ray budget.'''
  ref, port, moved = H.fusedCountersMatch(B.buildSurfWall5kScene,
                                          H.WALL_BOUNDS, 3, seed=4)
  assert port == ref and moved <= 2
  assert ref[1] > 0.5 * H.N_RAYS


def test_run_simulation_through_the_wall(tmp_path):
  '''`runSimulation` on the 522-surface wall (raw recording, the plain
  version on the CPU): every stored hit lies on the detector plane, as
  many as the run recorded, and the detected share is the JAX package's
  within 3 sigma (`REF_WALL` of tests/test_torch_surface_table.py).'''
  from test_torch_surface_table import REF_WALL, REF_WALL_RAYS
  scene = B.buildSurfWallScene(tmpdir=str(tmp_path))
  settings = scene.activeSimulationSettings()
  settings.RaysPerIteration, settings.EndAfterIterations = 4096, 1
  settings.EndAfterRays = 'inf'
  runPath = simulation.runSimulation(scene, 'true', seed=3, device='cpu')
  pts = []
  for folder in glob.glob(f'{runPath}/source-*/object-Det'):
    for f in RS.resultFilePaths(folder, 'hits'):
      pts.append(RS.loadResultFile(f)['points'])
  pts = np.concatenate(pts)
  np.testing.assert_allclose(pts[:, 2], 0., atol=1e-3)
  share = len(pts) / 4096
  p = REF_WALL['share']
  sigma = np.sqrt(p * (1 - p) / 4096 + p * (1 - p) / REF_WALL_RAYS)
  assert abs(share - p) <= 3 * sigma, (share, p)
