'''The PyTorch port's `jupyter_utils` document layer on the CPU: scene files,
`Document`, `RawFolder` / `RawFolderRange` over the run folders that
`runSimulation` writes, `Hits` and `Histogram`, and the two packages reading
each other's run folders.

Tolerances: a run folder read by either package's `RawFolder` gives the same
rows (atol 1e-6: both decode the same float32 columns); `loadHits` row counts
equal the run's `totalRecordedHits`.
'''

import os
import pickle

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (both frameworks live in this process)

import torch_port_helpers as H
from optics_design_workbench_tpu import simulation as refSimulation
from optics_design_workbench_tpu.jupyter_utils import RawFolder as RefRawFolder
from optics_design_workbench_tpu_torch import simulation
from optics_design_workbench_tpu_torch.jupyter_utils import (
    Document, FreecadDocument, Hits, Histogram, RawFolder, RawFolderRange,
    ProgressTracker, applyTransformation, latestRawFolder, loadScene,
    rawFolderByIndex, rawFolders, retryOnError, saveScene, updateResultEntry)

torch.set_num_threads(1)

COLUMNS = ('points', 'directions', 'powers', 'isEntering')


def _scene(tmp):
  return H.buildDocScene(H.torchNs(), str(tmp / 'doc1'))


def test_save_load_roundtrip(tmp_path):
  path = saveScene(_scene(tmp_path))
  assert os.path.exists(path) and path.endswith('.scene.pkl')
  scene = loadScene(path)
  assert scene.getObject('Lens').RefractiveIndex == 1.5
  assert scene.getObject('Source').PowerDensity == 'exp(-theta^2/0.02)'
  other = tmp_path / 'not-a-scene.scene.pkl'
  other.write_bytes(pickle.dumps(dict(a=1)))
  with pytest.raises(TypeError, match='does not contain a Scene'):
    loadScene(str(other))


def test_document_run_and_load(tmp_path):
  saveScene(_scene(tmp_path))
  doc = Document(str(tmp_path / 'doc1'), device='cpu')
  assert FreecadDocument is Document
  assert doc.Source.Wavelength == 532.
  doc.Source.Wavelength = 640.
  assert doc.scene.getObject('Source').Wavelength == 640.
  with pytest.raises(AttributeError):
    doc.NoSuchObject
  raw = doc.runSimulation('true', seed=11)
  assert raw.exists() and raw.uid()
  assert 'Lens' in raw.loadGlobalInfo()['opticalObjects']
  hits = raw.loadHits('Detector')
  assert len(hits) > 9000
  assert len(hits) == raw.progress()['totalRecordedHits']
  assert len(raw.loadHits('NoSuchObject')) == 0
  assert doc.latestRawFolder().path == raw.path
  assert len(doc.rawFolders()) == 1
  assert any(files for _rel, files in raw.tree())
  with doc:
    pass                                    # close() with nothing running


def test_document_autodetects_and_works_in_temp_copy(tmp_path):
  saveScene(_scene(tmp_path))
  doc = Document(str(tmp_path / 'doc1.OpticsDesign'), device='cpu')
  assert doc.Source.Wavelength == 532.
  simulation.getResultsFolderPath(str(tmp_path / 'doc1'))
  tmpDoc = Document(str(tmp_path / 'doc1'), workInTempCopy=True, device='cpu')
  assert 'tmp' in tmpDoc.scenePath
  assert tmpDoc.scenePath != tmpDoc._originalPath


def test_endif_callback_ends_the_run(tmp_path):
  scene = _scene(tmp_path)
  scene.getObject('SimulationSettings').EndAfterRays = 'inf'
  calls = []

  def endIf(raw):
    calls.append(raw.path)
    return len(calls) >= 2

  raw = Document(scene=scene, device='cpu').runSimulation('true', endIf=endIf,
                                                          seed=1)
  assert len(calls) >= 2 and raw.exists()


def test_raw_folder_range_and_folder_queries(tmp_path):
  scene = _scene(tmp_path)
  for seed in (1, 2):
    simulation.runSimulation(scene, 'singletrue', seed=seed, store=True,
                             device='cpu')
  folder = simulation.getResultsFolderPath(str(tmp_path / 'doc1'))
  runs = rawFolders(folder)
  assert len(runs) == 2
  assert rawFolderByIndex(folder, 0).path == runs[0].path
  assert latestRawFolder(folder).path == runs[1].path
  assert rawFolderByIndex(str(tmp_path / 'empty'), 0) is None
  both = RawFolderRange(runs)
  assert len(both) == 2 and [r.path for r in both] == [r.path for r in runs]
  one = runs[0].loadHits('Detector')
  assert len(both.loadHits('Detector')) \
      == len(one) + len(runs[1].loadHits('Detector'))


def test_ray_polylines_and_drawn_rays_raise_by_name(tmp_path):
  '''`loadRays` and `drawnRays` are ported: a folder without ray files or
  a drawn-rays snapshot gives no rays and None.'''
  raw = RawFolder(str(tmp_path))
  assert raw.loadRays() == []
  assert raw.drawnRays() is None
  assert RawFolderRange([raw]).loadRays() == []


def _columns(hits):
  return {k: np.asarray(hits[k]) for k in COLUMNS}


@pytest.mark.parametrize('writer', ('reference', 'port'))
def test_run_folders_cross_the_packages(tmp_path, writer):
  '''A run folder written by either package, read by both packages'
  `RawFolder`: the same rows.'''
  if writer == 'reference':
    scene = H.buildDocScene(H.jaxNs(), str(tmp_path / 'doc1'))
    runPath = refSimulation.runSimulation(scene, 'true', seed=4)
  else:
    runPath = simulation.runSimulation(_scene(tmp_path), 'true', seed=4,
                                       device='cpu')
  mine = RawFolder(runPath).loadHits('Detector')
  theirs = RefRawFolder(runPath).loadHits('Detector')
  assert len(mine) == len(theirs) > 9000
  a, b = _columns(mine), _columns(theirs)
  for k in COLUMNS:
    np.testing.assert_allclose(a[k].astype(np.float64),
                               b[k].astype(np.float64), atol=1e-6, err_msg=k)
  assert len(mine) == RawFolder(runPath).progress()['totalRecordedHits']


@pytest.fixture(scope='module')
def detectorHits(tmp_path_factory):
  tmp = tmp_path_factory.mktemp('hits')
  runPath = simulation.runSimulation(_scene(tmp), 'true', seed=8,
                                     device='cpu')
  return RawFolder(runPath).loadHits('Detector')


def test_hits_plane_detection_and_projection(detectorHits):
  hits = detectorHits
  assert isinstance(hits, Hits) and set(COLUMNS) <= set(hits.keys())
  normal, _xvec = hits.detectPlaneNormal()
  assert abs(abs(normal[2]) - 1) < 1e-3 and normal[2] < 0
  proj = hits.planeProject3dPoints()
  assert proj.shape == (len(hits), 2)
  assert not hits.supportsFanMath()
  assert hits.powers().shape == (len(hits),)


def test_histograms_cartesian_and_polar(detectorHits):
  h = detectorHits.histogram(bins=21)
  assert isinstance(h, Histogram) and h.hist.sum() == len(detectorHits)
  hp = detectorHits.histogram(bins=15, binCoords='polar', radius=50.,
                              origin=(0., 0.))
  assert 0 < hp.hist.sum() <= len(detectorHits)
  rC, prof = hp.byAzimuth()
  assert prof.shape[1] == len(rC)


def test_update_result_entry_pads_missing_metadata():
  a = dict(points=np.zeros((2, 3)), powers=np.ones(2), source='S')
  b = dict(points=np.ones((3, 3)), powers=np.ones(3), fanIndex=np.arange(3.))
  out = updateResultEntry(updateResultEntry(None, a), b)
  assert out['points'].shape == (5, 3) and out['source'] == 'S'
  assert np.isnan(out['fanIndex'][:2]).all() and out['fanIndex'][4] == 2.


def test_small_helpers():
  pts = applyTransformation(np.array([[1., 0., 0.]]),
                            H.torchNs().T.translation(0, 2, 0))
  np.testing.assert_allclose(pts, [[1., 2., 0.]])
  calls = []

  @retryOnError(subject='flaky', maxRetries=2)
  def flaky():
    calls.append(1)
    if len(calls) < 2:
      raise RuntimeError('once')
    return 'ok'

  assert flaky() == 'ok' and len(calls) == 2

  @retryOnError(subject='fatal', maxRetries=2, fatal=(KeyError,))
  def fatal():
    calls.append(1)
    raise KeyError('through')

  with pytest.raises(KeyError):
    fatal()
  assert len(calls) == 3
  line = ProgressTracker.formatLine(dict(
      totalIterations=1, endAfterIterations=2, totalRecordedHits=3,
      endAfterHits=float('inf'), totalTracedRays=4, endAfterRays=8,
      elapsedSeconds=1.))
  assert line.startswith('iter 1/2, rays 4/8, hits 3') and 'ETA' in line
