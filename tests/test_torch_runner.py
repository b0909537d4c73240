'''The slice as a whole: `simulation.runSimulation` of the PyTorch port (on
the CPU, through the kernels' plain versions) beside the JAX package's, on
the reference suite's end-to-end scene (tests/test_simulation_e2e.py).

The two packages draw from independent random number generators, so the two
runs are compared by the reference test's own statistics, not ray for ray:
same folder contract and column set; >= 19000 hits of 2e4 rays, all on
z = 100 within 1e-3 mm; theta histogram within rms 0.05 of the source
density (the reference's own limit); hits per traced ray of the two
packages within 0.01 of each other.
'''

import glob
import os
import pickle

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (both frameworks live in this process)

import torch_port_helpers as H
from optics_design_workbench_tpu import simulation as jaxSim
from optics_design_workbench_tpu.simulation import results_store as jaxRS
from optics_design_workbench_tpu_torch import simulation as torchSim
from optics_design_workbench_tpu_torch.ops import cuda_trace
from optics_design_workbench_tpu_torch.simulation import \
    results_store as torchRS

torch.set_num_threads(1)


def loadAllHits(RS, runPath, source='*', obj='*'):
  cols = None
  for folder in glob.glob(f'{runPath}/source-{source}/object-{obj}'):
    for f in RS.resultFilePaths(folder, 'hits'):
      data = RS.loadResultFile(f)
      if cols is None:
        cols = {k: [v] for k, v in data.items() if v.ndim > 0}
      else:
        for k in cols:
          cols[k].append(data[k])
  if cols is None:
    return None
  return {k: np.concatenate(v) for k, v in cols.items()}


def _tree(runPath):
  '''The run folder's layout with run-specific names (uid, timestamps,
  process ids) replaced by their kind.'''
  out = set()
  for root, _dirs, files in os.walk(runPath):
    rel = os.path.relpath(root, runPath)
    for f in files:
      if f.startswith('uid-'):
        f = 'uid-*'
      elif f.startswith('master-'):
        f = 'master-*'
      elif '-pid' in f:
        f = '*-' + f.rsplit('-', 1)[-1]
      out.add(os.path.normpath(os.path.join(rel, f)))
  return out


@pytest.fixture(scope='module')
def bothRuns(tmp_path_factory):
  '''runSimulation(scene, 'true') once in each package.'''
  out = {}
  for name, ns, sim in (('jax', H.jaxNs(), jaxSim),
                        ('torch', H.torchNs(), torchSim)):
    base = tmp_path_factory.mktemp(name)
    scene = H.buildE2eScene(ns, str(base / 'example1'))
    progress = []
    kw = dict(device='cpu') if name == 'torch' else {}
    runPath = sim.runSimulation(scene, 'true', seed=42,
                                progressCallback=progress.append, **kw)
    out[name] = dict(runPath=runPath, folder=str(base /
                                                 'example1.OpticsDesign'),
                     progress=progress[-1])
  return out


def test_continuous_true_meets_the_reference_statistics(bothRuns):
  run = bothRuns['torch']
  runPath, folder = run['runPath'], run['folder']
  assert runPath and os.path.isdir(runPath)
  assert os.path.isfile(os.path.join(folder, 'README.md'))
  assert any(f.startswith('uid-') for f in os.listdir(runPath))
  with open(os.path.join(runPath, 'global-info.pkl'), 'rb') as f:
    info = pickle.load(f)
  assert 'Source' in info['sources'] and 'Detector' in info['opticalObjects']
  hits = loadAllHits(torchRS, runPath, 'Source', 'Detector')
  pts = hits['points']
  assert len(pts) >= 19000
  assert len(pts) == run['progress']['totalRecordedHits']
  assert np.allclose(pts[:, 2], 100., atol=1e-3)
  theta = np.arctan(np.hypot(pts[:, 0], pts[:, 1]) / 100.)
  hist, edges = np.histogram(theta, bins=30, range=(0, 0.35), density=True)
  centers = (edges[1:] + edges[:-1]) / 2
  expected = np.exp(-centers ** 2 / 0.01) * np.sin(centers)
  expected /= expected.sum() * (edges[1] - edges[0])
  rms = np.sqrt(np.mean(((hist - expected) / expected.max()) ** 2))
  assert rms < 0.05
  # incoming direction of an absorbed ray points from the source at the hit
  d = hits['directions']
  np.testing.assert_allclose(d, pts / np.linalg.norm(pts, axis=1,
                                                     keepdims=True),
                             atol=1e-5)
  # the rays run along the detector plane's +z normal: not 'entering'
  assert (hits['powers'] == 1.).all() and (hits['isEntering'] == 0).all()
  lc = torchSim.Lifecycle(folder)
  assert not lc.isRunning() and lc.isFinished() and not lc.isCanceled()


def test_run_folders_share_the_contract(bothRuns):
  assert _tree(bothRuns['torch']['runPath']) == \
      _tree(bothRuns['jax']['runPath'])
  cols = {}
  for writer in ('jax', 'torch'):
    # each package's run loads with the OTHER package's loaders
    RS = torchRS if writer == 'jax' else jaxRS
    cols[writer] = loadAllHits(RS, bothRuns[writer]['runPath'], 'Source',
                               'Detector')
  a, b = cols['torch'], cols['jax']
  # The port stores what the reference's kernel raw path stores. On the CPU
  # the reference goes through its record tracer instead, which adds the
  # source's init* metadata columns; those are the only difference.
  assert set(a) == {'points', 'directions', 'powers', 'isEntering', 'source',
                    'obj'}
  assert set(a) <= set(b)
  assert all(k.startswith('init') for k in set(b) - set(a))
  assert (a['isEntering'] == 0).all() and (b['isEntering'] == 0).all()
  for k in a:
    assert a[k].dtype == b[k].dtype and a[k].shape[1:] == b[k].shape[1:], k
  pa, pb = bothRuns['torch']['progress'], bothRuns['jax']['progress']
  # hits per traced ray (the port pads an iteration to 5120 rays)
  shareA = len(a['points']) / pa['totalTracedRays']
  shareB = len(b['points']) / pb['totalTracedRays']
  assert abs(shareA - shareB) < 0.01
  assert set(pa) == set(pb)
  assert pa['reachedEnd'] and pa['totalTracedRays'] >= 2e4


@pytest.fixture
def scene(tmp_path):
  return H.buildE2eScene(H.torchNs(), str(tmp_path / 'example1'))


def test_end_after_hits(scene):
  settings = scene.getObject('SimulationSettings')
  settings.EndAfterRays = 'inf'
  settings.EndAfterHits = '7000'
  runPath = torchSim.runSimulation(scene, 'true', seed=1, device='cpu')
  hits = loadAllHits(torchRS, runPath, 'Source', 'Detector')
  assert hits is not None and 7000 <= len(hits['points']) < 7000 + 5120


@pytest.mark.parametrize('action', ('singletrue', 'singlepseudo', 'pseudo'))
def test_other_monte_carlo_actions(scene, action):
  runPath = torchSim.runAction(scene, action, seed=3, device='cpu')
  n = len(loadAllHits(torchRS, runPath, 'Source', 'Detector')['points'])
  if action == 'pseudo':
    assert n >= 19000
  else:
    assert 4000 < n <= 5120     # one iteration of 5000 rays, block-padded


def test_single_shot_without_store_counts_hits_only(scene):
  scene.getObject('SimulationSettings').EnableStoreSingleShotData = False
  progress = []
  runPath = torchSim.runSimulation(scene, 'singletrue', seed=3, device='cpu',
                                   progressCallback=progress.append)
  assert loadAllHits(torchRS, runPath) is None
  assert 4000 < progress[-1]['totalRecordedHits'] <= 5120


def test_stop_action_cancels(scene, tmp_path):
  assert torchSim.runSimulation(scene, 'stop') is None
  lc = torchSim.Lifecycle(str(tmp_path / 'example1.OpticsDesign'))
  assert lc.isCanceled()
  lc.clearAll()
  assert torchSim.runSimulation(scene, 'clear') is None
  assert lc.isCanceled()


def test_refuses_to_start_twice(scene, tmp_path):
  lc = torchSim.Lifecycle(torchSim.getResultsFolderPath(
      str(tmp_path / 'example1')))
  lc.setIsRunning(True)
  with pytest.raises(RuntimeError, match='already running'):
    torchSim.runSimulation(scene, 'true', device='cpu')
  lc.clearAll()


@pytest.mark.parametrize('mode', ('true', 'pseudo'))
def test_histogram_mode_stores_snapshots_and_samples(scene, mode):
  progress = []
  runPath = torchSim.runSimulation(
      scene, mode, seed=7, recording='histogram', device='cpu',
      histBounds=(-50., 50., -50., 50.), histBins=(64, 64),
      rawSampleRays=512, rawSampleEvery=2, progressCallback=progress.append)
  for RS in (torchRS, jaxRS):
    h = RS.loadHistogramSnapshots(runPath)['Source']['Detector']
    counts = h['counts']
    assert counts.shape == (64, 64)
    # the snapshot holds exactly the hits the run counted
    assert counts.sum() == progress[-1]['totalRecordedHits'] > 1e4
    assert counts[16:48, 16:48].sum() / counts.sum() > .9
    assert np.allclose(h['bounds'], (-50., 50., -50., 50.))
  raw = loadAllHits(torchRS, runPath)
  assert raw is not None and 0 < len(raw['points']) < 5000
  assert progress[-1]['reachedEnd']
  assert progress[-1]['totalTracedRays'] == 4 * 5120


def test_histogram_matches_raw_counts(scene):
  '''Same seed: the device histogram's total count equals the raw path's
  recorded hit count (the detector plane and the histogram window
  coincide).'''
  runPath = torchSim.runSimulation(
      scene, 'singletrue', seed=9, recording='histogram', store=True,
      device='cpu', histBounds=(-50., 50., -50., 50.), histBins=(64, 64),
      rawSampleRays=0)
  nHist = torchRS.loadHistogramSnapshots(
      runPath)['Source']['Detector']['counts'].sum()
  runPath2 = torchSim.runSimulation(scene, 'singletrue', seed=9, store=True,
                                    device='cpu')
  assert nHist == len(loadAllHits(torchRS, runPath2)['points'])


def test_default_device_is_the_card(scene):
  if torch.cuda.is_available():
    pytest.skip('a card is present: the default device runs')
  with pytest.raises(RuntimeError, match="device='cuda'"):
    torchSim.runSimulation(scene, 'true')
  with pytest.raises(RuntimeError, match="device='cuda'"):
    torchSim.setupRandomSeed(1)


def _withMetadata(scene):
  scene.getObject('SimulationSettings').StoreHitInitPoint = True


def _withRecordRays(scene):
  scene.getObject('Source').RecordRays = True


def _withHostSource(scene):
  scene.getObject('Source').supportsDeviceSampling = lambda: False


def _small(scene):
  settings = scene.getObject('SimulationSettings')
  settings.RaysPerIteration = 512
  settings.EndAfterRays = 1024
  scene.getObject('Source').Fans, scene.getObject('Source').RaysPerFan = 2, 5


@pytest.mark.parametrize('case,kwargs,mutate,roadmap', (
    ('fans', dict(action='fans'), None, None),
    ('draw', dict(draw=True, action='singletrue'), None, None),
    ('mesh', dict(mesh=object()), None, 'A.13'),
    ('slaveInfo', dict(slaveInfo=dict(workerId='w0')), None, 'A.10c'),
    ('RecordRays', {}, _withRecordRays, None),
    ('StoreHit', {}, _withMetadata, None),
    ('device sampling', {}, _withHostSource, None),
    ('histogram-first recording', dict(recording='histogram'),
     _withRecordRays, 'A.4b'),
))
def test_unported_paths_raise_by_name(scene, case, kwargs, mutate, roadmap):
  '''mesh=, slaveInfo= and histogram-first recording on the record
  tracer's route are still refused by name; fans, draw=, RecordRays,
  StoreHit* metadata and host-sampled sources run (the record tracer and
  the raw-record kernel's columns mode took them).'''
  _small(scene)
  if mutate is not None:
    mutate(scene)
  kwargs = dict(kwargs)
  action = kwargs.pop('action', 'true')
  if roadmap is None:
    runPath = torchSim.runSimulation(scene, action, device='cpu', seed=3,
                                     **kwargs)
    assert os.path.isdir(runPath)
    lc = torchSim.Lifecycle(scene.resultsFolderPath())
    assert not lc.isRunning()
    return
  with pytest.raises(NotImplementedError) as err:
    torchSim.runSimulation(scene, action, device='cpu', **kwargs)
  assert case in str(err.value)
  assert f'ROADMAP item {roadmap}' in str(err.value)
  # nothing was started: no flag is left behind
  lc = torchSim.Lifecycle(scene.resultsFolderPath())
  assert not lc.isRunning()


def test_ineligible_scene_raises_by_name(scene, monkeypatch):
  '''A scene the kernels refuse (`ineligibleReason`) no longer raises: it
  goes through the record tracer, and its hits land where the kernels'
  would.'''
  monkeypatch.setattr(cuda_trace, 'ineligibleReason',
                      lambda sc: 'gratings are not ported yet')
  _small(scene)
  launched = []
  monkeypatch.setattr(cuda_trace, 'traceRaw',
                      lambda *a, **k: launched.append(1))
  runPath = torchSim.runSimulation(scene, 'true', seed=2, device='cpu')
  hits = loadAllHits(torchRS, runPath)
  assert not launched
  assert len(hits['points']) > 0.9 * 1024
  np.testing.assert_allclose(hits['points'][:, 2], 100., atol=1e-3)


def test_unknown_arguments_are_refused(scene):
  with pytest.raises(ValueError, match='unknown action'):
    torchSim.runSimulation(scene, 'bogus', device='cpu')
  with pytest.raises(TypeError, match='unexpected keyword'):
    torchSim.runSimulation(scene, 'true', device='cpu', bogus=1)
