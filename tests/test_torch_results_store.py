'''The PyTorch port's results store (simulation/results_store, utils/
native_store, simulation/lifecycle) against the JAX package's: run folders
written by either package load with the other's loaders — same folder and
file names, same column names, dtypes and values — in both the `odwc` and
the `npz` format. Host code only; values must be EQUAL (nothing is
recomputed, bytes are only written and read back).
'''

import glob
import os
import pickle
import time

import numpy as np
import pytest

import jax  # noqa: F401  (both packages live in this process)

from optics_design_workbench_tpu.simulation import results_store as jaxRS
from optics_design_workbench_tpu.simulation.lifecycle import \
    Lifecycle as JaxLifecycle
from optics_design_workbench_tpu.utils import native_store as jaxNative
from optics_design_workbench_tpu_torch.simulation import \
    results_store as torchRS
from optics_design_workbench_tpu_torch.simulation.lifecycle import (
    Lifecycle as TorchLifecycle, SimulationEnded)
from optics_design_workbench_tpu_torch.utils import io as torchIo
from optics_design_workbench_tpu_torch.utils import native_store as torchNative
from optics_design_workbench_tpu_torch.utils import timing as torchTiming

PACKAGES = {'torch': torchRS, 'jax': jaxRS}
DIRECTIONS = (('torch', 'jax'), ('jax', 'torch'), ('torch', 'torch'))
FORMATS = ('odwc', 'npz')


def _hitColumns(seed, n=300):
  rng = np.random.default_rng(seed)
  return dict(points=rng.normal(size=(n, 3)).astype(np.float32),
              directions=rng.normal(size=(n, 3)).astype(np.float32),
              powers=rng.random(n).astype(np.float32),
              isEntering=rng.random(n) > 0.5)


def _writeRun(RS, base, fileFormat, seed=0):
  res = RS.SimulationResults(
      simulationType='true', basePath=str(base),
      simulationRunFolder=RS.generateSimulationFolderName(str(base)),
      fileFormat=fileFormat)
  res.dumpGlobalInfo(dict(label='x', sources={'Source': {}}))
  cols = {}
  for obj in ('Detector', 'Screen'):
    cols[obj] = _hitColumns(seed + len(obj))
    res.addHitBatch('Source', obj, cols[obj]['points'],
                    cols[obj]['directions'], cols[obj]['powers'],
                    cols[obj]['isEntering'])
  res.incrementRayCount(1000)
  res.incrementIterationCount()
  res.cleanup()
  return res, cols


@pytest.mark.parametrize('fileFormat', FORMATS)
@pytest.mark.parametrize('writer,reader', DIRECTIONS)
def test_hit_files_cross_load(tmp_path, writer, reader, fileFormat):
  res, cols = _writeRun(PACKAGES[writer], tmp_path, fileFormat)
  RS = PACKAGES[reader]
  runPath = res.runPath()
  assert os.path.basename(runPath) == 'simulation-run-000000'
  for obj, want in cols.items():
    folder = os.path.join(runPath, 'source-Source', f'object-{obj}')
    files = RS.resultFilePaths(folder, 'hits')
    assert len(files) == 1 and files[0].endswith('-hits.' + fileFormat)
    got = RS.loadResultFile(files[0])
    assert set(got) == {'source', 'obj', 'points', 'directions', 'powers',
                        'isEntering'}
    assert str(np.asarray(got['source']).reshape(-1)[0]) == 'Source'
    assert str(np.asarray(got['obj']).reshape(-1)[0]) == obj
    for k in ('points', 'directions', 'powers'):
      assert got[k].dtype == np.float32, k
      np.testing.assert_array_equal(got[k], want[k])
    assert got['isEntering'].dtype.itemsize == 1
    np.testing.assert_array_equal(got['isEntering'].astype(bool),
                                  want['isEntering'])


@pytest.mark.parametrize('fileFormat', FORMATS)
def test_both_packages_write_the_same_columns(tmp_path, fileFormat):
  '''Same input through both writers: the loaded files agree in keys,
  dtypes, shapes and values.'''
  loaded = {}
  for name, RS in PACKAGES.items():
    res, _ = _writeRun(RS, tmp_path / name, fileFormat, seed=3)
    f = torchRS.resultFilePaths(os.path.join(
        res.runPath(), 'source-Source', 'object-Detector'), 'hits')[0]
    loaded[name] = torchRS.loadResultFile(f)
  a, b = loaded['torch'], loaded['jax']
  assert set(a) == set(b)
  for k in a:
    assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
    np.testing.assert_array_equal(a[k], b[k])


class _Clock:
  '''The `time` module as a writer module sees it, with a `time()` that
  starts at `start` and moves `step` seconds a call (0 pins it).'''

  def __init__(self, start, step):
    self.now, self.step = start, step

  def time(self):
    t = self.now
    self.now += self.step
    return t

  def __getattr__(self, name):
    return getattr(time, name)


def _writeTwoSnapshots(RS, tmp_path):
  '''One writer's run folder with two snapshots of one source, the second
  superseding the first. Returns (results, the later snapshot, meta).'''
  res = RS.SimulationResults(
      simulationType='true', basePath=str(tmp_path),
      simulationRunFolder=RS.generateSimulationFolderName(str(tmp_path)))
  rng = np.random.default_rng(1)
  meta = dict(bounds=np.array([[-1., 1., -2., 2.], [0., 1., 0., 1.]],
                              np.float32), detLabels=['DetA', 'DetB'])
  first = dict(power=rng.random((2, 4, 8)).astype(np.float32),
               counts=rng.integers(0, 9, (2, 4, 8)).astype(np.float32))
  res.writeHistogramSnapshot('Source', first, meta)
  later = {k: v * 2 for k, v in first.items()}
  res.writeHistogramSnapshot('Source', later, meta)   # supersedes the first
  res.cleanup()
  return res, later, meta


def _snapshotFiles(res):
  return glob.glob(os.path.join(res.runPath(), 'source-Source',
                                '*-histograms.npz'))


@pytest.mark.parametrize('writer,reader', DIRECTIONS)
def test_histogram_snapshots_cross_load(tmp_path, writer, reader,
                                        monkeypatch):
  # a clock that moves 2 ms a call: the two snapshots get two names
  RS = PACKAGES[writer]
  monkeypatch.setattr(RS, 'time', _Clock(1.7e9, 2e-3))
  res, later, meta = _writeTwoSnapshots(RS, tmp_path)
  files = _snapshotFiles(res)
  assert len(files) == 1
  snaps = PACKAGES[reader].loadHistogramSnapshots(res.runPath())
  assert set(snaps) == {'Source'} and set(snaps['Source']) == {'DetA', 'DetB'}
  for d, label in enumerate(meta['detLabels']):
    h = snaps['Source'][label]
    assert h['power'].dtype == np.float32 and h['power'].shape == (4, 8)
    np.testing.assert_array_equal(h['power'], later['power'][d])
    np.testing.assert_array_equal(h['counts'], later['counts'][d])
    np.testing.assert_array_equal(h['bounds'], meta['bounds'][d])


@pytest.mark.parametrize('writer', [
    'torch',
    pytest.param('jax', marks=pytest.mark.xfail(
        strict=True, reason='fault of the reference (ROADMAP C, "a '
        'histogram snapshot written in the same millisecond as the one '
        'before deletes itself"): its writer leaves 0 files'))])
def test_snapshot_same_millisecond(tmp_path, writer, monkeypatch):
  # a pinned clock: both snapshots get the same name, and the later one
  # must survive as the only file
  RS = PACKAGES[writer]
  monkeypatch.setattr(RS, 'time', _Clock(1.7e9, 0.))
  res, later, meta = _writeTwoSnapshots(RS, tmp_path)
  assert len(_snapshotFiles(res)) == 1
  h = torchRS.loadHistogramSnapshots(res.runPath())['Source']
  for d, label in enumerate(meta['detLabels']):
    np.testing.assert_array_equal(h[label]['counts'], later['counts'][d])
    np.testing.assert_array_equal(h[label]['power'], later['power'][d])


@pytest.mark.parametrize('name', sorted(PACKAGES))
def test_folder_contract(tmp_path, name):
  RS = PACKAGES[name]
  base = RS.getResultsFolderPath(str(tmp_path / 'doc.FCStd'))
  assert base == str(tmp_path / 'doc.OpticsDesign') and os.path.isdir(base)
  res, _ = _writeRun(RS, base, 'npz')
  assert os.path.isfile(os.path.join(base, 'README.md'))
  assert os.path.isdir(os.path.join(base, 'notebooks'))
  runPath = res.runPath()
  assert any(f.startswith('uid-') for f in os.listdir(runPath))
  with open(os.path.join(runPath, 'global-info.pkl'), 'rb') as f:
    assert pickle.load(f)['label'] == 'x'
  assert RS.getLatestRunIndex(base) == 0
  assert RS.generateSimulationFolderName(base) == 'raw/simulation-run-000001'
  progress = res.getProgress()
  assert progress['totalRecordedHits'] == 600
  assert progress['totalTracedRays'] == 1000
  assert glob.glob(os.path.join(runPath, 'progress', 'master-*'))
  with pytest.raises(RuntimeError, match='cleaned up'):
    res.addHitBatch('Source', 'Detector', np.zeros((1, 3)), np.zeros((1, 3)),
                    np.zeros(1), np.zeros(1))


def test_readme_names_the_writing_package(tmp_path):
  for name, RS in PACKAGES.items():
    _writeRun(RS, tmp_path / name, 'npz')
  with open(tmp_path / 'torch' / 'README.md') as f:
    assert 'optics_design_workbench_tpu_torch' in f.read()


def test_chunk_files_merges_and_stays_loadable_by_both(tmp_path):
  res = torchRS.SimulationResults(
      simulationType='true', basePath=str(tmp_path),
      simulationRunFolder='raw/simulation-run-000000', fileFormat='npz')
  want = []
  for i in range(3):
    cols = _hitColumns(10 + i, n=50)
    want.append(cols['points'])
    res.addHitBatch('Source', 'Detector', cols['points'], cols['directions'],
                    cols['powers'], cols['isEntering'])
    res.flush()
  res.cleanup()
  folder = os.path.join(res.runPath(), 'source-Source', 'object-Detector')
  assert len(torchRS.resultFilePaths(folder, 'hits')) == 3
  assert torchRS.chunkFiles(res.runPath(), olderThanSeconds=-1) == 3
  for RS in PACKAGES.values():
    files = RS.resultFilePaths(folder, 'hits')
    assert len(files) == 1 and '-hits-chunk.' in files[0]
    got = RS.loadResultFile(files[0])['points']
    assert sorted(map(tuple, got)) == sorted(map(tuple,
                                                 np.concatenate(want)))


def test_native_store_has_its_own_library_and_format_matches(tmp_path):
  '''The two packages never share a built library (each rebuilds when older
  than ITS source), and the bytes they write are the same format.'''
  assert torchNative._libPath() != jaxNative._libPath()
  assert os.path.isfile(torchNative._sourcePath())
  assert 'optics_design_workbench_tpu_torch' in torchNative._sourcePath()
  cols = dict(a=np.arange(12, dtype=np.float32).reshape(4, 3),
              b=np.arange(4, dtype=np.int64), flag=np.array([1, 0, 1, 1],
                                                            np.uint8),
              name=np.array(['Detector']))
  pNative = str(tmp_path / 'native.odwc')
  pPython = str(tmp_path / 'python.odwc')
  pJax = str(tmp_path / 'jax.odwc')
  torchNative.writeColumns(pNative, cols, asynchronous=False)
  torchNative._writeColumnsPython(pPython, cols)
  jaxNative.writeColumns(pJax, cols, asynchronous=False)
  with open(pPython, 'rb') as f:
    raw = f.read()
  for p in (pNative, pJax):
    with open(p, 'rb') as f:
      assert f.read() == raw
  for read in (torchNative.readColumns, jaxNative.readColumns):
    got = read(pNative)
    for k, v in cols.items():
      np.testing.assert_array_equal(got[k], v)
      assert got[k].dtype == v.dtype


def test_native_async_spool_drains(tmp_path):
  paths = [str(tmp_path / f'f{i}.odwc') for i in range(20)]
  for i, p in enumerate(paths):
    torchNative.writeColumns(p, dict(x=np.full(1000, i, np.float32)))
  torchNative.drain()
  for i, p in enumerate(paths):
    assert (torchNative.readColumns(p)['x'] == i).all()


def test_lifecycle_flags_interoperate(tmp_path):
  '''Either package's Lifecycle sees the other's flag files.'''
  a, b = TorchLifecycle(str(tmp_path)), JaxLifecycle(str(tmp_path))
  a.setIsRunning(True)
  assert b.isRunning() and not b.isCanceled() and not b.isFinished()
  b.setIsCanceled(True)
  assert a.isCanceled()
  a.setIsFinished(True)
  assert b.isFinished()
  a.clearAll()
  assert not (b.isRunning() or b.isCanceled() or b.isFinished())
  assert issubclass(SimulationEnded, Exception)


def test_io_and_timing_helpers(tmp_path):
  p = str(tmp_path / 'sub' / 'blob.bin')
  torchIo.atomicWrite(p, b'abc')
  with open(p, 'rb') as f:
    assert f.read() == b'abc'
  assert not [f for f in os.listdir(tmp_path / 'sub') if f.startswith('.tmp')]
  pk = str(tmp_path / 'x.pkl')
  with open(pk, 'wb') as f:
    pickle.dump(dict(points=np.ones((2, 3))), f)
  assert torchIo.unpickle(pk)['points'].shape == (2, 3)
  assert torchIo.secondsToStr(3852) == '1h 4m'
  assert torchIo.secondsToStr(float('nan')) == '??'
  timer = torchTiming.IntervalTimer(1000, fireImmediately=True)
  assert timer.check() and not timer.check()
