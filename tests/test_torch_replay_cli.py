'''The replay source and the command line on the PyTorch port: the replay
round trip of tests/test_sources.py on the CPU, run folders of one package
replayed by the other ray for ray, the port's `__main__` in process (run,
info, runs, export; bench and dryrun-multichip refused by their ROADMAP
items) and once as `python -m`, and the entry points' default device.'''

import glob
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import fcstd_fixtures as F
from optics_design_workbench_tpu import __main__ as jaxMain
from optics_design_workbench_tpu.models import ReplaySource as JaxReplay
from optics_design_workbench_tpu.simulation import results_store as jaxStore
from optics_design_workbench_tpu.simulation.lifecycle import \
    SimulationEnded as JaxEnded
from optics_design_workbench_tpu_torch import KernelError, simulation
from optics_design_workbench_tpu_torch import __main__ as cli
from optics_design_workbench_tpu_torch.geometry import surfaces as S
from optics_design_workbench_tpu_torch.geometry import transforms as T
from optics_design_workbench_tpu_torch.jupyter_utils import RawFolder
from optics_design_workbench_tpu_torch.models import (OpticalGroup,
                                                      PointSource,
                                                      ReplaySource, Scene)
from optics_design_workbench_tpu_torch.ops import cuda_trace
from optics_design_workbench_tpu_torch.simulation import results_store
from optics_design_workbench_tpu_torch.simulation.lifecycle import \
    SimulationEnded
from optics_design_workbench_tpu_torch.tracing import batch_tracer

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))


def loadHits(runPath, obj='Detector'):
  cols = None
  for folder in glob.glob(f'{runPath}/source-*/object-{obj}'):
    for f in results_store.resultFilePaths(folder, 'hits'):
      data = results_store.loadResultFile(f)
      if cols is None:
        cols = {k: [v] for k, v in data.items() if v.ndim > 0}
      else:
        for k in cols:
          cols[k].append(data[k])
  return None if cols is None else {k: np.concatenate(v)
                                    for k, v in cols.items()}


def _noKernels(monkeypatch):
  '''Make every kernel wrapper raise: a run that passes went through the
  record tracer.'''
  def refuse(*_a, **_k):
    raise AssertionError('a replay source reached a kernel')
  for name in ('traceHistogram', 'traceBins', 'traceRaw', 'traceSweep'):
    monkeypatch.setattr(cuda_trace, name, refuse)


def test_replay_roundtrip(tmp_path, monkeypatch):
  '''tests/test_sources.py's round trip on the port (CPU): record a probe
  plane's hits, replay them onto a detector through the record tracer (raw
  and histogram-first recording alike), then the stock is spent.'''
  scene = Scene(label='orig', path=str(tmp_path / 'orig'))
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Vacuum', Label='Probe', RecordHits=True,
      surfaces=[S.plane(np.eye(4), elem=0, halfExtents=(200., 200.))],
      placements=[T.translation(0, 0, 50)]))
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Absorber', Label='Final', RecordHits=True,
      surfaces=[S.plane(np.eye(4), elem=0, halfExtents=(200., 200.))],
      placements=[T.translation(0, 0, 100)]))
  scene.addSource(PointSource(Label='Src', PowerDensity='exp(-theta^2/0.01)',
                              ThetaDomain='0, 0.3',
                              ThetaResolutionNumericMode='1e4'))
  scene.addSimulationSettings(RaysPerIteration=2000,
                              EnableStoreSingleShotData=True)
  run1 = simulation.runSimulation(scene, 'singletrue', seed=5, device='cpu')
  probeDir = os.path.join(run1, 'source-Src', 'object-Probe')
  assert results_store.resultFilePaths(probeDir, 'hits')

  _noKernels(monkeypatch)
  scene2 = Scene(label='replayed', path=str(tmp_path / 'replayed'))
  scene2.addOpticalGroup(OpticalGroup(
      OpticalType='Absorber', Label='Detector',
      surfaces=[S.plane(np.eye(4), elem=0, halfExtents=(300., 300.))],
      placements=[T.translation(0, 0, 100)]))
  replay = ReplaySource(Label='Replay', ReplayFromDir=probeDir,
                        usedFilesDir=str(tmp_path / 'used'))
  scene2.addSource(replay)
  scene2.addSimulationSettings(EnableStoreSingleShotData=True,
                               EndAfterIterations='inf')
  run2 = simulation.runSimulation(scene2, 'true', seed=6, device='cpu')
  hits = loadHits(run2)
  assert hits is not None and len(hits['points']) > 1500
  # replayed rays start at z = 50 moving +z: detector hits at z = 100
  assert np.allclose(hits['points'][:, 2], 100., atol=1e-3)
  # the stock is spent: the next runs end at once, whatever they record
  for recording in ('raw', 'histogram'):
    run3 = simulation.runSimulation(scene2, 'true', seed=7, device='cpu',
                                    recording=recording)
    assert loadHits(run3) is None
  replay.resetUsedFiles()
  run4 = simulation.runSimulation(scene2, 'true', seed=8, device='cpu',
                                  recording='histogram')
  assert RawFolder(run4).progress()['totalTracedRays'] == \
      len(hits['points'])
  with pytest.raises(ValueError, match='fan mode'):
    replay.generateRays('fans')


def _writeHits(store, folder, fmt, withWavelength):
  '''Two hits files of one run folder written by `store`'s
  SimulationResults in file format `fmt`.'''
  results = store.SimulationResults('true', folder, 'simulation-run-000000',
                                    fileFormat=fmt)
  rng = np.random.default_rng(3)
  for n in (40, 25):
    d = rng.normal(size=(n, 3))
    meta = ({'initWavelength': rng.uniform(400., 700., n)}
            if withWavelength else None)
    results.addHitBatch('Src', 'Probe', rng.normal(size=(n, 3)) * 10.,
                        d / np.linalg.norm(d, axis=1, keepdims=True),
                        rng.uniform(.1, 1., n), np.zeros(n, np.int8),
                        metadata=meta)
    results.flush()
    # the JAX package names a hits file by its millisecond (ROADMAP C)
    time.sleep(.002)
  store.native_store.drain()
  assert len(glob.glob(f'{folder}/*/*/*/*-hits.{fmt}')) == 2
  return os.path.join(folder, 'simulation-run-000000')


def _replayAll(cls, folder, used, wavelength):
  src = cls(Label='Replay', ReplayFromDir=folder, usedFilesDir=used,
            Wavelength=wavelength,
            placement=T.translation(1., 2., 3.) @ T.rotation((0, 1, 0), 30))
  rng = np.random.default_rng(11)
  out = []
  while True:
    try:
      out.append(src.generateRays('true', rng=rng))
    except (SimulationEnded, JaxEnded):
      return out


@pytest.mark.parametrize('writer', ['jax', 'port'])
@pytest.mark.parametrize('fmt', ['npz', 'odwc'])
def test_run_folders_replay_across_packages(writer, fmt, tmp_path):
  '''A run folder that one package wrote replays in the other with the
  same rays, file by file, on the same numpy seed: origins, directions,
  powers and wavelengths (recorded, or the source's override).'''
  store = dict(jax=jaxStore, port=results_store)[writer]
  for withWavelength, wavelength in ((True, None), (False, 633.)):
    folder = _writeHits(store, str(tmp_path / f'{withWavelength}'), fmt,
                        withWavelength)
    port = _replayAll(ReplaySource, folder, str(tmp_path / f'p{wavelength}'),
                      wavelength)
    ref = _replayAll(JaxReplay, folder, str(tmp_path / f'j{wavelength}'),
                     wavelength)
    assert len(port) == len(ref) == 2
    for a, b in zip(port, ref):
      for key in ('origins', 'directions', 'powers', 'wavelengths'):
        np.testing.assert_array_equal(a[key], b[key])
    if not withWavelength:
      assert (port[0]['wavelengths'] == 633.).all()


# ---- the command line

@pytest.fixture(scope='module')
def project(tmp_path_factory):
  return F.sourceDetectorProject(str(tmp_path_factory.mktemp('cli')))


def test_cli_run_runs_and_export(project, tmp_path, capsys):
  assert cli.main(['run', project, 'singletrue', '--seed', '3', '--store',
                   '--device', 'cpu']) == 0
  runPath = capsys.readouterr().out.strip()
  hits = RawFolder(runPath).loadHits('OpticalAbsorberGroup')
  assert len(hits) > 300
  assert np.allclose(hits.points()[:, 2], 50., atol=1.1)
  assert cli.main(['runs', project]) == 0
  listed = capsys.readouterr().out.splitlines()
  assert len(listed) == 1 and listed[0].startswith(runPath + '  rays=')
  assert listed[0].endswith(f' hits={len(hits)}')
  out = str(tmp_path / 'scene.ply')
  assert cli.main(['export', project, out, '--resolution', '8']) == 0
  assert capsys.readouterr().out.strip() == out
  with open(out, 'rb') as f:
    assert f.read(3) == b'ply'


def test_cli_info_matches_the_reference(project, capsys):
  assert cli.main(['info', project]) == 0
  port = json.loads(capsys.readouterr().out)
  assert jaxMain.main(['info', project]) == 0
  assert port == json.loads(capsys.readouterr().out)
  assert port['opticalObjects'] == {
      'OpticalAbsorberGroup': 'Absorber (6 plane)'}


def test_cli_refuses_what_is_not_ported(project):
  for argv, item in ((['bench'], 'A.5'), (['dryrun-multichip', '4'], 'A.13')):
    with pytest.raises(NotImplementedError, match=f'ROADMAP item {item} '):
      cli.main(argv)
  # the default device is the card: without one the run raises
  with pytest.raises(KernelError, match='no CUDA device'):
    cli.main(['run', project, 'singletrue', '--seed', '1'])


def test_cli_as_a_module(project):
  env = dict(os.environ, PYTHONPATH=os.path.dirname(HERE))
  out = subprocess.run([sys.executable, '-m',
                        'optics_design_workbench_tpu_torch', 'info', project],
                       capture_output=True, text=True, timeout=120, env=env)
  assert out.returncode == 0, out.stderr[-2000:]
  info = json.loads(out.stdout)
  assert info['label'] == 'source_detector'
  assert info['sources'] == {'OpticalPointSource': 'exp(-theta^2/0.01)'}


def test_entry_points_default_to_the_card():
  '''The record tracer's scene and the surface split default to the card,
  as every entry point does, and raise without one.'''
  scene = Scene(label='one')
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Absorber', Label='D',
      surfaces=[S.plane(np.eye(4), elem=0, halfExtents=(5., 5.))]))
  host, _info = scene.compile(device=None)
  with pytest.raises(KernelError, match='no CUDA device'):
    batch_tracer.prepareScene(host)
  with pytest.raises(KernelError, match='no CUDA device'):
    S.byKind(host['surfaces'])
  assert batch_tracer.prepareScene(host, 'cpu')['_prepared']
