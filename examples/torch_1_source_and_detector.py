'''
Example 1 on the PyTorch / CUDA port — Gaussian point source onto an
absorbing detector (the port's twin of examples/1_source_and_detector.py;
reference: examples/1-source-and-detector/main.FCStd + visualize.ipynb,
the first benchmark configuration in BASELINE.md).

    python3 examples/torch_1_source_and_detector.py [--device cpu]

Runs the Monte-Carlo run (200,000 rays in iterations of 50,000, storing the
four StoreHit* fan columns) and the deterministic ray-fan run (Fans=2,
RaysPerFan=21), then reconstructs the fans' power-density profiles.

Routes: the scene is one the kernels cover, so both runs go through the
raw-record CUDA kernel (K4) in its columns input mode: the Monte-Carlo
rays are drawn by the source's device generator (their metadata rides
beside them), the fans by `PointSource.generateRays('fans')` on the host.
Runs on the first CUDA device; `--device cpu` runs the kernel's plain
PyTorch version instead.
'''

import argparse
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from optics_design_workbench_tpu_torch.models import (Scene, PointSource,
                                                      OpticalGroup)
from optics_design_workbench_tpu_torch.geometry import surfaces as S
from optics_design_workbench_tpu_torch.geometry import transforms as T
from optics_design_workbench_tpu_torch import simulation
from optics_design_workbench_tpu_torch.jupyter_utils import RawFolder


def buildScene(path='example1'):
  '''The examples/1 scene: an absorbing 120 x 120 mm detector 100 mm from a
  point source `exp(-theta^2/0.01)` over theta in [0, pi/4] at 532 nm,
  with 2 fans of 21 rays, 50,000 rays per iteration up to 2e5 rays, 4
  intersections and the four StoreHit* fan columns.'''
  scene = Scene(label='example1', path=path)
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Absorber', Label='Detector',
      surfaces=[S.plane(np.eye(4), elem=0, halfExtents=(60., 60.))],
      placements=[T.translation(0, 0, 100)]))
  scene.addSource(PointSource(
      Label='Source', PowerDensity='exp(-theta^2/0.01)',
      ThetaDomain='0, pi/4', Wavelength=532.,
      Fans=2, RaysPerFan=21))
  scene.addSimulationSettings(
      EndAfterRays='2e5', RaysPerIteration=50000, MaxIntersections=4,
      EnableStoreSingleShotData=True,
      StoreHitFanIndex=True, StoreHitRayIndex=True,
      StoreHitTotalRaysInFan=True, StoreHitTotalFanCount=True)
  return scene


def main(device='cuda', path=None):
  '''Both runs; returns a dict of what they gave (hit counts, the spot's
  rms radius, the fans' keys, and each run's wall time in seconds).'''
  path = path or os.path.join(tempfile.mkdtemp(prefix='odw_example1_'),
                              'example1')
  scene = buildScene(path=path)
  t0 = time.perf_counter()
  raw = RawFolder(simulation.runSimulation(scene, 'true', seed=42,
                                           device=device))
  tMc = time.perf_counter() - t0
  hits = raw.loadHits('Detector')
  r = np.hypot(hits.points()[:, 0], hits.points()[:, 1])
  rms = float(np.sqrt((r ** 2).mean()))
  print(f'Monte-Carlo: {len(hits)} hits in {tMc:.3f} s, spot rms radius '
        f'{rms:.2f} mm')
  t0 = time.perf_counter()
  rawFan = RawFolder(simulation.runSimulation(scene, 'fans', device=device))
  tFan = time.perf_counter() - t0
  fanHits = rawFan.loadHits('Detector')
  dens = fanHits.fanEstimatedPowerDensities()
  print(f'fans: {len(fanHits)} hits in {tFan:.3f} s, {fanHits.fanCount()} '
        f'fans, power-density profiles for fans {sorted(dens)}')
  return dict(hits=len(hits), rms=rms, fanHits=len(fanHits),
              fanKeys=sorted(k for k in fanHits.hits
                             if k in ('fanIndex', 'rayIndex', 'totalFanCount',
                                      'totalRaysInFan')),
              fans=sorted(dens), monteCarloSeconds=tMc, fanSeconds=tFan)


if __name__ == '__main__':
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[1])
  parser.add_argument('--device', default='cuda')
  main(parser.parse_args().device)
