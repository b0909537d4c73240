'''
Example 3 on the PyTorch / CUDA port — lens-radius parameter sweep /
optimization minimizing detector spot size (the port's twin of
examples/3_parameter_sweeps.py; reference:
examples/3-parameter-sweeps/main.FCStd + sweep.ipynb).

    python3 examples/torch_3_parameter_sweeps.py [--device cpu]

Shows both workflows:
  * the batched sweep: every candidate radius compiled host-side into one
    stacked table and traced by ONE launch of the CUDA sweep kernel
    (variant-major grid, the same rays in every variant), the histograms
    fetched in one copy;
  * scipy optimization through ParameterSweeper.optimize (the reference's
    path: one simulation per evaluation, hits read back from the run
    folder).

Runs on the first CUDA device; `--device cpu` runs the kernels' plain
PyTorch versions instead.
'''

import argparse
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from optics_design_workbench_tpu_torch.benchmarks import buildSweepLensScene
from optics_design_workbench_tpu_torch.jupyter_utils import (ParameterSweeper,
                                                             Parameter)


def main(device='cuda'):
  tmp = tempfile.mkdtemp(prefix='odw_example3_')
  path = os.path.join(tmp, 'example3')
  holder = dict(scene=buildSweepLensScene(path=path), R=60.)

  def setRadius(r):
    holder['R'] = float(r)
    holder['scene'] = buildSweepLensScene(float(r), path=path)
    sweeper.scene = holder['scene']   # keep the optimizer on the new scene

  sweeper = ParameterSweeper(
      lambda sc: dict(R=Parameter(getter=lambda: holder['R'],
                                  setter=setRadius, bounds=(40., 100.))),
      scene=holder['scene'], device=device)

  # --- batched sweep: all radii in ONE kernel launch ---
  radii = np.linspace(45., 95., 11)

  def spotMetric(power, counts):
    H = counts[0]
    n = H.sum()
    if n == 0:
      return 1e9
    ys, xs = np.indices(H.shape)
    cy, cx = (H * ys).sum() / n, (H * xs).sum() / n
    return float((H * ((ys - cy) ** 2 + (xs - cx) ** 2)).sum() / n)

  metrics = sweeper.evaluateBatched(
      [dict(R=r) for r in radii], spotMetric,
      sceneFactory=lambda: holder['scene'],
      raysPerScene=20000, maxIntersections=6, bins=(64, 64),
      histBounds=(-40., 40., -40., 40.))
  for r, m in zip(radii, metrics):
    print(f'R={r:6.1f} mm -> spot second moment {m:8.2f} bins^2')
  best = radii[int(np.argmin(metrics))]
  print(f'batched sweep ({sweeper.lastBatchedRoute} route) best radius: '
        f'{best:.1f} mm (paraxial theory: f=120 mm -> R = f*(n-1) = 60 mm)')

  # --- reference-style scipy optimization (one simulation per step) ---
  def spotSize(raw):
    hits = raw.loadHits('Detector')
    p = hits.points()
    if len(p) < 100:
      return 1e6
    return float(np.hypot(p[:, 0] - p[:, 0].mean(),
                          p[:, 1] - p[:, 1].mean()).std())

  sweeper.scene = holder['scene']
  result = sweeper.optimize(spotSize, ['R'], method='Nelder-Mead',
                            maxIterations=10, seed=1)
  print(f'scipy optimize best: R={result.bestParams["R"]:.1f} mm, '
        f'spot std {result.bestPenalty:.2f} mm '
        f'({len(sweeper.history)} evaluations; run folders under {tmp})')


if __name__ == '__main__':
  parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
  parser.add_argument('--device', default='cuda')
  main(parser.parse_args().device)
