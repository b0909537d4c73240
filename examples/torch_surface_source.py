'''
Surface source on the PyTorch / CUDA port — the reference's surface-source
scene (`benchmarks.buildSurfaceSourceScene`): a cos(theta)^2 disc emitter of
radius 20 mm radiates towards a 45 deg fold mirror (reflectivity 0.98) and
an absorbing detector plane of 240 x 240 mm beside the axis.

    python3 examples/torch_surface_source.py [--device cpu]

Runs the scene twice through `simulation.runSimulation`: with raw recording
(every hit stored; one launch of the raw-record CUDA kernel per iteration,
rays drawn on the emitter inside the kernel) and with histogram-first
recording (one launch of the histogram kernel per iteration, detector
histograms kept on the card). Prints the detected share of the rays, the
mean detected power (between 0.98 for rays that met the mirror and 1 for
rays that reached the detector directly) and where the spot lies.

Runs on the first CUDA device; `--device cpu` runs the kernels' plain
PyTorch versions instead.
'''

import argparse
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from optics_design_workbench_tpu_torch import benchmarks, simulation
from optics_design_workbench_tpu_torch.jupyter_utils import RawFolder
from optics_design_workbench_tpu_torch.simulation import results_store

BOUNDS = (-120., 120., -120., 120.)


def main(device='cuda', raysPerIteration=1 << 16, iterations=4):
  tmp = tempfile.mkdtemp(prefix='odw_surface_source_')
  scene = benchmarks.buildSurfaceSourceScene(tmpdir=tmp)
  settings = scene.activeSimulationSettings()
  settings.RaysPerIteration = raysPerIteration
  settings.EndAfterIterations = iterations
  settings.EndAfterRays = 'inf'
  progress = []
  runPath = simulation.runSimulation(scene, 'true', seed=9, device=device,
                                     progressCallback=progress.append)
  hits = RawFolder(runPath).loadHits('Detector')
  traced = progress[-1]['totalTracedRays']
  pts = hits.points()
  print(f'raw run: {runPath}')
  print(f'  {len(hits)} hits of {traced} rays '
        f'({len(hits) / traced:.4f} detected), mean power '
        f'{float(hits.powers().astype(np.float64).mean()):.5f}, spot centre '
        f'y = {pts[:, 1].mean():.2f}, z = {pts[:, 2].mean():.2f} mm on the '
        f'plane x = {pts[:, 0].mean():.2f} mm')

  progress.clear()
  runPath = simulation.runSimulation(scene, 'true', seed=10, device=device,
                                     recording='histogram', histBins=(64, 64),
                                     histBounds=BOUNDS,
                                     progressCallback=progress.append)
  snap = results_store.loadHistogramSnapshots(runPath)['Source']['Detector']
  counts = snap['counts'].astype(np.float64)
  traced = progress[-1]['totalTracedRays']
  print(f'histogram run: {runPath}')
  print(f'  {counts.sum():.0f} counts of {traced} rays '
        f'({counts.sum() / traced:.4f} detected), mean power '
        f'{snap["power"].astype(np.float64).sum() / counts.sum():.5f}, '
        f'fullest bin {counts.max() / counts.sum():.4f} of the counts')


if __name__ == '__main__':
  parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
  parser.add_argument('--device', default='cuda',
                      help="'cuda' (default) or 'cpu' for the plain versions")
  main(parser.parse_args().device)
