'''
A triangle mesh from an STL file on the PyTorch / CUDA port — the
reference's 1800-triangle dish (`benchmarks.buildMeshDishScene(30)`): a
paraboloid mirror of radius 40 mm at z = 60 mm, written as a binary STL,
loaded back with `geometry.mesh.loadSTL`, turned into triangle surfaces by
`meshSurfaces` and placed as an `OpticalGroup` over an absorbing 400 x 400
mm detector at z = 0; a point source just above the detector lights it.

    python3 examples/torch_mesh_dish.py [--device cpu]

A mesh past 128 triangles is swept from the kernels' triangle table (one
chunked, Morton-ordered table in device memory). Runs the scene twice
through `simulation.runSimulation`: with raw recording (one launch of the
raw-record kernel per iteration) and with histogram-first recording (one
launch of the histogram kernel per iteration). Prints the detected share of
the rays (1: the dish returns every ray to the detector) and the spot's
mean r^2.

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
from optics_design_workbench_tpu_torch.geometry import mesh, surfaces
from optics_design_workbench_tpu_torch.geometry import transforms
from optics_design_workbench_tpu_torch.jupyter_utils import RawFolder
from optics_design_workbench_tpu_torch.models import (OpticalGroup,
                                                      PointSource, Scene)
from optics_design_workbench_tpu_torch.simulation import results_store

BOUNDS = (-200., 200., -200., 200.)


def buildDishFromSTL(tmpdir, nQ=30):
  '''The dish scene of `nQ * nQ * 2` triangles with its mirror read from a
  binary STL file written into `tmpdir` (the scene's results go there too).
  Returns (scene, STL path).'''
  tris = benchmarks.dishTriangles(nQ)
  path = os.path.join(tmpdir, f'dish{len(tris)}.stl')
  mesh.writeBinarySTL(path, tris.reshape(-1, 3),
                      np.arange(3 * len(tris)).reshape(-1, 3))
  vertices, faces = mesh.loadSTL(path)
  scene = Scene(label='mesh_dish', path=os.path.join(tmpdir, 'mesh_dish'))
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Mirror', Label='Dish',
      surfaces=mesh.meshSurfaces(vertices, faces, elem=0)))
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Absorber', Label='Det',
      surfaces=[surfaces.plane(np.eye(4), elem=0,
                               halfExtents=(200., 200.))]))
  scene.addSource(PointSource(
      Label='Src', PowerDensity='exp(-theta^2/0.1)', ThetaDomain='0, 0.5',
      Wavelength=532., ThetaResolutionNumericMode='1e3',
      placement=transforms.translation(0, 0, 1e-3)))
  scene.addSimulationSettings(RaysPerIteration=1e6, MaxIntersections=3)
  return scene, path


def main(device='cuda', raysPerIteration=1 << 14, iterations=2):
  tmp = tempfile.mkdtemp(prefix='odw_mesh_dish_')
  scene, path = buildDishFromSTL(tmp)
  settings = scene.activeSimulationSettings()
  settings.RaysPerIteration = raysPerIteration
  settings.EndAfterIterations = iterations
  settings.EndAfterRays = 'inf'
  print(f'{path}: {len(scene.getObject("Dish").surfaces)} triangles')
  progress = []
  runPath = simulation.runSimulation(scene, 'true', seed=9, device=device,
                                     progressCallback=progress.append)
  hits = RawFolder(runPath).loadHits('Det')
  traced = progress[-1]['totalTracedRays']
  pts = hits.points()
  print(f'raw run: {runPath}')
  print(f'  {len(hits)} hits of {traced} rays '
        f'({len(hits) / traced:.4f} detected), mean r^2 '
        f'{float((pts[:, 0] ** 2 + pts[:, 1] ** 2).mean()):.1f} mm^2')

  progress.clear()
  runPath = simulation.runSimulation(scene, 'true', seed=10, device=device,
                                     recording='histogram',
                                     histBins=(128, 128), histBounds=BOUNDS,
                                     progressCallback=progress.append)
  snap = results_store.loadHistogramSnapshots(runPath)['Src']['Det']
  counts = snap['counts'].astype(np.float64)
  traced = progress[-1]['totalTracedRays']
  print(f'histogram run: {runPath}')
  print(f'  {counts.sum():.0f} counts of {traced} rays '
        f'({counts.sum() / traced:.4f} detected)')


if __name__ == '__main__':
  parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
  parser.add_argument('--device', default='cuda',
                      help="'cuda' (default) or 'cpu' for the plain versions")
  main(parser.parse_args().device)
