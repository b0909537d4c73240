'''
Example 4 on the PyTorch / CUDA port — grating spectrometer (the port's twin
of examples/4_spectrometer.py; reference: docs/example-spectrometer.rst, the
4th benchmark configuration in BASELINE.md): point sources of several
wavelengths hit a reflection grating at normal incidence and are angularly
resolved onto a detector.

    python3 examples/torch_4_spectrometer.py [--device cpu]

First-order diffraction (Ludwig 1970) puts each wavelength at
sin(theta) = m * lambda / d; with 500 lines/mm (d = 2 um): 450 nm ->
23.2 mm and 650 nm -> 34.4 mm from the axis at 100 mm distance. Every
iteration of every source is one launch of the raw-record CUDA kernel
(`recording='raw'`, the default of `runSimulation`).

Runs on the first CUDA device; `--device cpu` runs the kernels' plain
PyTorch versions instead.
'''

import argparse
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from optics_design_workbench_tpu_torch.models import (Scene, PointSource,
                                                      OpticalGroup)
from optics_design_workbench_tpu_torch.geometry import surfaces as S
from optics_design_workbench_tpu_torch.geometry import transforms as T
from optics_design_workbench_tpu_torch import simulation
from optics_design_workbench_tpu_torch.jupyter_utils import RawFolder

LINES_PER_MM = 500.
GRATING_Z = 100.


def buildScene(path='example4', wavelengths=(450., 650.)):
  '''The examples/4 scene: a 500 lines/mm reflection grating (order 1,
  lines along x, a disc of radius 40 mm) at z = 100 mm, an absorbing
  detector plane of 160 x 160 mm at z = 0, and one narrow point source
  (`exp(-theta^2/1e-6)` over theta in [0, 0.01]) per wavelength, named
  `Source<nm>`; 20,000 rays per iteration, 3 intersections.'''
  scene = Scene(label='example4', path=path)
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Grating', Label='Grating',
      GratingType='Reflection',
      GratingLinesPerMillimeter=LINES_PER_MM,
      GratingDiffractionOrder=1,
      GratingLinesOrientation=(1., 0., 0.),
      surfaces=[S.plane(np.eye(4), elem=0, radius=40., orient=-1)],
      placements=[T.translation(0, 0, GRATING_Z)]))
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Absorber', Label='Detector',
      surfaces=[S.plane(np.eye(4), elem=0, halfExtents=(80., 80.))],
      placements=[T.translation(0, 0, 0)]))
  for wl in wavelengths:
    scene.addSource(PointSource(
        Label=f'Source{int(wl)}', PowerDensity='exp(-theta^2/1e-6)',
        Wavelength=wl, ThetaDomain='0, 0.01',
        ThetaResolutionNumericMode='2e3'))
  scene.addSimulationSettings(RaysPerIteration=20000, MaxIntersections=3,
                              EnableStoreSingleShotData=True)
  return scene


def expectedPosition(wavelengthNm, order=1):
  '''Distance (mm) of a spectral line from the axis by the grating
  equation at normal incidence.'''
  d = 1000. / LINES_PER_MM                  # um per line
  sinT = order * (wavelengthNm / 1000.) / d
  return GRATING_Z * np.tan(np.arcsin(sinT))


def main(device='cuda'):
  path = os.path.join(tempfile.mkdtemp(prefix='odw_example4_'), 'example4')
  scene = buildScene(path=path)
  runPath = simulation.runSimulation(scene, 'singletrue', seed=4,
                                     device=device)
  raw = RawFolder(runPath)
  print(f'run: {runPath}')
  for wl in (450, 650):
    hits = raw.loadHits('Detector', source=f'Source{wl}')
    pts = hits.points()
    pos = np.hypot(pts[:, 0], pts[:, 1]).mean()
    print(f'{wl} nm: {len(hits)} hits, spectral line at {pos:.2f} mm '
          f'(grating equation: {expectedPosition(wl):.2f} mm)')


if __name__ == '__main__':
  parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
  parser.add_argument('--device', default='cuda',
                      help="'cuda' (default) or 'cpu' for the plain versions")
  main(parser.parse_args().device)
