'''
Example 6 on the PyTorch / CUDA port — gradient-based optical design (the
port's twin of examples/6_gradient_optimization.py): differentiate THROUGH
the ray tracer. Where the reference explores parameters with
derivative-free scipy searches (hundreds of full simulations), the record
tracer is plain PyTorch, so `torch.autograd.grad` of the spot-size merit
backpropagates through every bounce and Adam converges in tens of steps.

    python3 examples/torch_6_gradient_optimization.py [--cpu]

A collimated beam (4096 rays) through a plano-convex lens (n = 1.5) onto a
screen at z = 120 mm; the screen's z position is optimized (120 Adam steps
at learning rate 3) to minimize the power-weighted RMS spot radius. Runs on
the first CUDA device; `--cpu` runs it on the CPU.
'''

import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from optics_design_workbench_tpu_torch import resolveDevice
from optics_design_workbench_tpu_torch.geometry import surfaces as S
from optics_design_workbench_tpu_torch.geometry import transforms as T
from optics_design_workbench_tpu_torch.jupyter_utils import (
    makeSpotLoss, optimizeGradient)
from optics_design_workbench_tpu_torch.models import (OpticalGroup,
                                                      PointSource, Scene)

RAYS, STEPS, LEARNING_RATE = 4096, 120, 3.
# trainable: the screen's z position (table row 1, the kind-sorted detector
# plane). The focus sits near z ~ 237 (lens exit ~37 + back focal
# distance), so the screen at z = 120 must move ~ +115 mm
SPECS = [('translate', 1, (0., 0., 1.))]


def buildScene():
  scene = Scene(label='gradfocus')
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Lens', Label='Lens', RefractiveIndex=1.5,
      surfaces=[S.sphere(np.eye(4), elem=0, radius=100.,
                         zRange=(95., 100.), orient=+1),
                S.plane(T.translation(0, 0, 95.), elem=0,
                        radius=31.225, orient=-1)],
      placements=[T.translation(0, 0, -60)]))
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Absorber', Label='Screen',
      surfaces=[S.plane(np.eye(4), elem=1, halfExtents=(120., 120.))],
      placements=[T.translation(0, 0, 120)]))
  # collimated beam (FocalLength='inf'): the classic focusing problem; the
  # paraxial focus sits f = R/(n-1) = 200 mm behind the curved face
  scene.addSource(PointSource(Label='Src', PowerDensity='1',
                              ThetaDomain='0, pi/40', FocalLength='inf'))
  scene.addSimulationSettings(RaysPerIteration=64, MaxIntersections=5,
                              MaxRayLength=2000)
  return scene


def makeLoss(device='cuda', rays=RAYS, seed=1):
  '''(lossGrad, batch): the spot-size merit of the screen's z offset over
  `rays` rays of the beam drawn on `device` from `seed`.'''
  dev = resolveDevice(device)
  scene = buildScene()
  host, _info = scene.compile(device=None)
  gen = torch.Generator(device=dev)
  gen.manual_seed(seed)
  cols, _meta = scene.lightSources()[0].deviceGenerator(device=dev)(gen, rays)
  batch = dict(origins=torch.stack([cols['ox'], cols['oy'], cols['oz']], -1),
               directions=torch.stack([cols['dx'], cols['dy'], cols['dz']],
                                      -1),
               powers=cols['pw'], wavelengths=cols['wl'])
  return makeSpotLoss(host, SPECS, batch, detectorElem=1, maxIntersections=5,
                      maxRayLength=2000.), batch


def main(device='cuda'):
  '''The example; returns dict(v0, grad0, vBest, dz, history, seconds).'''
  t0 = time.perf_counter()
  lossGrad, _batch = makeLoss(device)
  v0, g0 = lossGrad(torch.zeros(1))
  print(f'start: rms spot = {float(v0):.3f} mm, grad = {g0.cpu().numpy()}')

  bestP, history = optimizeGradient(
      lossGrad, torch.zeros(1), steps=STEPS, learningRate=LEARNING_RATE,
      callback=lambda s, v, p: s % 20 or print(
          f'  step {s:3d}: rms = {v:.4f} mm  dz = {float(p[0]):+8.2f}'))

  vBest = min(v for _s, v in history)
  dz = float(bestP[0])
  print(f'done: rms spot {float(v0):.3f} -> {vBest:.4f} mm '
        f'({float(v0) / max(vBest, 1e-9):.0f}x smaller) at '
        f'dz = {dz:+.2f} mm (paraxial estimate ~ +115)')
  return dict(v0=float(v0), grad0=float(g0[0]), vBest=vBest, dz=dz,
              history=history, seconds=time.perf_counter() - t0)


if __name__ == '__main__':
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[1])
  parser.add_argument('--cpu', action='store_true',
                      help='run on the CPU instead of the first CUDA device')
  main('cpu' if parser.parse_args().cpu else 'cuda')
