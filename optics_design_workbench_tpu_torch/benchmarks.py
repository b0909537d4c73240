'''
Benchmark scenes and the step factory of the main path (counterpart of the
JAX package's benchmarks.py): the headline scene mirrors
examples/2-lens-and-mirror — Gaussian point source -> plano-convex lens ->
45deg fold mirror -> absorbing detector — so every ray traces ~4 segments
with refraction, reflection and medium tracking on the path, plus the
simpler examples/1 source->detector scene, the examples/3 lens whose
radius a parameter sweep varies, the examples/4 grating spectrometer, the
reference's surface-source scene (a Lambertian-like disc emitter) and its
three stochastic-scatter scenes (a diffuser, an ideal-plus-conditioned
mixture, an astigmatic diffuser).
'''

import numpy as np

from . import resolveDevice
from .models import Scene, PointSource, OpticalGroup
from .geometry import surfaces as S
from .geometry import transforms as T
from .tracing import fused
from .ops import cuda_trace


def buildSourceDetectorScene(tmpdir=None):
  '''examples/1-source-and-detector analog.'''
  scene = Scene(label='bench1', path=tmpdir and f'{tmpdir}/bench1')
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Absorber', Label='Detector',
      surfaces=[S.plane(np.eye(4), elem=0, halfExtents=(60., 60.))],
      placements=[T.translation(0, 0, 100)]))
  scene.addSource(PointSource(
      Label='Source', PowerDensity='exp(-theta^2/0.01)',
      ThetaDomain='0, pi/4', Wavelength=532.,
      ThetaResolutionNumericMode='2e4'))
  scene.addSimulationSettings(RaysPerIteration=1e6, MaxIntersections=2)
  return scene


def buildLensMirrorScene(tmpdir=None):
  '''examples/2-lens-and-mirror analog: lens at z=50 focuses the beam, a
  45 deg fold mirror at z=150 bends it to +x, detector plane at x=100.'''
  scene = Scene(label='bench2', path=tmpdir and f'{tmpdir}/bench2')
  R, aperture, thickness = 60., 25., 6.
  sagMax = R - np.sqrt(R ** 2 - aperture ** 2)
  lens = OpticalGroup(
      OpticalType='Lens', Label='Lens', RefractiveIndex=1.5,
      surfaces=[
          S.sphere(T.translation(0, 0, R), elem=0, radius=R,
                   zRange=(-R, -R + sagMax + 1e-6), orient=+1),
          S.plane(T.translation(0, 0, thickness), elem=0, radius=aperture,
                  orient=+1),
          S.cylinder(T.translation(0, 0, thickness / 2), elem=0,
                     radius=aperture, zRange=(-thickness / 2, thickness / 2),
                     orient=+1),
      ],
      placements=[T.translation(0, 0, 50)])
  scene.addOpticalGroup(lens)
  mirror = OpticalGroup(
      OpticalType='Mirror', Label='FoldMirror', Reflectivity=0.98,
      surfaces=[S.plane(np.eye(4), elem=0, radius=40.)],
      placements=[T.compose(T.translation(0, 0, 150),
                            T.rotation((0, 1, 0), 45))])
  scene.addOpticalGroup(mirror)
  detector = OpticalGroup(
      OpticalType='Absorber', Label='Detector',
      surfaces=[S.plane(np.eye(4), elem=0, halfExtents=(60., 60.))],
      placements=[T.compose(T.translation(-100, 0, 150),
                            T.rotation((0, 1, 0), 90))])
  scene.addOpticalGroup(detector)
  scene.addSource(PointSource(
      Label='Source', PowerDensity='exp(-theta^2/0.02)',
      ThetaDomain='0, 0.35', Wavelength=532.,
      ThetaResolutionNumericMode='2e4'))
  scene.addSimulationSettings(RaysPerIteration=1e6, MaxIntersections=6)
  return scene


def buildSweepLensScene(lensRadius=60., path=None):
  '''examples/3-parameter-sweeps analog: a collimated Gaussian beam through
  a plano-convex lens (n = 1.5) of front radius `lensRadius` at z = 40 onto
  an absorbing detector at z = 160. The paraxial focus lies at f = R / (n-1)
  behind the lens, so R = 60 mm puts it on the detector.'''
  scene = Scene(label='example3', path=path)
  R, aperture, thickness = float(lensRadius), 20., 5.
  sag = R - np.sqrt(R ** 2 - aperture ** 2)
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Lens', Label='Lens', RefractiveIndex=1.5,
      surfaces=[
          S.sphere(T.translation(0, 0, R), elem=0, radius=R,
                   zRange=(-R, -R + sag + 1e-6), orient=+1),
          S.plane(T.translation(0, 0, thickness), elem=0, radius=aperture,
                  orient=+1),
          S.cylinder(T.translation(0, 0, thickness / 2), elem=0,
                     radius=aperture,
                     zRange=(-thickness / 2, thickness / 2), orient=+1)],
      placements=[T.translation(0, 0, 40)]))
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Absorber', Label='Detector',
      surfaces=[S.plane(np.eye(4), elem=0, halfExtents=(60., 60.))],
      placements=[T.translation(0, 0, 160)]))
  scene.addSource(PointSource(Label='Source',
                              PowerDensity='exp(-r^2/50)',
                              FocalLength='inf',
                              RadiusDomain='0, 15',
                              RadiusResolutionNumericMode='1e4'))
  scene.addSimulationSettings(EndAfterRays='2e4', RaysPerIteration=20000,
                              MaxIntersections=6,
                              EnableStoreSingleShotData=True)
  return scene


def buildSpectrometerScene(linesPerMm=500., wavelength=532.):
  '''The reference's throughput scene of the examples/4 spectrometer
  (tools/scene_throughput.sceneSpectrometer): a point source at the origin,
  `exp(-theta^2/1e-4)` over theta in [0, 0.05] at `wavelength` nm, onto a
  reflection grating at z = 100 mm (`linesPerMm` lines/mm, order 1, lines
  along x, a disc of radius 40 mm facing the source), which sends each
  wavelength's first order back onto an absorbing detector plane of
  160 x 160 mm at z = 0; 3 intersections. At 500 lines/mm and 532 nm the
  line lies 28.2 mm off the axis.'''
  scene = Scene(label='spectro_tp')
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Grating', Label='Grating', GratingType='Reflection',
      GratingLinesPerMillimeter=float(linesPerMm), GratingDiffractionOrder=1,
      GratingLinesOrientation=(1., 0., 0.),
      surfaces=[S.plane(np.eye(4), elem=0, radius=40., orient=-1)],
      placements=[T.translation(0, 0, 100.)]))
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Absorber', Label='Detector',
      surfaces=[S.plane(np.eye(4), elem=0, halfExtents=(80., 80.))],
      placements=[T.translation(0, 0, 0)]))
  scene.addSource(PointSource(
      Label='Src', PowerDensity='exp(-theta^2/1e-4)',
      Wavelength=float(wavelength), ThetaDomain='0, 0.05',
      ThetaResolutionNumericMode='2e3'))
  scene.addSimulationSettings(RaysPerIteration=1e6, MaxIntersections=3)
  return scene


def buildSurfaceSourceScene(tmpdir=None):
  '''The reference's surface-source throughput scene
  (tools/scene_throughput.sceneSurfaceSource): a cos(theta)^2 disc emitter
  of radius 20 mm at the origin facing +z, radiating onto an absorbing
  detector plane of 240 x 240 mm at x = -100 past a 45 deg fold mirror of
  radius 80 mm (reflectivity 0.98) at z = 120; 4 intersections. Part of
  the lobe reaches the detector without touching the mirror.'''
  from .models import SurfaceSource
  scene = Scene(label='bench_ss', path=tmpdir and f'{tmpdir}/bench_ss')
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Mirror', Label='Emitter',
      surfaces=[S.plane(np.eye(4), elem=0, radius=20.)],
      placements=[T.translation(0, 0, 0)]))
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Mirror', Label='FoldMirror', Reflectivity=0.98,
      surfaces=[S.plane(np.eye(4), elem=0, radius=80.)],
      placements=[T.compose(T.translation(0, 0, 120),
                            T.rotation((0, 1, 0), 45))]))
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Absorber', Label='Detector',
      surfaces=[S.plane(np.eye(4), elem=0, halfExtents=(120., 120.))],
      placements=[T.compose(T.translation(-100, 0, 120),
                            T.rotation((0, 1, 0), 90))]))
  scene.addSource(SurfaceSource(Label='Source', ActiveSurfaces=['Emitter'],
                                PowerDensity='cos(theta)**2'))
  scene.addSimulationSettings(RaysPerIteration=1e6, MaxIntersections=4)
  return scene


def _scatterScene(density, thetaDom, srcTheta, label, tmpdir=None,
                  diffuserZ=50.):
  '''The reference's scatter throughput scene
  (tools/scene_throughput._scatterScene): a point source of
  `exp(-theta^2/0.01)` over `srcTheta` at z = 1e-3 mm onto a mirror disc of
  radius 50 mm at z = `diffuserZ` (reflectivity 1, facing the source) whose
  ReflectedProbabilityDensity is `density` over theta in `thetaDom`, phi
  in [0, 2 pi]; the scattered light falls on an absorbing 1000 x 1000 mm
  detector at z = 0; 4 intersections (histograms over +-100 mm).'''
  scene = Scene(label=label, path=tmpdir and f'{tmpdir}/{label}')
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Mirror', Label='Diffuser', Reflectivity=1.0,
      ReflectedProbabilityDensity=density,
      PowerThetaDomain=thetaDom, PowerPhiDomain='0, 2*pi',
      surfaces=[S.plane(np.eye(4), elem=0, radius=50., orient=-1)],
      placements=[T.translation(0, 0, float(diffuserZ))]))
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Absorber', Label='Det',
      surfaces=[S.plane(np.eye(4), elem=0, halfExtents=(500., 500.))],
      placements=[T.translation(0, 0, 0)]))
  scene.addSource(PointSource(Label='Src',
                              PowerDensity='exp(-theta^2/0.01)',
                              ThetaDomain=srcTheta,
                              ThetaResolutionNumericMode='2e3',
                              placement=T.translation(0, 0, 1e-3)))
  scene.addSimulationSettings(RaysPerIteration=1e6, MaxIntersections=4)
  return scene


def buildDiffuseScatterScene(tmpdir=None, diffuserZ=50.):
  '''The reference's `sceneDiffuseScatter`: a diffuser whose lobe
  exp(-theta^2/0.02) over theta in [0, pi/3] ignores the incidence angle
  (one pwpoly in theta, one in phi).'''
  return _scatterScene('exp(-theta^2/0.02)', '0, pi/3', '0, 0.05',
                       'scat_diffuse', tmpdir, diffuserZ)


def buildConditionedDiracScene(tmpdir=None):
  '''The reference's `sceneConditionedDirac`: the ideal reflection as a
  DiracDelta event plus a lobe about the incidence angle,
  DiracDelta(theta-theta_refl) + 5*exp(-(theta-theta_in)**2/0.02) over
  theta in [0, pi/2] (a pwpoly2d in (quantile, theta_in) and one event).'''
  return _scatterScene('DiracDelta(theta-theta_refl)'
                       ' + 5*exp(-(theta-theta_in)**2/0.02)', '0, pi/2',
                       '0, 0.3', 'scat_dirac', tmpdir)


def buildCoupledScatterScene(tmpdir=None):
  '''The reference's `sceneCoupledScatter`: an astigmatic diffuser,
  exp(-(theta*cos(phi))**2/0.003 - (theta*sin(phi))**2/0.05) over theta in
  [0, pi/3], whose theta depends on phi (a low-rank expansion).'''
  return _scatterScene(
      'exp(-(theta*cos(phi))**2/0.003 - (theta*sin(phi))**2/0.05)',
      '0, pi/3', '0, 0.05', 'scat_coupled', tmpdir)


def makeSweepLensSweeper(path=None, device='cuda'):
  '''The examples/3 sweeper: a `ParameterSweeper` whose parameter R (bounds
  40..100 mm) REBUILDS the lens scene, source included, as the example's
  setter does. Returns (sweeper, holder); `holder['scene']` is the current
  scene, which is what a `sceneFactory` for `evaluateBatched` returns.'''
  from .jupyter_utils import Parameter, ParameterSweeper
  holder = dict(scene=buildSweepLensScene(path=path), R=60.)

  def setRadius(r):
    holder['R'] = float(r)
    holder['scene'] = buildSweepLensScene(float(r), path=path)
    sweeper.scene = holder['scene']   # keep the optimizer on the new scene

  sweeper = ParameterSweeper(
      lambda sc: dict(R=Parameter(getter=lambda: holder['R'],
                                  setter=setRadius, bounds=(40., 100.))),
      scene=holder['scene'], device=device)
  return sweeper, holder


def makeBenchStep(scene=None, raysPerStep=1 << 22, maxIntersections=6,
                  bins=(128, 128), histBounds=(-60., 60., -60., 60.),
                  stratified=False, histPrecision='default', device='cuda'):
  '''Compile the fused sample+trace+histogram step for a benchmark scene
  (`histBounds`: the detector-local x0, x1, y0, y1 of the histograms).
  Returns (step, histograms, meta). step: (seed, hist) -> (hist, counters)
  with `seed` a python int or a torch.Generator; `hist` is accumulated in
  place. On the card the step is ONE launch of the CUDA trace kernel with
  the in-kernel sampler (histPrecision='highest': one launch of the
  per-ray-bin kernel plus float64 binning outside, see
  `cuda_trace.makeTraceStep`); an ineligible scene raises (no batch-tracer
  fallback in this slice). device='cpu' runs the kernel's plain PyTorch
  version; the default 'cuda' raises without a card.'''
  dev = resolveDevice(device)
  if scene is None:
    scene = buildLensMirrorScene()
  sceneHost, info = scene.compile(device=None)
  src = scene.lightSources()[0]
  histSpec = fused.makeHistogramSpec(sceneHost, info,
                                     bounds=histBounds, bins=bins)
  hist = fused.initHistograms(histSpec, device=dev)
  settings = scene.activeSimulationSettings()
  step = cuda_trace.makeTraceStep(
      sceneHost, histSpec, src.deviceColumnsGenerator(device=dev),
      raysPerStep=raysPerStep, maxIntersections=maxIntersections,
      maxRayLength=settings.maxRayLength(),
      distTol=max(settings.distanceTolerance(), 1e-4), powerTol=1e-6,
      stratified=stratified, histPrecision=histPrecision,
      sampler=src.samplerSpec(), device=dev)
  return step, hist, dict(scene=scene, device=sceneHost, info=info,
                          histSpec=histSpec,
                          backend='cuda' if dev.type == 'cuda' else 'plain')
