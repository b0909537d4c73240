'''Shared helpers of the tests/test_torch_*.py suite: twin scene constructors
(the same scene in the JAX package and in the PyTorch port) and the runs of
the JAX reference (interpret-mode Pallas kernel, XLA fused step) that the
port's plain version is held against. Not a test module.'''

from types import SimpleNamespace

import numpy as np

N_RAYS = 1 << 11
TILE = 1 << 10
BINS = (32, 128)
MAX_RAY_LENGTH = 1000.
DIST_TOL = 1e-4
COLS = ('ox', 'oy', 'oz', 'dx', 'dy', 'dz', 'pw', 'wl')


def jaxNs():
  from optics_design_workbench_tpu import benchmarks
  from optics_design_workbench_tpu.models import (Scene, PointSource,
                                                  SurfaceSource, OpticalGroup)
  from optics_design_workbench_tpu.geometry import surfaces, transforms
  return SimpleNamespace(Scene=Scene, PointSource=PointSource,
                         SurfaceSource=SurfaceSource,
                         OpticalGroup=OpticalGroup, S=surfaces, T=transforms,
                         benchmarks=benchmarks)


def freshSympyState():
  '''Put sympy's Meijer-G lookup table back in a fresh process's state
  before a JAX compile of a scatter density: an earlier compile on this
  worker whose time guard fired inside sympy's one-time fill leaves the
  table partial, and the JAX package never repairs it (ROADMAP C.3). The
  port's own repair does it.'''
  from optics_design_workbench_tpu_torch.distributions.random_variables \
      import ensureMeijerTable
  ensureMeijerTable()


def torchNs():
  from optics_design_workbench_tpu_torch import benchmarks
  from optics_design_workbench_tpu_torch.models import (
      Scene, PointSource, SurfaceSource, OpticalGroup)
  from optics_design_workbench_tpu_torch.geometry import surfaces, transforms
  return SimpleNamespace(Scene=Scene, PointSource=PointSource,
                         SurfaceSource=SurfaceSource,
                         OpticalGroup=OpticalGroup, S=surfaces, T=transforms,
                         benchmarks=benchmarks)


def buildTirScene(ns):
  '''Right-angle glass prism (n = 1.5, critical angle 41.8 deg): the beam
  enters the z = 20 face and meets the 45 deg hypotenuse at 42.3..47.7 deg,
  so every ray is totally reflected towards the x = 10 exit face and the
  detector behind it. (A cone wide enough to straddle the critical angle
  sends rays out of the hypotenuse at grazing exit, where an ulp decides
  whether the ray re-hits the face it just left: no stable reference.)'''
  S, T = ns.S, ns.T
  scene = ns.Scene(label='tir')
  scene.addOpticalGroup(ns.OpticalGroup(
      OpticalType='Lens', Label='Prism', RefractiveIndex=1.5,
      surfaces=[
          S.plane(T.translation(0, 0, 20), elem=0, halfExtents=(10., 10.),
                  orient=-1),
          S.plane(T.compose(T.translation(0, 0, 30),
                            T.rotation((0, 1, 0), -45)), elem=0,
                  halfExtents=(14.2, 10.), orient=+1),
          S.plane(T.compose(T.translation(10, 0, 30),
                            T.rotation((0, 1, 0), 90)), elem=0,
                  halfExtents=(10., 10.), orient=+1),
      ],
      placements=[np.eye(4)]))
  scene.addOpticalGroup(ns.OpticalGroup(
      OpticalType='Absorber', Label='Detector',
      surfaces=[S.plane(np.eye(4), elem=0, halfExtents=(30., 30.))],
      placements=[T.compose(T.translation(40, 0, 30),
                            T.rotation((0, 1, 0), 90))]))
  scene.addSource(ns.PointSource(
      Label='Source', PowerDensity='exp(-theta^2/0.02)',
      ThetaDomain='0, 0.07', Wavelength=532.,
      ThetaResolutionNumericMode='5e3'))
  scene.addSimulationSettings(RaysPerIteration=1e4, MaxIntersections=6)
  return scene, (-30., 30., -30., 30.), 6


def buildAbsorbingScene(ns):
  '''Absorbing glass slab (absorption length 20 mm) -> pass-through Vacuum
  detector -> mirror: every ray crosses the slab twice (Beer-Lambert) and
  the detector twice (two ring slots), then escapes behind the source.'''
  S, T = ns.S, ns.T
  scene = ns.Scene(label='absorbing')
  scene.addOpticalGroup(ns.OpticalGroup(
      OpticalType='Lens', Label='Slab', RefractiveIndex=1.3,
      AbsorptionLength='20',
      surfaces=[
          S.plane(T.translation(0, 0, 10), elem=0, radius=30., orient=-1),
          S.plane(T.translation(0, 0, 20), elem=0, radius=30., orient=+1),
      ],
      placements=[np.eye(4)]))
  scene.addOpticalGroup(ns.OpticalGroup(
      OpticalType='Vacuum', Label='Detector', RecordHits=True,
      surfaces=[S.plane(np.eye(4), elem=0, halfExtents=(30., 30.))],
      placements=[T.translation(0, 0, 30)]))
  scene.addOpticalGroup(ns.OpticalGroup(
      OpticalType='Mirror', Label='Back', Reflectivity=0.9,
      surfaces=[S.plane(np.eye(4), elem=0, radius=60.)],
      placements=[T.translation(0, 0, 40)]))
  scene.addSource(ns.PointSource(
      Label='Source', PowerDensity='exp(-theta^2/0.05)',
      ThetaDomain='0, 0.3', Wavelength=532.,
      ThetaResolutionNumericMode='5e3'))
  scene.addSimulationSettings(RaysPerIteration=1e4, MaxIntersections=8)
  return scene, (-30., 30., -30., 30.), 8


def buildCollimatedScene(ns):
  '''Collimated Gaussian beam (FocalLength = inf: the sampler draws a radius,
  every ray runs along +z) onto a 45 deg fold mirror and a detector.'''
  S, T = ns.S, ns.T
  scene = ns.Scene(label='collimated')
  scene.addOpticalGroup(ns.OpticalGroup(
      OpticalType='Mirror', Label='Fold', Reflectivity=0.95,
      surfaces=[S.plane(np.eye(4), elem=0, radius=40.)],
      placements=[T.compose(T.translation(0, 0, 50),
                            T.rotation((0, 1, 0), 45))]))
  scene.addOpticalGroup(ns.OpticalGroup(
      OpticalType='Absorber', Label='Detector',
      surfaces=[S.plane(np.eye(4), elem=0, halfExtents=(30., 30.))],
      placements=[T.compose(T.translation(-60, 0, 50),
                            T.rotation((0, 1, 0), 90))]))
  scene.addSource(ns.PointSource(
      Label='Source', PowerDensity='exp(-r^2/50)', FocalLength='inf',
      RadiusDomain='0, 20', Wavelength=532.,
      RadiusResolutionNumericMode='5e3'))
  scene.addSimulationSettings(RaysPerIteration=1e4, MaxIntersections=4)
  return scene, (-30., 30., -30., 30.), 4


def buildStackedDetectorScene(ns):
  '''Two pass-through Vacuum detectors and a back mirror (the reference
  suite's stacked-detector scene): every ray passes each detector twice, so
  four ring slots are live.'''
  S, T = ns.S, ns.T
  scene = ns.Scene(label='stacked')
  for i, z in enumerate((40., 60.)):
    scene.addOpticalGroup(ns.OpticalGroup(
        OpticalType='Vacuum', Label=f'Det{i}', RecordHits=True,
        surfaces=[S.plane(np.eye(4), elem=0, halfExtents=(50., 50.))],
        placements=[T.translation(0, 0, z)]))
  scene.addOpticalGroup(ns.OpticalGroup(
      OpticalType='Mirror', Label='Back',
      surfaces=[S.plane(np.eye(4), elem=0, halfExtents=(50., 50.))],
      placements=[T.translation(0, 0, 90.)]))
  scene.addSource(ns.PointSource(
      Label='Src', PowerDensity='exp(-theta^2/0.02)',
      ThetaDomain='0, 0.3', Wavelength=532.,
      ThetaResolutionNumericMode='1e4'))
  scene.addSimulationSettings(RaysPerIteration=1e4, MaxIntersections=8)
  return scene, (-50., 50., -50., 50.), 8


def buildSweepLensScene(ns, lensRadius=60., path=None, detector=60.):
  '''The examples/3 scene: a collimated Gaussian beam through a
  plano-convex lens (n = 1.5) of front radius `lensRadius` onto an absorbing
  detector at z = 160; R = 60 mm puts the paraxial focus on the detector.'''
  S, T = ns.S, ns.T
  scene = ns.Scene(label='example3', path=path)
  R, aperture, thickness = float(lensRadius), 20., 5.
  sag = R - np.sqrt(R ** 2 - aperture ** 2)
  scene.addOpticalGroup(ns.OpticalGroup(
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
  scene.addOpticalGroup(ns.OpticalGroup(
      OpticalType='Absorber', Label='Detector',
      surfaces=[S.plane(np.eye(4), elem=0, halfExtents=(detector, detector))],
      placements=[T.translation(0, 0, 160)]))
  scene.addSource(ns.PointSource(
      Label='Source', PowerDensity='exp(-r^2/50)', FocalLength='inf',
      RadiusDomain='0, 15', RadiusResolutionNumericMode='1e4',
      Wavelength=532.))
  scene.addSimulationSettings(EndAfterRays='2e4', RaysPerIteration=20000,
                              MaxIntersections=6,
                              EnableStoreSingleShotData=True)
  return scene, (-40., 40., -40., 40.), 6


def buildPlacementScene(ns, xOffset=0., path=None, wavelength=532.):
  '''A Gaussian point source at (xOffset, 0, 1e-3) in front of an absorbing
  detector: the scene of a source-placement sweep (nothing varies but the
  source's placement and wavelength).'''
  S, T = ns.S, ns.T
  scene = ns.Scene(label='srcsweep', path=path)
  scene.addOpticalGroup(ns.OpticalGroup(
      OpticalType='Absorber', Label='Detector',
      surfaces=[S.plane(np.eye(4), elem=0, halfExtents=(80., 80.))],
      placements=[T.translation(0, 0, 60.)]))
  scene.addSource(ns.PointSource(
      Label='Source', PowerDensity='exp(-theta^2/0.02)',
      ThetaDomain='0, 0.4', Wavelength=wavelength,
      ThetaResolutionNumericMode='1e3',
      placement=T.translation(xOffset, 0, 1e-3)))
  scene.addSimulationSettings(RaysPerIteration=5000, MaxIntersections=2,
                              EnableStoreSingleShotData=True)
  return scene, (-80., 80., -80., 80.), 2


PILEUP_BOUNDS = (-40., 40., -40., 40.)


def buildPileUpScene(ns, offset=0.):
  '''A pile-up of detector hits (B11): a point source at (offset, offset,
  1e-3) whose narrow cone (theta <= 2 mrad) meets an absorbing detector at
  z = 60 within 0.12 mm of (offset, offset), every ray with power 1. Over
  PILEUP_BOUNDS every ray lands in the bins around that point: at 0 the four
  bins that meet there, at a bin's centre the one bin.'''
  S, T = ns.S, ns.T
  scene = ns.Scene(label='pileup')
  scene.addOpticalGroup(ns.OpticalGroup(
      OpticalType='Absorber', Label='Detector',
      surfaces=[S.plane(np.eye(4), elem=0, halfExtents=(80., 80.))],
      placements=[T.translation(0, 0, 60.)]))
  scene.addSource(ns.PointSource(
      Label='Source', PowerDensity='exp(-theta^2/1e-6)',
      ThetaDomain='0, 0.002', ThetaResolutionNumericMode='1e3',
      placement=T.translation(offset, offset, 1e-3)))
  scene.addSimulationSettings(RaysPerIteration=5000, MaxIntersections=2)
  return scene, PILEUP_BOUNDS, 2


def buildDocScene(ns, path, lensRadius=60.):
  '''The reference suite's analysis-layer scene (tests/test_jupyter_utils.py
  `buildScene`, without its StoreHit* metadata columns): Gaussian point
  source -> plano-convex lens of front radius `lensRadius` -> absorbing
  160 x 160 mm detector at z = 160.'''
  scene, _bounds, _maxI = buildSweepLensScene(ns, lensRadius, path=path,
                                              detector=80.)
  scene.label = 'doc1'
  scene.objects = [o for o in scene.objects
                   if o not in scene.lightSources()
                   + scene.simulationSettingsObjects()]
  scene.addSource(ns.PointSource(
      Label='Source', PowerDensity='exp(-theta^2/0.02)',
      ThetaDomain='0, 0.3', Wavelength=532.,
      ThetaResolutionNumericMode='1e4'))
  scene.addSimulationSettings(EndAfterRays='1e4', RaysPerIteration=5000,
                              MaxIntersections=6,
                              EnableStoreSingleShotData=True)
  return scene


def buildSourceSweepScene(ns, path, xOffset=0.):
  '''The reference suite's source-parameter sweep scene
  (tests/test_jupyter_utils.py): point source at x = xOffset, absorbing
  detector at z = 160.'''
  S, T = ns.S, ns.T
  scene = ns.Scene(label='srcsweep', path=path)
  scene.addOpticalGroup(ns.OpticalGroup(
      OpticalType='Absorber', Label='Detector',
      surfaces=[S.plane(np.eye(4), elem=0, halfExtents=(80., 80.))],
      placements=[T.translation(0, 0, 160)]))
  scene.addSource(ns.PointSource(
      Label='Source', PowerDensity='exp(-theta^2/0.02)',
      ThetaDomain='0, 0.3', Wavelength=532.,
      ThetaResolutionNumericMode='1e4'))
  scene.getObject('Source').placement[0, 3] = float(xOffset)
  scene.addSimulationSettings(RaysPerIteration=5000, MaxIntersections=4,
                              EnableStoreSingleShotData=True)
  return scene


SWEEP_RADII = (45., 60., 80.)
SWEEP_OFFSETS = (0., 15., -25.)


def sweepVariants(ns, kind):
  '''The three variants of the surface sweep ('radius') or of the
  source-placement sweep ('placement'): ([scene], bounds, maxI).'''
  if kind == 'radius':
    built = [buildSweepLensScene(ns, r) for r in SWEEP_RADII]
  else:
    built = [buildPlacementScene(ns, x) for x in SWEEP_OFFSETS]
  return [b[0] for b in built], built[0][1], built[0][2]


def spotMetric(power, counts):
  '''Second moment of a detector's count histogram about its centre of
  mass, in bins^2 (the examples/3 merit).'''
  H = counts[0]
  n = H.sum()
  if n == 0:
    return 1e9
  ys, xs = np.indices(H.shape)
  cy, cx = (H * ys).sum() / n, (H * xs).sum() / n
  return float((H * ((ys - cy) ** 2 + (xs - cx) ** 2)).sum() / n)


def centreOfMassX(power, counts):
  H = counts[0]
  n = H.sum()
  if n == 0:
    return np.nan
  _, xs = np.indices(H.shape)
  return float((H * xs).sum() / n)


def spotSize(raw):
  '''Standard deviation of the hit radii about the spot's centre on the
  'Detector' of a run folder (the examples/3 penalty).'''
  p = raw.loadHits('Detector').points()
  if len(p) < 100:
    return 1e6
  return float(np.hypot(p[:, 0] - p[:, 0].mean(),
                        p[:, 1] - p[:, 1].mean()).std())


def buildGratingScene(ns):
  '''The reference suite's grating scene (tests/test_pallas_interpret.py
  `test_grating_matches_xla_tracer_interpret`): a 600 lines/mm reflection
  grating tilted by 20 deg about x, first order, onto a spherical absorber
  of radius 300 mm around it.'''
  S, T = ns.S, ns.T
  scene = ns.Scene(label='gratinterp')
  scene.addOpticalGroup(ns.OpticalGroup(
      OpticalType='Grating', Label='Grat', GratingType='Reflection',
      GratingLinesPerMillimeter=600., GratingDiffractionOrder=1,
      GratingLinesOrientation=(1., 0., 0.),
      surfaces=[S.plane(np.eye(4), elem=0, halfExtents=(30., 30.))],
      placements=[T.compose(T.translation(0, 0, 100),
                            T.rotation((1, 0, 0), 20))]))
  scene.addOpticalGroup(ns.OpticalGroup(
      OpticalType='Absorber', Label='Det',
      surfaces=[S.sphere(T.translation(0, 0, 100), elem=0, radius=300.,
                         orient=-1)],
      placements=[np.eye(4)]))
  scene.addSource(ns.PointSource(
      Label='Src', PowerDensity='exp(-theta^2/0.005)',
      ThetaDomain='0, 0.2', Wavelength=532.,
      ThetaResolutionNumericMode='1e4'))
  scene.addSimulationSettings(RaysPerIteration=1e4, MaxIntersections=3)
  return scene, (-300., 300., -300., 300.), 3


def buildTransmissionGratingScene(ns):
  '''A 300 lines/mm transmission grating on a 5 mm glass plate (n = 1.5):
  the first order leaves the entry face inside the glass, the exit face
  refracts it like a lens face, and an absorber 95 mm behind records it.'''
  S, T = ns.S, ns.T
  scene = ns.Scene(label='transgrating')
  scene.addOpticalGroup(ns.OpticalGroup(
      OpticalType='Grating', Label='Grat', GratingType='Transmission',
      RefractiveIndex=1.5, GratingLinesPerMillimeter=300.,
      GratingDiffractionOrder=1, GratingLinesOrientation=(1., 0., 0.),
      surfaces=[
          S.plane(T.translation(0, 0, 50), elem=0, radius=30., orient=-1),
          S.plane(T.translation(0, 0, 55), elem=0, radius=30., orient=+1)],
      placements=[np.eye(4)]))
  scene.addOpticalGroup(ns.OpticalGroup(
      OpticalType='Absorber', Label='Det',
      surfaces=[S.plane(np.eye(4), elem=0, halfExtents=(60., 60.))],
      placements=[T.translation(0, 0, 150)]))
  scene.addSource(ns.PointSource(
      Label='Src', PowerDensity='exp(-theta^2/0.005)',
      ThetaDomain='0, 0.15', Wavelength=532.,
      ThetaResolutionNumericMode='1e4'))
  scene.addSimulationSettings(RaysPerIteration=1e4, MaxIntersections=4)
  return scene, (-60., 60., -60., 60.), 4


# BK7's Cauchy coefficients A and B, the wavelength in nm
CAUCHY_GLASS = '1.5046 + 4200/wavelength^2'


def buildDispersiveLensMirrorScene(ns):
  '''The lens-and-mirror scene with a dispersive lens (Cauchy glass) and the
  source at 486 nm (the F line).'''
  scene = ns.benchmarks.buildLensMirrorScene()
  scene.getObject('Lens').RefractiveIndex = CAUCHY_GLASS
  scene.lightSources()[0].Wavelength = 486.
  return scene, (-60., 60., -60., 60.), 6


def buildSequentialBallScene(ns):
  '''The reference suite's sequential ball-lens scene
  (tests/test_pallas_interpret.py
  `test_sequential_with_lens_matches_xla_interpret`): stages [Ball], [Det];
  lens entry does not advance the stage, so the exit face must stay open.'''
  S, T = ns.S, ns.T
  scene = ns.Scene(label='seqlensinterp')
  scene.addOpticalGroup(ns.OpticalGroup(
      OpticalType='Lens', Label='Ball', RefractiveIndex=1.5,
      surfaces=[S.sphere(np.eye(4), elem=0, radius=10.)],
      placements=[T.translation(0, 0, 30.)]))
  scene.addOpticalGroup(ns.OpticalGroup(
      OpticalType='Absorber', Label='Det', RecordHits=True,
      surfaces=[S.plane(np.eye(4), elem=0, halfExtents=(80., 80.))],
      placements=[T.translation(0, 0, 80.)]))
  scene.addSource(ns.PointSource(
      Label='Src', PowerDensity='exp(-theta^2/0.02)',
      ThetaDomain='0, 0.25', Wavelength=532.,
      ThetaResolutionNumericMode='1e4'))
  scene.addSimulationSettings(
      RaysPerIteration=1e4, MaxIntersections=5, SequentialMode=True,
      SequentialModeElements=[['Ball'], ['Det']])
  return scene, (-80., 80., -80., 80.), 5


def buildMaskedSourcesScene(ns):
  '''Two sources before a 45 deg fold mirror: 'Src' sees everything and is
  folded onto the side detector, 'Blind' ignores the mirror
  (IgnoredOpticalElements) and reaches the back detector through it.'''
  S, T = ns.S, ns.T
  scene = ns.Scene(label='masked')
  scene.addOpticalGroup(ns.OpticalGroup(
      OpticalType='Mirror', Label='Fold', Reflectivity=0.95,
      surfaces=[S.plane(np.eye(4), elem=0, radius=40.)],
      placements=[T.compose(T.translation(0, 0, 50),
                            T.rotation((0, 1, 0), 45))]))
  scene.addOpticalGroup(ns.OpticalGroup(
      OpticalType='Absorber', Label='Side',
      surfaces=[S.plane(np.eye(4), elem=0, halfExtents=(40., 40.))],
      placements=[T.compose(T.translation(-60, 0, 50),
                            T.rotation((0, 1, 0), 90))]))
  scene.addOpticalGroup(ns.OpticalGroup(
      OpticalType='Absorber', Label='Back',
      surfaces=[S.plane(np.eye(4), elem=0, halfExtents=(40., 40.))],
      placements=[T.translation(0, 0, 120)]))
  for label, ignored in (('Src', []), ('Blind', ['Fold'])):
    src = ns.PointSource(
        Label=label, PowerDensity='exp(-theta^2/0.02)',
        ThetaDomain='0, 0.2', Wavelength=532.,
        ThetaResolutionNumericMode='1e4')
    src.IgnoredOpticalElements = ignored
    scene.addSource(src)
  scene.addSimulationSettings(RaysPerIteration=1e4, MaxIntersections=4)
  return scene, (-40., 40., -40., 40.), 4


def buildSurfaceEmitterScene(ns):
  '''A surface source on four kinds of face under two placements — a
  plane rectangle, a plane annulus facing -z (orient -1), a sphere zone and
  a cylinder — inside an absorbing detector shell of radius 60 mm that
  catches every ray leaving the emitter (the emitter's faces are mirrors:
  some rays bounce between them first). The shell is kept near: a
  direction that differs in its last bits between two libraries' sin / cos
  moves a hit point in proportion to the path (ROADMAP C, sensitivities).'''
  S, T = ns.S, ns.T
  scene = ns.Scene(label='surfaceEmitter')
  scene.addOpticalGroup(ns.OpticalGroup(
      OpticalType='Mirror', Label='Emitter',
      surfaces=[
          S.plane(np.eye(4), elem=0, halfExtents=(10., 5.)),
          S.plane(T.translation(0, 0, -3), elem=0, radius=6.,
                  innerRadius=2., orient=-1),
          S.sphere(np.eye(4), elem=0, radius=8., zRange=(2., 8.)),
          S.cylinder(np.eye(4), elem=0, radius=4., zRange=(0., 6.))],
      placements=[T.compose(T.translation(3, -2, 10),
                            T.rotation((0, 1, 0), 15)),
                  T.compose(T.translation(-20, 5, 0),
                            T.rotation((1, 0, 0), 30))]))
  scene.addOpticalGroup(ns.OpticalGroup(
      OpticalType='Absorber', Label='Shell',
      surfaces=[S.sphere(np.eye(4), elem=0, radius=60., orient=-1)],
      placements=[T.translation(-8, 1, 5)]))
  scene.addSource(ns.SurfaceSource(Label='SS', ActiveSurfaces=['Emitter'],
                                   PowerDensity='cos(theta)**2'))
  scene.addSimulationSettings(RaysPerIteration=1e4, MaxIntersections=3)
  return scene, (-60., 60., -60., 60.), 3


def buildSurfaceBench(ns):
  '''The reference's surface-source throughput scene, its bounds and
  bounce budget (tools/scene_throughput.sceneSurfaceSource).'''
  return (ns.benchmarks.buildSurfaceSourceScene(),
          (-120., 120., -120., 120.), 4)


def buildSurfaceSensorScene(ns):
  '''A surface source whose rays are recorded where they are born: a
  plane rectangle (20 x 10 mm, centred at x = -30) and an annulus (radii 2
  and 6 mm, centred at x = +30), both in the plane z = 0 and facing +z,
  transparent (Vacuum) and not recording, under a recording Vacuum sensor
  plane 0.01 mm above them. A ray's one record holds its emission direction
  and, to within 0.01 tan(theta) mm, its emission point: what a check of the
  sampler's face fractions, theta marginal and positions reads.'''
  S, T = ns.S, ns.T
  scene = ns.Scene(label='surfaceSensor')
  scene.addOpticalGroup(ns.OpticalGroup(
      OpticalType='Vacuum', Label='Emitter', RecordHits=False,
      surfaces=[S.plane(T.translation(-30, 0, 0), elem=0,
                        halfExtents=(10., 5.)),
                S.plane(T.translation(30, 0, 0), elem=0, radius=6.,
                        innerRadius=2.)]))
  scene.addOpticalGroup(ns.OpticalGroup(
      OpticalType='Vacuum', Label='Sensor', RecordHits=True,
      surfaces=[S.plane(np.eye(4), elem=0, halfExtents=(100., 100.))],
      placements=[T.translation(0, 0, 0.01)]))
  scene.addSource(ns.SurfaceSource(Label='SS', ActiveSurfaces=['Emitter'],
                                   PowerDensity='cos(theta)**2'))
  scene.addSimulationSettings(RaysPerIteration=1e4, MaxIntersections=1)
  return scene, (-100., 100., -100., 100.), 1


# the surface-source scenes: name -> scene function
# the reference's scatter throughput scenes
# (tools/scene_throughput.sceneDiffuseScatter, sceneConditionedDirac,
# sceneCoupledScatter): (density, theta domain, source theta domain)
SCATTER_DENSITIES = {
    'diffuse': ('exp(-theta^2/0.02)', '0, pi/3', '0, 0.05'),
    'dirac': ('DiracDelta(theta-theta_refl)'
              ' + 5*exp(-(theta-theta_in)**2/0.02)', '0, pi/2', '0, 0.3'),
    'coupled': ('exp(-(theta*cos(phi))**2/0.003 - (theta*sin(phi))**2/0.05)',
                '0, pi/3', '0, 0.05'),
    # the ideal reflection plus a floor (pwpoly and one event), and a lobe
    # that tilts with the incidence angle (a pwpoly2d; analytic in sympy, so
    # its 33 rows compile in seconds where a Gaussian about theta_in takes
    # ~40 s)
    'diracFloor': ('DiracDelta(theta-theta_refl) + 0.1', '0, pi/2',
                   '0, 0.3'),
    'conditioned': ('1 + theta_in*theta', '0, pi/2', '0, 0.3'),
}
SCATTER_BOUNDS = (-100., 100., -100., 100.)


def buildScatterScene(ns, name, diffuserZ=50.):
  '''The reference's scatter throughput scene (tools/scene_throughput
  ._scatterScene) with the density `name` of SCATTER_DENSITIES: a point source at z = 1e-3 onto a
  scattering mirror disc (radius 50 mm) at z = `diffuserZ`, which throws
  the light back onto an absorbing 1000 x 1000 mm detector at z = 0; 4
  intersections.'''
  density, thetaDom, srcTheta = SCATTER_DENSITIES[name]
  S, T = ns.S, ns.T
  scene = ns.Scene(label='scat_tp')
  scene.addOpticalGroup(ns.OpticalGroup(
      OpticalType='Mirror', Label='Diffuser', Reflectivity=1.0,
      ReflectedProbabilityDensity=density,
      PowerThetaDomain=thetaDom, PowerPhiDomain='0, 2*pi',
      surfaces=[S.plane(np.eye(4), elem=0, radius=50., orient=-1)],
      placements=[T.translation(0, 0, float(diffuserZ))]))
  scene.addOpticalGroup(ns.OpticalGroup(
      OpticalType='Absorber', Label='Det',
      surfaces=[S.plane(np.eye(4), elem=0, halfExtents=(500., 500.))],
      placements=[T.translation(0, 0, 0)]))
  scene.addSource(ns.PointSource(Label='Src',
                                 PowerDensity='exp(-theta^2/0.01)',
                                 ThetaDomain=srcTheta,
                                 ThetaResolutionNumericMode='2e3',
                                 placement=T.translation(0, 0, 1e-3)))
  scene.addSimulationSettings(RaysPerIteration=1e6, MaxIntersections=4)
  return scene, SCATTER_BOUNDS, 4


def scatterStats(hist, hits, nRays, bounds=SCATTER_BOUNDS):
  '''What the scatter scenes are held to across packages and devices: the
  share of rays binned on the detector (`hits` of `nRays`), their mean
  power, and the first two moments of r^2 = x^2 + y^2 over the binned hits
  (mm^2, at the bin centres of the (1, H, W) histograms over `bounds`).'''
  host = lambda x: np.asarray(x.cpu() if hasattr(x, 'cpu') else x,
                              np.float64)
  c, p = host(hist['counts'])[0], host(hist['power'])[0]
  x0, x1, y0, y1 = bounds
  Hb, Wb = c.shape
  cx = x0 + (np.arange(Wb) + .5) * ((x1 - x0) / Wb)
  cy = y0 + (np.arange(Hb) + .5) * ((y1 - y0) / Hb)
  r2 = cx[None, :] ** 2 + cy[:, None] ** 2
  n = float(c.sum())
  return dict(share=hits / nRays, power=float(p.sum()) / n,
              r2=float((c * r2).sum()) / n,
              r4=float((c * r2 ** 2).sum()) / n, binned=n)


def scatterStatsGate(stats, ref, nRays, refRays):
  '''(whether `scatterStats` of a run of `nRays` agree with the JAX
  package's `ref` of `refRays`, the sigmas): the share and the mean of r^2
  within 3 sigma of the two samples (a share of 1 has no binomial spread:
  one ray of the smaller sample is allowed), the mean power (1 for every
  binned hit of these scenes) within 1e-6.'''
  p = ref['share']
  sigma = max(np.sqrt(p * (1 - p) / refRays + p * (1 - p) / nRays),
              1. / min(refRays, nRays))
  sigmaR2 = np.sqrt((ref['r4'] - ref['r2'] ** 2) / (p * refRays)
                    + (stats['r4'] - stats['r2'] ** 2) / stats['binned'])
  ok = (abs(stats['share'] - p) <= 3 * sigma
        and abs(stats['power'] - ref['power']) <= 1e-6
        and abs(stats['r2'] - ref['r2']) <= 3 * sigmaR2)
  return ok, dict(sigmaShare=float(sigma), sigmaR2=float(sigmaR2))


def assertScatterStatsAgree(stats, ref, nRays, refRays):
  ok, sigmas = scatterStatsGate(stats, ref, nRays, refRays)
  assert ok, (stats, ref, sigmas)


def scatterStatsOfReference(name, n, scene=None, seed=0):
  '''`scatterStats` of the JAX package's fused step (seed `seed`, `n`
  rays, 4 intersections, 128 x 128 bins over SCATTER_BOUNDS) on the
  scatter scene `name` (or the JAX `scene` given, built as that one).'''
  import jax
  from optics_design_workbench_tpu.tracing import fused
  if scene is None:
    scene, _b, _m = buildScatterScene(jaxNs(), name)
  freshSympyState()
  device, info = scene.compile()
  device['powerTol'] = 1e-6
  histSpec = fused.makeHistogramSpec(device, info, bounds=SCATTER_BOUNDS,
                                     bins=(128, 128))
  step = fused.makeFusedStep(
      device, scene.lightSources()[0].deviceGenerator(), histSpec,
      raysPerStep=n, maxIntersections=4,
      maxRayLength=scene.activeSimulationSettings().maxRayLength(),
      distTol=1e-4)
  hist, counters = step(jax.random.PRNGKey(seed),
                        fused.initHistograms(histSpec))
  return scatterStats(hist, int(counters['hits']), n)


def portScatterStats(jaxScene, n, seed=5):
  '''`scatterStats` of the port's fused step (`makeTraceStep` in seed
  mode: its own draws, the plain version on the CPU) on the JAX scene's
  arrays carried over by `convert`, its scatter tables included (so the
  port compiles no sympy of its own).'''
  from optics_design_workbench_tpu_torch import convert
  from optics_design_workbench_tpu_torch.ops import cuda_trace
  from optics_design_workbench_tpu_torch.tracing import fused
  deviceNp, histNp, spec = referenceArrays(jaxScene, SCATTER_BOUNDS,
                                           bins=(128, 128))
  scene, histSpec = convert._sceneAndSpec(deviceNp, histNp)
  step = cuda_trace.makeTraceStep(
      scene, histSpec, None, raysPerStep=n, maxIntersections=4,
      maxRayLength=jaxScene.activeSimulationSettings().maxRayLength(),
      distTol=1e-4, sampler=convert.samplerSpecFromReference(spec),
      device='cpu')
  hist, c = step(seed, fused.initHistograms(histSpec, device='cpu'))
  return scatterStats(hist, int(c['hits']), n)


def buildScatterKindsScene(ns):
  '''The scatter kinds no reference scene reaches: a collimated beam
  (radius 8 mm) through a plane-parallel glass slab (n = 1.5, faces at
  z = 20 and 26, radius 25 mm) whose RefractedProbabilityDensity scatters
  on entry (REFRACT_ENTER) and exit (REFRACT_EXIT), then onto a 45 deg fold
  mirror at z = 60 (radius 40 mm) whose RayModificationProbabilityDensity
  turns the reflected ray (MODIFY), then onto an absorbing detector at
  x = -60; 5 intersections. theta-only densities (one pwpoly each).'''
  S, T = ns.S, ns.T
  scene = ns.Scene(label='scat_kinds')
  scene.addOpticalGroup(ns.OpticalGroup(
      OpticalType='Lens', Label='Slab', RefractiveIndex=1.5,
      RefractedProbabilityDensity='exp(-theta^2/0.002)',
      PowerThetaDomain='0, 0.3', PowerPhiDomain='0, 2*pi',
      surfaces=[S.plane(np.eye(4), elem=0, radius=25., orient=-1),
                S.plane(T.translation(0, 0, 6), elem=0, radius=25.,
                        orient=+1)],
      placements=[T.translation(0, 0, 20)]))
  scene.addOpticalGroup(ns.OpticalGroup(
      OpticalType='Mirror', Label='Fold', Reflectivity=0.95,
      RayModificationProbabilityDensity='exp(-theta^2/0.001)',
      ModifyThetaDomain='0, 0.2', ModifyPhiDomain='0, 2*pi',
      surfaces=[S.plane(np.eye(4), elem=0, radius=40.)],
      placements=[T.compose(T.translation(0, 0, 60),
                            T.rotation((0, 1, 0), 45))]))
  scene.addOpticalGroup(ns.OpticalGroup(
      OpticalType='Absorber', Label='Detector',
      surfaces=[S.plane(np.eye(4), elem=0, halfExtents=(60., 60.))],
      placements=[T.compose(T.translation(-60, 0, 60),
                            T.rotation((0, 1, 0), 90))]))
  scene.addSource(ns.PointSource(Label='Source',
                                 PowerDensity='exp(-r^2/20)',
                                 FocalLength='inf', RadiusDomain='0, 8',
                                 RadiusResolutionNumericMode='1e4'))
  scene.addSimulationSettings(RaysPerIteration=1e6, MaxIntersections=5)
  return scene, (-60., 60., -60., 60.), 5


def buildManySurfacesScene(ns):
  '''More surfaces and elements than the kernels held before (ROADMAP C.2):
  a collimated beam (radius 16 mm) onto 20 small glass slabs (n = 1.5,
  radius 3 mm, 3 mm thick: front disc, back disc and barrel) on a 5 x 4
  grid at z = 20, an absorbing baffle of 11 discs (radius 1.5 mm, one
  element under 11 placements) at z = 40, and an absorbing detector at
  z = 100: 72 surfaces, 22 elements; 5 intersections.'''
  S, T = ns.S, ns.T
  scene = ns.Scene(label='many_surfaces')
  k = 0
  for x in (-12., -6., 0., 6., 12.):
    for y in (-9., -3., 3., 9.):
      scene.addOpticalGroup(ns.OpticalGroup(
          OpticalType='Lens', Label=f'Slab{k}', RefractiveIndex=1.5,
          surfaces=[S.plane(np.eye(4), elem=0, radius=3., orient=-1),
                    S.plane(T.translation(0, 0, 3), elem=0, radius=3.,
                            orient=+1),
                    S.cylinder(T.translation(0, 0, 1.5), elem=0, radius=3.,
                               zRange=(-1.5, 1.5), orient=+1)],
          placements=[T.translation(x, y, 20)]))
      k += 1
  scene.addOpticalGroup(ns.OpticalGroup(
      OpticalType='Absorber', Label='Baffle', RecordHits=False,
      surfaces=[S.plane(np.eye(4), elem=0, radius=1.5)],
      placements=[T.translation(-15. + 3. * j, 1.5 * j - 7.5, 40)
                  for j in range(11)]))
  scene.addOpticalGroup(ns.OpticalGroup(
      OpticalType='Absorber', Label='Detector',
      surfaces=[S.plane(np.eye(4), elem=0, halfExtents=(60., 60.))],
      placements=[T.translation(0, 0, 100)]))
  scene.addSource(ns.PointSource(Label='Source',
                                 PowerDensity='exp(-r^2/200)',
                                 FocalLength='inf', RadiusDomain='0, 16',
                                 RadiusResolutionNumericMode='1e4'))
  scene.addSimulationSettings(RaysPerIteration=1e6, MaxIntersections=5)
  return scene, (-60., 60., -60., 60.), 5


SURFACE_SCENES = {
    'surfaceEmitter': buildSurfaceEmitterScene,
    'surfaceBench': buildSurfaceBench,
}


def buildBench(ns, name):
  bounds = (-60., 60., -60., 60.)
  if name == 'lensMirror':
    return ns.benchmarks.buildLensMirrorScene(), bounds, 6
  return ns.benchmarks.buildSourceDetectorScene(), bounds, 2


SCENES_BY_NAME = {
    'lensMirror': lambda ns: buildBench(ns, 'lensMirror'),
    'sourceDetector': lambda ns: buildBench(ns, 'sourceDetector'),
    'tir': buildTirScene,
    'absorbing': buildAbsorbingScene,
    'collimated': buildCollimatedScene,
    'stacked': buildStackedDetectorScene,
}

# the scenes of the B4 features: name -> (scene function, traced source)
B4_SCENES = {
    'grating': (buildGratingScene, 0),
    'transGrating': (buildTransmissionGratingScene, 0),
    'cauchyLensMirror': (buildDispersiveLensMirrorScene, 0),
    'seqBall': (buildSequentialBallScene, 0),
    'maskedSource': (buildMaskedSourcesScene, 1),
}


def compileOnce(jaxScene):
  '''Make the JAX scene's `compile` run once: later calls, with either
  `devicePut`, return shallow copies of the first result (with host numpy
  leaves for devicePut=False). The JAX package keeps no cache of its
  scatter tables, and a density that mentions theta_in costs it tens of
  seconds of sympy per compile. Returns the scene.'''
  import jax
  first = jaxScene.compile
  memo = []

  def compile(devicePut=True):
    if not memo:
      freshSympyState()
      memo.append(first())
    device, info = memo[0]
    if not devicePut:
      device = jax.tree_util.tree_map(np.asarray, device)
    return dict(device), info

  jaxScene.compile = compile
  return jaxScene


def _jaxSceneFor(jaxScene, source, devicePut=True):
  '''The JAX package's compiled scene as its runner traces `source` (index
  into the light sources): with that source's `surfMask`
  (`SimulationRun.sceneFor`). Returns (scene dict, info, the source).'''
  device, info = jaxScene.compile(devicePut=devicePut)
  src = jaxScene.lightSources()[source]
  mask = info['surfaceMasks'].get(src.Label)
  if mask is not None:
    device = dict(device, surfMask=mask)
  return device, info, src


def referenceArrays(jaxScene, bounds, bins=BINS, source=0):
  '''What the JAX package hands over: the numpy scene dict of
  `compile(devicePut=False)` as its runner traces light source `source`
  (with that source's `surfMask`), the histogram spec as numpy, and the
  source's sampler spec.'''
  from optics_design_workbench_tpu.tracing import fused
  deviceNp, info, src = _jaxSceneFor(jaxScene, source, devicePut=False)
  histSpec = fused.makeHistogramSpec(deviceNp, info, bounds=bounds, bins=bins)
  histNp = dict(elemToDet=np.asarray(histSpec['elemToDet']),
                bounds=np.asarray(histSpec['bounds']),
                bins=tuple(histSpec['bins']))
  return deviceNp, histNp, src.pallasSamplerSpec()


def _result(hist, counters):
  return dict(counts=np.asarray(hist['counts']),
              power=np.asarray(hist['power']),
              counters={k: int(v) for k, v in counters.items()})


def runReferenceColumns(jaxScene, colsNp, bounds, maxIntersections,
                        hitSlots='auto', bins=BINS, withFused=True,
                        withPallas=True):
  '''Mode (c) on the JAX side: a test-local generator returns the numpy
  columns to the interpret-mode Pallas kernel and to the XLA fused step.'''
  import jax
  import jax.numpy as jnp
  from optics_design_workbench_tpu.ops import pallas_trace
  from optics_design_workbench_tpu.tracing import fused
  device, info = jaxScene.compile()
  device['powerTol'] = 1e-6
  assert pallas_trace.pallasEligible(device) or not withPallas
  histSpec = fused.makeHistogramSpec(device, info, bounds=bounds, bins=bins)
  n = len(colsNp['ox'])

  def genCols(key, N, stratified=False):
    return {k: jnp.asarray(v) for k, v in colsNp.items()}

  def genRows(key, N, stratified=False):
    c = colsNp
    return dict(
        origins=jnp.stack([c['ox'], c['oy'], c['oz']], axis=-1),
        directions=jnp.stack([c['dx'], c['dy'], c['dz']], axis=-1),
        powers=jnp.asarray(c['pw']), wavelengths=jnp.asarray(c['wl']))

  kw = dict(raysPerStep=n, maxIntersections=maxIntersections,
            maxRayLength=MAX_RAY_LENGTH, distTol=DIST_TOL)
  key = jax.random.PRNGKey(0)
  out = {}
  if withPallas:
    stepP = pallas_trace.makePallasTraceStep(
        device, histSpec, genCols, interpret=True, tile=TILE,
        hitSlots=hitSlots, **kw)
    out['pallas'] = _result(*stepP(key, fused.initHistograms(histSpec)))
  if withFused:
    stepX = fused.makeFusedStep(device, genRows, histSpec, **kw)
    out['fused'] = _result(*stepX(key, fused.initHistograms(histSpec)))
  return out


def runReferenceUniforms(jaxScene, bounds, maxIntersections, n=N_RAYS,
                         seed=77, bins=BINS, source=0, prefill=None,
                         tile=TILE, cull=False):
  '''Mode (b) on the JAX side: in-kernel sampler of light source `source`
  fed uniforms through the `uniformProvider='input'` seam, onto fresh
  histograms (or histograms whose every bin holds `prefill`); cull=True
  passes the source's `emissionBound()` (the per-bounce culls). Returns the
  kernel's result and the very uniforms the step drew, as a (draws, n)
  numpy array in ray order (`samplerDraws`).'''
  import jax
  from optics_design_workbench_tpu.ops import pallas_trace
  from optics_design_workbench_tpu.tracing import fused
  device, info, src = _jaxSceneFor(jaxScene, source)
  device['powerTol'] = 1e-6
  spec = src.pallasSamplerSpec()
  assert spec is not None
  histSpec = fused.makeHistogramSpec(device, info, bounds=bounds, bins=bins)
  step = pallas_trace.makePallasTraceStep(
      device, histSpec, src.deviceColumnsGenerator(), sampler=spec,
      uniformProvider='input', interpret=True, tile=tile, raysPerStep=n,
      maxIntersections=maxIntersections, maxRayLength=MAX_RAY_LENGTH,
      distTol=DIST_TOL, emissionBound=src.emissionBound() if cull else None)
  key = jax.random.PRNGKey(seed)
  hist = fused.initHistograms(histSpec)
  if prefill is not None:
    hist = {k: v + prefill for k, v in hist.items()}
  res = _result(*step(key, hist))
  return res, referenceUniforms(key, spec, n,
                                referenceUniformRows(device, spec,
                                                     maxIntersections))


def samplerDraws(spec):
  '''Uniforms the JAX kernel's in-kernel sampler draws per ray (its
  uniform seam's rows): 2 for a point source, 5 (face, u, v, theta, phi)
  for a surface source.'''
  return 5 if spec.get('type') == 'surface' else 2


def referenceUniformRows(device, spec, maxIntersections):
  '''Rows of the JAX kernel's uniform seam on the compiled scene `device`:
  the sampler's draws, then per bounce 2 (or 4, with discrete events) for
  the scatter lobe and as many for MODIFY (`makePallasTraceStep`).'''
  from optics_design_workbench_tpu.tracing.batch_tracer import \
      scatterConstants
  consts = scatterConstants(device) or ()
  perBounce = lambda cs: (0 if not cs else
                          2 + (2 if any(c[4] or c[5] for c in cs) else 0))
  lobe = [c for c in consts if c[1] in (0, 1, 2)]
  mods = [c for c in consts if c[1] == 3]
  return samplerDraws(spec) + (perBounce(lobe) + perBounce(mods)) \
      * maxIntersections


def referenceUniforms(key, spec, n, rows=None):
  '''The very uniforms a JAX step with `uniformProvider='input'` draws
  from `key` (`rows` of them per ray: by default the sampler's, for a scene
  without in-kernel scatter), as a (rows, n) numpy array in ray order.'''
  import jax
  k = samplerDraws(spec) if rows is None else rows
  us = jax.random.uniform(jax.random.fold_in(key, 0x0177), (k, n // 128, 128))
  return np.array(us).reshape(k, n)


def runReferenceRaw(jaxScene, bounds, maxIntersections, hitSlots='auto',
                    colsNp=None, n=N_RAYS, seed=77, bins=BINS, source=0,
                    tile=TILE, cull=False):
  '''The JAX package's raw-record step (`makePallasRawStep`, Mosaic
  interpret mode). With `colsNp` (mode (c)) a test-local generator feeds it
  the numpy ray columns; without (mode (b)) its in-kernel sampler is fed
  uniforms through `uniformProvider='input'` (no tile strata on this step).
  `source` picks the light source (and its `surfMask`); cull=True passes
  its `emissionBound()` (the per-bounce culls). Returns (records as
  numpy, counters as ints, uniforms (draws, n) or None, element labels).'''
  import jax
  import jax.numpy as jnp
  from optics_design_workbench_tpu.ops import pallas_trace
  from optics_design_workbench_tpu.tracing import fused
  device, info, src = _jaxSceneFor(jaxScene, source)
  device['powerTol'] = 1e-6
  histSpec = fused.makeHistogramSpec(device, info, bounds=bounds, bins=bins)
  kw = dict(raysPerStep=n, maxIntersections=maxIntersections,
            maxRayLength=MAX_RAY_LENGTH, distTol=DIST_TOL, hitSlots=hitSlots,
            interpret=True, tile=tile,
            emissionBound=src.emissionBound() if cull else None)
  key = jax.random.PRNGKey(seed)
  us = None
  if colsNp is not None:
    def genCols(key, N, stratified=False):
      return {k: jnp.asarray(v) for k, v in colsNp.items()}
    step = pallas_trace.makePallasRawStep(device, histSpec, genCols, **kw)
  else:
    spec = src.pallasSamplerSpec()
    assert spec is not None
    step = pallas_trace.makePallasRawStep(
        device, histSpec, src.deviceColumnsGenerator(), sampler=spec,
        uniformProvider='input', **kw)
    us = referenceUniforms(key, spec, n,
                           referenceUniformRows(device, spec,
                                                maxIntersections))
  records, counters = step(key)
  return ({k: np.asarray(v) for k, v in records.items()},
          {k: int(v) for k, v in counters.items()}, us,
          list(info['elementLabels']))


def runB4Case(name, n=N_RAYS):
  '''One scene of `B4_SCENES` through both packages in mode (b)
  (`runUniformsCase`).'''
  build, source = B4_SCENES[name]
  return runUniformsCase(build, source, n)


def runUniformsCase(build, source=0, n=N_RAYS, tile=TILE, maxI=None,
                    cull=False):
  '''The scene `build(ns)` makes through both packages in mode (b): the JAX
  Pallas kernel in interpret mode (histogram step and raw-record step, each
  fed the uniforms it draws for its `uniformProvider='input'` seam; `tile`
  rays a grid step) and the port's plain versions on those very uniforms,
  on the traced source's own scene (its `surfMask` included; a scene's
  scatter tables carried over from the JAX package), `maxI` bounces (by
  default the scene's), strata by `tile` (the reference's by-tile
  strata). cull=True gives both packages the traced source's
  `emissionBound()` (the per-bounce culls; the port's tables then carry
  its cull block). The JAX scene compiles once (`compileOnce`). Returns
  dict(hist=(ref, port), raw=((records, counters) of the reference, of the
  port), tables, uniforms (the histogram step's)).'''
  import torch
  from optics_design_workbench_tpu_torch import convert
  from optics_design_workbench_tpu_torch.ops import cuda_trace
  from optics_design_workbench_tpu_torch.tracing import fused as torchFused
  scene, bounds, sceneMaxI = build(jaxNs())
  maxI = sceneMaxI if maxI is None else maxI
  compileOnce(scene)
  deviceNp, histNp, spec = referenceArrays(scene, bounds, source=source)
  bound = scene.lightSources()[source].emissionBound() if cull else None
  tables = convert.sceneFromReference(deviceNp, histNp, samplerSpec=spec,
                                      device='cpu', emissionBound=bound,
                                      maxIntersections=maxI)
  ref, us = runReferenceUniforms(scene, bounds, maxI, n=n, source=source,
                                 tile=tile, cull=cull)
  hist = torchFused.initHistograms(histNp, device='cpu')
  c = cuda_trace.traceHistogram(
      tables, hist, n, maxI, MAX_RAY_LENGTH, DIST_TOL, hitSlots=1,
      uniforms=torch.as_tensor(us), strataTile=tile)
  port = dict(counts=hist['counts'].numpy(), power=hist['power'].numpy(),
              counters=dict(segments=int(c[0]), hits=int(c[1]),
                            hitOverflow=int(c[2])))
  hitSlots = cuda_trace.autoHitSlots(deviceNp, histNp, maxI)
  refR, refRC, usR, _labels = runReferenceRaw(scene, bounds, maxI, n=n,
                                              source=source, tile=tile,
                                              cull=cull)
  ring, cR = cuda_trace.traceRaw(tables, n, maxI, MAX_RAY_LENGTH, DIST_TOL,
                                 hitSlots=hitSlots,
                                 uniforms=torch.as_tensor(usR))
  portR = convert.recordsToNumpy(cuda_trace.recordsFromRing(ring))
  portRC = dict(segments=int(cR[0]), hits=int(cR[1]), hitOverflow=int(cR[2]))
  return dict(hist=(ref, port), raw=((refR, refRC), (portR, portRC)),
              tables=tables, maxI=maxI, uniforms=us, tile=tile)


def assertHistogramsMatch(case):
  '''Histogram mode: counters equal, counts within the 2-ray bin-edge
  budget, power per bin within 1 % (the reference bins in bf16).'''
  ref, port = case['hist']
  for k in ('segments', 'hits', 'hitOverflow'):
    assert port['counters'][k] == ref['counters'][k], k
  assert nearlyEqualCounts(port['counts'], ref['counts'])
  same = (ref['counts'] == port['counts']) & (ref['counts'] > 0)
  np.testing.assert_allclose(port['power'][same], ref['power'][same],
                             rtol=1e-2)


def assertRawRowsMatch(case, atol=1e-4, looseAtol=None, maxLoose=0):
  '''Raw mode: counters equal, rows equal ray by ray and slot by slot
  (element, isEntering exactly; point, direction, power within `atol`, or
  within `looseAtol` for at most `maxLoose` rows).'''
  (refR, refC), (portR, portC) = case['raw']
  for k in ('segments', 'hits', 'hitOverflow'):
    assert portC[k] == refC[k], k
  m = refR['recordHit']
  np.testing.assert_array_equal(portR['recordHit'], m)
  for k in ('hitElem', 'isEntering'):
    np.testing.assert_array_equal(portR[k][m], refR[k][m], err_msg=k)
  loose = np.zeros(int(m.sum()), bool)
  for k in ('point', 'direction', 'power'):
    diff = np.abs(portR[k][m] - refR[k][m]).reshape(int(m.sum()), -1)
    loose |= (diff > atol).any(axis=1)
    np.testing.assert_allclose(portR[k][m], refR[k][m], rtol=0.,
                               atol=atol if looseAtol is None else looseAtol,
                               err_msg=k)
  assert int(loose.sum()) <= maxLoose, (int(loose.sum()), maxLoose)


def hitRowset(records):
  '''The recorded hits of a records dict (numpy) as one sorted (rows, 9)
  array — element, point, direction, power, isEntering — the multiset the
  reference suite compares (tests/test_pallas_interpret.py).'''
  m = np.asarray(records['recordHit']).reshape(-1)
  cols = np.concatenate([
      np.asarray(records['hitElem']).reshape(-1, 1)[m],
      np.asarray(records['point']).reshape(-1, 3)[m],
      np.asarray(records['direction']).reshape(-1, 3)[m],
      np.asarray(records['power']).reshape(-1, 1)[m],
      np.asarray(records['isEntering']).reshape(-1, 1)[m].astype(float)],
      axis=1)
  return cols[np.lexsort(cols.T[::-1])]


def buildE2eScene(ns, path):
  '''The reference suite's end-to-end scene (tests/test_simulation_e2e.py):
  Gaussian point source -> absorbing 100 x 100 mm detector at z = 100.'''
  S, T = ns.S, ns.T
  scene = ns.Scene(label='example1', path=path)
  scene.addOpticalGroup(ns.OpticalGroup(
      OpticalType='Absorber', Label='Detector',
      surfaces=[S.plane(np.eye(4), elem=0, halfExtents=(50., 50.))],
      placements=[T.translation(0, 0, 100)]))
  scene.addSource(ns.PointSource(
      Label='Source', PowerDensity='exp(-theta^2/0.01)',
      ThetaDomain='0, pi/4', Wavelength=532.,
      ThetaResolutionNumericMode='2e4'))
  scene.addSimulationSettings(
      EndAfterRays='2e4', RaysPerIteration=5000, MaxIntersections=5,
      MaxRayLength=1000, EnableStoreSingleShotData=True)
  return scene


def nearlyEqualCounts(a, b, budget=2):
  '''Bin-for-bin equality up to `budget` rays migrating across a bin edge
  (the reference suite's own budget, tests/test_pallas_interpret.py).'''
  return np.abs(a - b).sum() <= 2 * budget


def marginalsClose(hA, hB, tolL1=0.15, minCount=200):
  '''Row / column marginals of two (H, W) count histograms agree in L1
  (independent draws, so the comparison is statistical).'''
  for axis in (0, 1):
    a, b = hA.sum(axis=axis), hB.sum(axis=axis)
    if a.sum() < minCount or b.sum() < minCount:
      return False
    if float(np.abs(a / a.sum() - b / b.sum()).sum()) > tolL1:
      return False
  return True


def jaxSceneFromPort(scene):
  '''The JAX package's twin of a port `Scene` (the port's benchmark
  scenes): every optical group with its surface dicts (copied) and
  placements, every light source and the active settings, each with the
  same properties.'''
  import copy
  ns = jaxNs()
  out = ns.Scene(label=scene.label)
  for g in scene.opticalObjects():
    out.addOpticalGroup(ns.OpticalGroup(
        surfaces=[copy.deepcopy(s) for s in g.surfaces],
        placements=[np.array(p, float) for p in g.placements],
        **g.propertiesDict()))
  for src in scene.lightSources():
    cls = (ns.SurfaceSource if type(src).__name__ == 'SurfaceSource'
           else ns.PointSource)
    out.addSource(cls(placement=np.array(src.placement, float),
                      **src.propertiesDict()))
  out.addSimulationSettings(**scene.activeSimulationSettings()
                            .propertiesDict())
  return out


def buildManyStagesScene(ns, nStages=30):
  '''Sequential mode past the 24 stages a float32 bitmask holds (ROADMAP
  C.2): a point source under nStages - 1 thin Vacuum planes P0.. (z = 10,
  13, ... mm) and an absorbing detector at z = 120 mm, stage q allowing
  plane Pq and the last stage the detector; an absorbing strip (|x| <= 5
  mm) at z = 89.5 mm, between P26 and P27, is allowed at stages 3 and 27
  only, so it stops the rays whose stage index is 27 there (at stage 3
  plane P3 lies nearer). nStages + 1 intersections reach the detector.'''
  S, T = ns.S, ns.T
  scene = ns.Scene(label='many_stages')
  nPlanes = nStages - 1
  for i in range(nPlanes):
    scene.addOpticalGroup(ns.OpticalGroup(
        OpticalType='Vacuum', Label=f'P{i}', RecordHits=False,
        surfaces=[S.plane(np.eye(4), elem=0, halfExtents=(50., 50.))],
        placements=[T.translation(0, 0, 10. + 3. * i)]))
  scene.addOpticalGroup(ns.OpticalGroup(
      OpticalType='Absorber', Label='Strip', RecordHits=False,
      surfaces=[S.plane(np.eye(4), elem=0, halfExtents=(5., 50.))],
      placements=[T.translation(0, 0, 89.5)]))
  scene.addOpticalGroup(ns.OpticalGroup(
      OpticalType='Absorber', Label='Det',
      surfaces=[S.plane(np.eye(4), elem=0, halfExtents=(100., 100.))],
      placements=[T.translation(0, 0, 120.)]))
  stages = [[f'P{i}'] + (['Strip'] if i in (3, 27) else [])
            for i in range(nPlanes)] + [['Det']]
  scene.addSource(ns.PointSource(
      Label='Src', PowerDensity='exp(-theta^2/0.05)',
      ThetaDomain='0, 0.3', Wavelength=532.,
      ThetaResolutionNumericMode='1e4'))
  scene.addSimulationSettings(RaysPerIteration=1e4,
                              MaxIntersections=nStages + 1,
                              SequentialMode=True,
                              SequentialModeElements=stages)
  return scene, (-100., 100., -100., 100.), nStages + 1


def fusedStatsOfReference(scene, bounds, maxIntersections, n, seed=0):
  '''`scatterStats` of the JAX package's fused step (seed `seed`, `n`
  rays, 128 x 128 bins over `bounds`) on the JAX `scene`.'''
  import jax
  from optics_design_workbench_tpu.tracing import fused
  freshSympyState()
  device, info = scene.compile()
  device['powerTol'] = 1e-6
  histSpec = fused.makeHistogramSpec(device, info, bounds=bounds,
                                     bins=(128, 128))
  step = fused.makeFusedStep(
      device, scene.lightSources()[0].deviceGenerator(), histSpec,
      raysPerStep=n, maxIntersections=maxIntersections,
      maxRayLength=scene.activeSimulationSettings().maxRayLength(),
      distTol=1e-4)
  hist, counters = step(jax.random.PRNGKey(seed),
                        fused.initHistograms(histSpec))
  return scatterStats(hist, int(counters['hits']), n, bounds=bounds)


def _azimuthBitmap(R, vLo, vHi, keep):
  '''An (R, R) bitmap over the azimuth chart (u in [-pi, pi), v in [vLo,
  vHi)) holding the pixels whose centre passes `keep(u, v)`, as a
  `trimBitmap`.'''
  u = (np.arange(R) + .5) / R * (2 * np.pi) - np.pi
  v = (np.arange(R) + .5) / R * (vHi - vLo) + vLo
  U, V = np.meshgrid(u, v)
  return dict(mask=keep(U, V).astype(np.uint8), u0=-np.pi, v0=vLo,
              invDu=R / (2 * np.pi), invDv=R / (vHi - vLo))


def buildChartTrimsScene(ns):
  '''One mirror per (kind, trim) of B2 / B3 that the throughput scenes do
  not reach, for the per-surface checks: bitmap trims over the azimuth
  charts of a cylinder (the reference suite's half pipe), a cone, an even
  asphere (azimuth, r) and a torus (azimuth, tube angle); hole primitives
  over the bands of a sphere, a cone, a quadric, an asphere and a torus
  (a rotated slot, a disc and a half-space), and a rectangle with holes
  (trim 4) carrying an added disc and a poly2 and a conic cut.'''
  S, T = ns.S, ns.T
  halfPlane = lambda U, V: np.abs(U) <= np.pi / 2
  holes = [(1., 0., 0., 100., 1.5, np.cos(0.4), np.sin(0.4)),
           (2., 5., 5., 4., 0., 0., 0.),
           (6., 0., 0.3, 1., 7., 0., 0.)]
  surfs = []
  cyl = S.cylinder(np.eye(4), elem=0, radius=30., zRange=(-20., 20.))
  cyl['trimBitmap'] = _azimuthBitmap(
      64, -20., 20., lambda U, V: halfPlane(U, V) & (np.abs(V) <= 15.))
  surfs.append(cyl)
  cone = S.cone(np.eye(4), elem=0, radius=10., tanAngle=0.3,
                zRange=(0., 20.))
  cone['trimBitmap'] = _azimuthBitmap(48, 0., 20., lambda U, V:
                                      np.cos(3 * U) > -0.3)
  surfs.append(cone)
  asph = S.asphere(np.eye(4), elem=0, curvature=1. / 40.,
                   coeffs=(1e-6,), rMax=15.)
  asph['trimBitmap'] = _azimuthBitmap(32, 0., 16., lambda U, V:
                                      (V < 12.) | (U > 0.))
  surfs.append(asph)
  tor = S.torus(np.eye(4), elem=0, majorRadius=30., minorRadius=8.)
  tor['trimBitmap'] = _azimuthBitmap(64, -np.pi, np.pi, lambda U, V:
                                     np.abs(V) < 2.)
  surfs.append(tor)
  for s in (S.sphere(np.eye(4), elem=0, radius=20., zRange=(-5., 20.)),
            S.cone(np.eye(4), elem=0, radius=10., tanAngle=0.3,
                   zRange=(0., 20.)),
            S.quadric(np.eye(4), elem=0, coeffs=(0.01, 0.005, 0., -0.1, 0.),
                      zRange=(0., 60.)),
            S.asphere(np.eye(4), elem=0, curvature=1. / 40.,
                      coeffs=(1e-6,), rMax=15.),
            S.torus(np.eye(4), elem=0, majorRadius=30., minorRadius=8.,
                    vRange=(-2., 2.))):
    s['trim'][0] = 3.
    s['trimPrims'] = dict(holes=holes)
    surfs.append(s)
  rect = S.plane(np.eye(4), elem=0, halfExtents=(20., 15.))
  rect['trim'][0] = 4.
  rect['trimPrims'] = dict(holes=holes[:2] + [
      (12., 25., 0., 9., 0., 0., 0.),              # an added disc
      (4., 0., -10., 0.05, 0.1, 1., 0.),           # poly2
      (25., 0.01, 0., 0.01, 0., 0., -4.)])         # inverted conic
  surfs.append(rect)
  scene = ns.Scene(label='chart_trims')
  for i, s in enumerate(surfs):
    scene.addOpticalGroup(ns.OpticalGroup(
        OpticalType='Mirror', Label=f'M{i}', surfaces=[s],
        placements=[T.translation(100. * (i % 4), 100. * (i // 4), 0.)]))
  scene.addSource(ns.PointSource(Label='Src', PowerDensity='1',
                                 ThetaDomain='0, 0.1',
                                 ThetaResolutionNumericMode='1e3'))
  scene.addSimulationSettings(RaysPerIteration=1e4, MaxIntersections=3)
  return scene, (-300., 300., -300., 300.), 3


def uvSphereTriangles(radius, nLat=8, nLon=16):
  '''The (F, 3, 3) vertices of a UV sphere about the origin: nLon
  triangles in each polar cap and two per quad in the nLat - 2 bands
  between (224 for 8 x 16), wound so that every normal points out.'''
  import math

  def ring(k):
    th = math.pi * k / nLat
    return [(radius * math.sin(th) * math.cos(2 * math.pi * j / nLon),
             radius * math.sin(th) * math.sin(2 * math.pi * j / nLon),
             radius * math.cos(th)) for j in range(nLon + 1)]

  top, bottom = (0., 0., radius), (0., 0., -radius)
  tris = []
  first, last = ring(1), ring(nLat - 1)
  for j in range(nLon):
    tris.append((top, first[j], first[j + 1]))
    tris.append((last[j], bottom, last[j + 1]))
  for k in range(1, nLat - 1):
    hi, lo = ring(k), ring(k + 1)
    for j in range(nLon):
      tris.append((hi[j], lo[j], lo[j + 1]))
      tris.append((hi[j], lo[j + 1], hi[j + 1]))
  return np.array(tris, float)


MESH_BOUNDS = (-200., 200., -200., 200.)


def buildMeshLensScene(ns):
  '''A closed mesh lens: a UV sphere of radius 10 mm (224 triangles, so
  it rides the triangle table) of n = 1.5, placed at z = 50 mm by its
  group's placement, under a point source at the origin (exp(-theta^2 /
  0.01) over theta in [0, 0.15]) in front of an absorbing 200 x 200 mm
  plane at z = 100 mm; 4 intersections. Inside the lens every triangle is
  of the ray's medium, so the other-medium tracker sees the plane only.'''
  S, T = ns.S, ns.T
  scene = ns.Scene(label='mesh_lens')
  scene.addOpticalGroup(ns.OpticalGroup(
      OpticalType='Lens', Label='Ball', RefractiveIndex=1.5,
      surfaces=[S.triangle(*t, elem=0) for t in uvSphereTriangles(10.)],
      placements=[T.translation(0, 0, 50)]))
  scene.addOpticalGroup(ns.OpticalGroup(
      OpticalType='Absorber', Label='Det',
      surfaces=[S.plane(np.eye(4), elem=0, halfExtents=(100., 100.))],
      placements=[T.translation(0, 0, 100)]))
  scene.addSource(ns.PointSource(
      Label='Src', PowerDensity='exp(-theta^2/0.01)', ThetaDomain='0, 0.15',
      Wavelength=532., ThetaResolutionNumericMode='1e3'))
  scene.addSimulationSettings(RaysPerIteration=1e4, MaxIntersections=4)
  return scene, MESH_BOUNDS, 4


# the dish triangle the tie mesh duplicates: ring 1, first quad, first
# triangle (4-8 mm off the axis, where the source is bright)
TIE_TRIANGLE = 20


def buildTieMeshScene(ns):
  '''The reference's 200-triangle dish (`benchmarks.buildMeshDishScene`)
  with one of its triangles duplicated exactly as an Absorber of its own:
  the two rows tie on every ray that meets them, and the table's order
  (the dish's row first) decides that the ray reflects.'''
  from optics_design_workbench_tpu_torch.benchmarks import dishTriangles
  S, T = ns.S, ns.T
  tris = dishTriangles(10)
  scene = ns.Scene(label='tie_mesh')
  scene.addOpticalGroup(ns.OpticalGroup(
      OpticalType='Mirror', Label='Dish',
      surfaces=[S.triangle(*t, elem=0) for t in tris],
      placements=[np.eye(4)]))
  scene.addOpticalGroup(ns.OpticalGroup(
      OpticalType='Absorber', Label='Tie',
      surfaces=[S.triangle(*tris[TIE_TRIANGLE], elem=0)],
      placements=[np.eye(4)]))
  scene.addOpticalGroup(ns.OpticalGroup(
      OpticalType='Absorber', Label='Det',
      surfaces=[S.plane(np.eye(4), elem=0, halfExtents=(200., 200.))],
      placements=[T.translation(0, 0, 0)]))
  scene.addSource(ns.PointSource(
      Label='Src', PowerDensity='exp(-theta^2/0.1)', ThetaDomain='0, 0.5',
      Wavelength=532., ThetaResolutionNumericMode='1e3',
      placement=T.translation(0, 0, 1e-3)))
  scene.addSimulationSettings(RaysPerIteration=1e4, MaxIntersections=3)
  return scene, MESH_BOUNDS, 3


def portSceneCase(make, bounds, maxIntersections):
  '''`runUniformsCase` on the port's scene `make()` and its JAX twin
  (`jaxSceneFromPort`).'''
  return runUniformsCase(lambda ns: (jaxSceneFromPort(make()), bounds,
                                     maxIntersections))


def assertBinsMatchHistogram(case):
  '''The per-ray-bin kernel's plain version on a case's uniforms, binned
  outside (`binRing`), equals the histogram kernel's plain version on them:
  counters and counts exactly.'''
  import torch
  from optics_design_workbench_tpu_torch.ops import cuda_trace
  from optics_design_workbench_tpu_torch.tracing import fused
  tables, us = case['tables'], torch.as_tensor(case['uniforms'])
  _ref, port = case['hist']
  ring, c = cuda_trace.traceBins(tables, us.shape[1], case['maxI'],
                                 MAX_RAY_LENGTH, DIST_TOL, hitSlots=1,
                                 uniforms=us, strataTile=case['tile'])
  hist = fused.initHistograms(dict(bins=tables['bins'],
                                   bounds=np.zeros((tables['nDet'], 4))),
                              device='cpu')
  cuda_trace.binRing(hist, ring)
  assert [int(c[0]), int(c[1])] == [port['counters']['segments'],
                                    port['counters']['hits']]
  np.testing.assert_array_equal(hist['counts'].numpy(), port['counts'])


def fusedCountersMatch(make, bounds, maxIntersections, seed, n=N_RAYS):
  '''The port's plain histogram version and the JAX package's XLA fused
  step on the same ray columns (the port's sampler fed numpy-seeded
  uniforms) of the port's scene `make()`: (reference counters, port
  counters, rays that moved bin).'''
  import torch
  from optics_design_workbench_tpu_torch import convert
  from optics_design_workbench_tpu_torch.ops import cuda_trace
  from optics_design_workbench_tpu_torch.tracing import fused
  scene = jaxSceneFromPort(make())
  compileOnce(scene)
  deviceNp, histNp, spec = referenceArrays(scene, bounds)
  tables = convert.sceneFromReference(deviceNp, histNp, samplerSpec=spec,
                                      device='cpu')
  us = torch.as_tensor(np.random.default_rng(seed).random(
      (cuda_trace.samplerUniforms(tables), n)).astype(np.float32))
  cols = cuda_trace.samplerColumnsPlain(tables, us)
  colsT = torch.stack(list(cols) + [torch.full_like(
      cols[0], cuda_trace.samplerWavelength(tables))])
  ref = runReferenceColumns(scene, {k: v.numpy() for k, v in
                                    zip(COLS, colsT)}, bounds,
                            maxIntersections, withPallas=False)['fused']
  hist = fused.initHistograms(histNp, device='cpu')
  c = cuda_trace.traceHistogram(tables, hist, n, maxIntersections,
                                MAX_RAY_LENGTH, DIST_TOL, hitSlots=1,
                                columns=colsT.contiguous())
  moved = float(np.abs(ref['counts'] - hist['counts'].numpy()).sum()) / 2
  return ((ref['counters']['segments'], ref['counters']['hits']),
          (int(c[0]), int(c[1])), moved)


WALL_BOUNDS = (-300., 300., -300., 300.)


def _wallDiscs(S, T, nx, ny, pitch, radius, z):
  '''The reference wall's tilted mirror discs (`benchmarks._wallScene`):
  nx x ny discs of `radius` on a `pitch` grid about height `z`.'''
  import math
  out = []
  for iy in range(ny):
    for ix in range(nx):
      cx = (ix - (nx - 1) / 2.) * pitch
      cy = (iy - (ny - 1) / 2.) * pitch
      out.append(S.plane(T.compose(
          T.translation(cx, cy, z + 2. * math.sin(ix * 0.7 + iy)),
          T.rotation((1, 0, 0), 3. * math.cos(ix + iy * 0.5)),
          T.rotation((0, 1, 0), 3. * math.sin(ix * 0.3))), elem=0,
          radius=radius, orient=-1))
  return out


def _wallSource(ns, scene, theta='0, 0.9'):
  scene.addSource(ns.PointSource(
      Label='Src', PowerDensity='exp(-theta^2/0.3)', ThetaDomain=theta,
      Wavelength=532., ThetaResolutionNumericMode='1e3',
      placement=ns.T.translation(0, 0, 1e-3)))


def _absorbingPlane(ns, label, half, z):
  return ns.OpticalGroup(
      OpticalType='Absorber', Label=label,
      surfaces=[ns.S.plane(np.eye(4), elem=0, halfExtents=(half, half))],
      placements=[ns.T.translation(0, 0, z)])


def buildSlabArrayScene(ns):
  '''The surface table's medium rule (B8): 88 glass slabs (n = 1.5, radius
  2.5 mm, 3 mm thick: front disc, back disc, barrel; 264 surfaces, one lens
  element under 88 placements) on an 11 x 8 grid of 6 mm pitch at z =
  20 mm, all rows of the surface table, under a collimated beam (radius
  30 mm), an absorbing detector at z = 100 mm; behind the back faces of the central
  slabs, 5e-5 mm away (inside the same-medium window), an absorbing patch
  (radius 8 mm with a hole of radius 1.5 mm about the axis: a hole-
  primitive trim, so a surface row). A ray inside a slab meets the slab's
  back face first, a table row of its medium: the table's winner enters the
  other-medium tracker only when the medium is not its element, so the
  patch (a row of another element) is preferred and absorbs the ray; a ray
  through the hole leaves the glass. 3 intersections.'''
  S, T = ns.S, ns.T
  scene = ns.Scene(label='slab_array')
  scene.addOpticalGroup(ns.OpticalGroup(
      OpticalType='Lens', Label='Slabs', RefractiveIndex=1.5,
      surfaces=[S.plane(np.eye(4), elem=0, radius=2.5, orient=-1),
                S.plane(T.translation(0, 0, 3), elem=0, radius=2.5,
                        orient=+1),
                S.cylinder(T.translation(0, 0, 1.5), elem=0, radius=2.5,
                           zRange=(-1.5, 1.5), orient=+1)],
      placements=[T.translation(6. * (ix - 5), 6. * iy - 21., 20)
                  for ix in range(11) for iy in range(8)]))
  patch = S.plane(np.eye(4), elem=0, radius=8.)
  patch['trim'][0] = 3.
  patch['trimPrims'] = dict(holes=[(2., 0., 3., 2.25, 0., 0., 0.)])
  scene.addOpticalGroup(ns.OpticalGroup(
      OpticalType='Absorber', Label='Patch', surfaces=[patch],
      placements=[T.translation(0, 0, 23. + 5e-5)]))
  scene.addOpticalGroup(_absorbingPlane(ns, 'Det', 60., 100.))
  scene.addSource(ns.PointSource(Label='Src', PowerDensity='exp(-r^2/400)',
                                 FocalLength='inf', RadiusDomain='0, 30',
                                 RadiusResolutionNumericMode='1e4'))
  scene.addSimulationSettings(RaysPerIteration=1e4, MaxIntersections=3)
  return scene, (-60., 60., -60., 60.), 3


def buildConeQuadricWallScene(ns):
  '''Every kind of the surface table in its runs (B8): a wall of 210
  tilted mirror discs (radius 3.2 mm, 8 mm pitch, 21 x 10, z about 80 mm)
  above 23 mirror cones (radius 1.2 + 0.5 z over z in [0, 1.5] mm) at z =
  8 mm and 23 half-ellipsoid mirror caps (semi-axes 1.5, 1.8, 1.2 mm) at
  z = 11 mm on a 5.5 mm grid close over the source (20 of each a chunked
  run, 3 with trim flag 1 a plain run), a cylinder mirror (radius 45 mm, z
  in [40, 50] mm) round the beam, the wall's spherical cap and the
  absorbing detector at z = 0 (plain runs), lit from just above the
  detector by exp(-theta^2/0.3) over theta in [0, 0.9]; 3 intersections.
  A cone's or a quadric's discriminant cancels as (distance / size)^2 (the
  ray's distance from the surface over its size), so the JAX package's
  contractions of a * b + c move its roots by up to ~1e-4 mm here, where
  the port's formulas equal the reference's operation for operation.'''
  S, T = ns.S, ns.T
  scene = ns.Scene(label='cone_quadric_wall')
  surfs = _wallDiscs(S, T, 21, 10, 8., 3.2, 80.)
  q = np.array([1. / 2.25, 1. / 3.24, 1. / 1.44, 0., -1.])
  q = tuple(q / q[:3].max())
  for i in range(23):
    x, y = 5.5 * (i % 6) - 13.75, 5.5 * (i // 6) - 8.25
    cone = S.cone(T.translation(x, y, 8.), elem=0, radius=1.2,
                  tanAngle=0.5, zRange=(0., 1.5))
    quad = S.quadric(T.translation(x + 2.75, y + 2.75, 11.), elem=0,
                     coeffs=q, zRange=(-1.2, 0.))
    if i >= 20:
      cone['trim'][0] = quad['trim'][0] = 1.
    surfs += [cone, quad]
  surfs.append(S.cylinder(T.translation(0, 0, 45.), elem=0, radius=45.,
                          zRange=(-5., 5.), orient=-1))
  surfs.append(S.sphere(T.translation(0, 0, 140.), elem=0, radius=60.,
                        zRange=(-60., -40.), orient=+1))
  scene.addOpticalGroup(ns.OpticalGroup(
      OpticalType='Mirror', Label='Wall', surfaces=surfs,
      placements=[np.eye(4)]))
  scene.addOpticalGroup(_absorbingPlane(ns, 'Det', 300., 0.))
  _wallSource(ns, scene)
  scene.addSimulationSettings(RaysPerIteration=1e4, MaxIntersections=3)
  return scene, WALL_BOUNDS, 3


# the wall disc the tie scene duplicates (ix 12, iy 11: lit directly, clear
# of the patch's shadow)
TIE_DISC = 11 * 16 + 12


def buildTieTableScene(ns):
  '''Ties on the surface table (B8): a 16 x 16 wall of the reference
  wall's tilted mirror discs with disc TIE_DISC duplicated exactly as an
  Absorber of its own (two equal table rows: the first in the table's
  order, the wall's, wins), and an untilted mirror disc of radius 6 mm at z = 40 mm (a table
  row) under an absorbing plane at the same place trimmed by a 64 x 64
  bitmap (a disc of radius 5 mm with a 1 mm slot: a surface row), so the
  two tie on every ray that meets the bitmap's set pixels and the surface
  row, which comes first, wins; the absorbing detector at z = 0 and the
  wall's source; 2 intersections.'''
  S, T = ns.S, ns.T
  scene = ns.Scene(label='tie_table')
  discs = _wallDiscs(S, T, 16, 16, 8., 5.6, 80.)
  scene.addOpticalGroup(ns.OpticalGroup(
      OpticalType='Mirror', Label='Wall', surfaces=discs,
      placements=[np.eye(4)]))
  import copy
  scene.addOpticalGroup(ns.OpticalGroup(
      OpticalType='Absorber', Label='Dup',
      surfaces=[copy.deepcopy(discs[TIE_DISC])], placements=[np.eye(4)]))
  scene.addOpticalGroup(ns.OpticalGroup(
      OpticalType='Mirror', Label='Patch',
      surfaces=[S.plane(np.eye(4), elem=0, radius=6.)],
      placements=[T.translation(0, 0, 40.)]))
  slot = S.plane(np.eye(4), elem=0, halfExtents=(6., 6.))
  ax = (np.arange(64) + .5) / 64 * 12. - 6.
  X, Y = np.meshgrid(ax, ax)
  slot['trimBitmap'] = dict(
      mask=((X ** 2 + Y ** 2 <= 25.) & (np.abs(X) >= 0.5)).astype(np.uint8),
      u0=-6., v0=-6., invDu=64 / 12., invDv=64 / 12.)
  scene.addOpticalGroup(ns.OpticalGroup(
      OpticalType='Absorber', Label='Slot', surfaces=[slot],
      placements=[T.translation(0, 0, 40.)]))
  scene.addOpticalGroup(_absorbingPlane(ns, 'Det', 300., 0.))
  _wallSource(ns, scene)
  scene.addSimulationSettings(RaysPerIteration=1e4, MaxIntersections=2)
  return scene, WALL_BOUNDS, 2


def buildBothTablesScene(ns):
  '''Both tables in device memory at once (B7 and B8): the reference's
  200-triangle dish (the triangle table) over 256 absorbing discs of
  radius 1 mm on a 16 x 16 grid of 4 mm pitch at z = 30 mm and the
  absorbing detector at z = 0 (the surface table: 257 analytic surfaces),
  lit from just above the detector as the dish scene is; 2 intersections.'''
  from optics_design_workbench_tpu_torch.benchmarks import dishTriangles
  S, T = ns.S, ns.T
  scene = ns.Scene(label='both_tables')
  scene.addOpticalGroup(ns.OpticalGroup(
      OpticalType='Mirror', Label='Dish',
      surfaces=[S.triangle(*t, elem=0) for t in dishTriangles(10)],
      placements=[np.eye(4)]))
  scene.addOpticalGroup(ns.OpticalGroup(
      OpticalType='Absorber', Label='Dots',
      surfaces=[S.plane(T.translation(4. * (i % 16) - 30., 4. * (i // 16)
                                      - 30., 30.), elem=0, radius=1.)
                for i in range(256)],
      placements=[np.eye(4)]))
  scene.addOpticalGroup(_absorbingPlane(ns, 'Det', 200., 0.))
  scene.addSource(ns.PointSource(
      Label='Src', PowerDensity='exp(-theta^2/0.1)', ThetaDomain='0, 0.5',
      Wavelength=532., ThetaResolutionNumericMode='1e3',
      placement=T.translation(0, 0, 1e-3)))
  scene.addSimulationSettings(RaysPerIteration=1e4, MaxIntersections=2)
  return scene, MESH_BOUNDS, 2


def buildWallScene(ns):
  '''The reference's 522-surface wall (`benchmarks.buildSurfWallScene`) in
  `ns`'s package.'''
  from optics_design_workbench_tpu_torch import benchmarks
  scene = benchmarks.buildSurfWallScene()
  return (scene if ns.Scene.__module__.startswith(
      'optics_design_workbench_tpu_torch') else jaxSceneFromPort(scene),
          WALL_BOUNDS, 3)


# the check scenes of the surface table: name -> scene function
SURFACE_TABLE_SCENES = {
    'wall': buildWallScene,
    'slabArray': buildSlabArrayScene,
    'coneQuadric': buildConeQuadricWallScene,
    'tie': buildTieTableScene,
    'bothTables': buildBothTablesScene,
}


# ---------------------------------------------------- per-bounce culls (B12)

def _cullSource(ns, scene, density, theta):
  scene.addSource(ns.PointSource(
      Label='Src', PowerDensity=density, ThetaDomain=theta, Wavelength=532.,
      ThetaResolutionNumericMode='1e3',
      placement=ns.T.translation(0, 0, 1e-3)))


def buildFirstBounceCullScene(ns):
  '''The JAX suite's first-bounce cull scene: a narrow source aimed at one
  of two mirrors (the other 500 mm to the side), over an absorbing
  detector; the side mirror leaves bounce 0's set.'''
  S, T = ns.S, ns.T
  scene = ns.Scene(label='fbcull')
  scene.addOpticalGroup(ns.OpticalGroup(
      OpticalType='Mirror', Label='Target',
      surfaces=[S.plane(np.eye(4), elem=0, radius=30., orient=-1)],
      placements=[T.translation(0, 0, 100.)]))
  scene.addOpticalGroup(ns.OpticalGroup(
      OpticalType='Mirror', Label='Decoy',
      surfaces=[S.plane(np.eye(4), elem=0, radius=30.)],
      placements=[T.translation(500., 0, 100.)]))
  scene.addOpticalGroup(ns.OpticalGroup(
      OpticalType='Absorber', Label='Det',
      surfaces=[S.plane(np.eye(4), elem=0, halfExtents=(200., 200.))],
      placements=[T.translation(0, 0, 0)]))
  _cullSource(ns, scene, 'exp(-theta^2/0.01)', '0, 0.25')
  scene.addSimulationSettings(RaysPerIteration=1e4, MaxIntersections=3)
  return scene, (-200., 200., -200., 200.), 3


def buildFoldCullScene(ns):
  '''The JAX suite's per-bounce cull scene: a 45 deg fold mirror sends the
  beam to a side detector; two decoy mirrors (behind the source, below the
  fold) stay out of every bounce's set.'''
  S, T = ns.S, ns.T
  scene = ns.Scene(label='bcull')
  scene.addOpticalGroup(ns.OpticalGroup(
      OpticalType='Mirror', Label='Fold',
      surfaces=[S.plane(np.eye(4), elem=0, radius=60.)],
      placements=[T.placement((0, 0, 100.), axis=(1, 0, 0), angleDeg=45.)]))
  scene.addOpticalGroup(ns.OpticalGroup(
      OpticalType='Absorber', Label='Det', RecordHits=True,
      surfaces=[S.plane(np.eye(4), elem=0, halfExtents=(50., 50.))],
      placements=[T.placement((0, 200., 100.), axis=(1, 0, 0),
                              angleDeg=-90.)]))
  scene.addOpticalGroup(ns.OpticalGroup(
      OpticalType='Mirror', Label='DecoyBehind',
      surfaces=[S.plane(np.eye(4), elem=0, radius=40.)],
      placements=[T.translation(0, 0, -300.)]))
  scene.addOpticalGroup(ns.OpticalGroup(
      OpticalType='Mirror', Label='DecoyBelow',
      surfaces=[S.plane(np.eye(4), elem=0, radius=40.)],
      placements=[T.placement((0, -200., 100.), axis=(1, 0, 0),
                              angleDeg=-90.)]))
  _cullSource(ns, scene, 'exp(-theta^2/0.01)', '0, 0.2')
  scene.addSimulationSettings(RaysPerIteration=1e4, MaxIntersections=4)
  return scene, (-300., 300., -300., 300.), 4


def buildReflectBackScene(ns):
  '''The JAX suite's scene against an optimistic cull: a concave spherical
  cap (R = 40 mm about z = 140) reflects the beam back past the source onto
  a detector behind it, which a forward-only cull would drop.'''
  S, T = ns.S, ns.T
  scene = ns.Scene(label='bcullback')
  scene.addOpticalGroup(ns.OpticalGroup(
      OpticalType='Mirror', Label='Concave',
      surfaces=[S.sphere(np.eye(4), elem=0, radius=40.,
                         zRange=(-40., -36.))],
      placements=[T.translation(0, 0, 140.)]))
  scene.addOpticalGroup(ns.OpticalGroup(
      OpticalType='Absorber', Label='DetBehind', RecordHits=True,
      surfaces=[S.plane(np.eye(4), elem=0, halfExtents=(200., 200.))],
      placements=[T.translation(0, 0, -50.)]))
  _cullSource(ns, scene, 'exp(-theta^2/0.01)', '0, 0.15')
  scene.addSimulationSettings(RaysPerIteration=1e4, MaxIntersections=3)
  return scene, (-200., 200., -200., 200.), 3


def buildBallLensCullScene(ns):
  '''The JAX suite's refraction cull scene: a full ball lens (n = 1.5,
  R = 10 mm; entry, exit, possible TIR) before a detector, and a decoy
  mirror far outside every refraction cone.'''
  S, T = ns.S, ns.T
  scene = ns.Scene(label='bculllens')
  scene.addOpticalGroup(ns.OpticalGroup(
      OpticalType='Lens', Label='Ball', RefractiveIndex=1.5,
      surfaces=[S.sphere(np.eye(4), elem=0, radius=10.)],
      placements=[T.translation(0, 0, 30.)]))
  scene.addOpticalGroup(ns.OpticalGroup(
      OpticalType='Absorber', Label='Det', RecordHits=True,
      surfaces=[S.plane(np.eye(4), elem=0, halfExtents=(80., 80.))],
      placements=[T.translation(0, 0, 80.)]))
  scene.addOpticalGroup(ns.OpticalGroup(
      OpticalType='Mirror', Label='Decoy',
      surfaces=[S.plane(np.eye(4), elem=0, radius=30.)],
      placements=[T.translation(0, 0, -400.)]))
  _cullSource(ns, scene, 'exp(-theta^2/0.02)', '0, 0.3')
  scene.addSimulationSettings(RaysPerIteration=1e4, MaxIntersections=6)
  return scene, (-100., 100., -100., 100.), 6


def _isPort(ns):
  return ns.Scene.__module__.startswith('optics_design_workbench_tpu_torch')


def buildCullDecoyScene(ns):
  '''The port's `benchmarks.buildCullDecoyScene` (a fold beside 32 aspheric
  and toroidal decoys no beam reaches), or its JAX twin.'''
  scene = torchNs().benchmarks.buildCullDecoyScene()
  return (scene if _isPort(ns) else jaxSceneFromPort(scene),
          (-300., 300., -300., 300.), 4)


def buildMeshCullScene(ns):
  '''The 200-triangle dish mirror (its triangles in the triangle table,
  which the propagation cannot see) with a decoy mirror behind the source:
  bounce 0 culls the decoy, every later bounce sweeps in full.'''
  port = torchNs()
  scene = port.benchmarks.buildMeshDishScene()
  scene.addOpticalGroup(port.OpticalGroup(
      OpticalType='Mirror', Label='Decoy',
      surfaces=[port.S.plane(np.eye(4), elem=0, radius=30.)],
      placements=[port.T.translation(0, 0, -300.)]))
  return (scene if _isPort(ns) else jaxSceneFromPort(scene),
          (-200., 200., -200., 200.), 3)


# the scenes built to punish a cull that is too tight (the JAX suite's
# tests/test_pallas_interpret.py) and the decoy scene
CULL_SCENES = {
    'firstBounce': buildFirstBounceCullScene,
    'fold': buildFoldCullScene,
    'reflectBack': buildReflectBackScene,
    'ballLens': buildBallLensCullScene,
    'decoy': buildCullDecoyScene,
}


def _recordSceneArrays(build, source):
  made = build()
  scene = made[0] if isinstance(made, tuple) else made
  maxI = made[2] if isinstance(made, tuple) and made[2] else 6
  deviceNp, info = scene.compile(devicePut=False)
  src = scene.lightSources()[source]
  mask = info['surfaceMasks'].get(src.Label)
  if mask is not None:
    deviceNp = dict(deviceNp, surfMask=np.asarray(mask))
  deviceNp['powerTol'] = 1e-6
  return deviceNp, src, maxI


def recordTraceBoth(build, source=0, n=512, seed=3, maxI=None):
  '''(JAX records, port records, the compiled scene) as numpy: the record
  tracers of both packages (`tracer.trace`) on the same `n` rays of the
  JAX point source (`makeRaysHost` at (theta or radius, phi) drawn
  uniformly over its domains by numpy from `seed`; the source's
  distribution needs a compile of seconds and does not matter here),
  through the same compiled scene of `build()` (a JAX scene, or (scene,
  bounds, maxIntersections)) as its runner traces light source `source`.'''
  import jax
  import jax.numpy as jnp
  from optics_design_workbench_tpu.tracing import tracer as JT
  from optics_design_workbench_tpu_torch import convert
  from optics_design_workbench_tpu_torch.tracing import tracer as TT
  deviceNp, src, sceneMaxI = _recordSceneArrays(build, source)
  maxI = maxI or sceneMaxI
  rng = np.random.default_rng(seed)
  first = (src.parsedThetaDomain() if np.isfinite(src.focalLength())
           else src.parsedRadiusDomain())
  b = src.makeRaysHost(rng.uniform(*first, n),
                       rng.uniform(*src.parsedPhiDomain(), n))
  cols = [np.array(b[k], np.float32)
          for k in ('origins', 'directions', 'powers', 'wavelengths')]
  devJ = jax.tree_util.tree_map(jnp.asarray, {
      k: v for k, v in deviceNp.items() if k != 'powerTol'})
  devJ['powerTol'] = 1e-6
  _, rj = JT.trace(devJ, *map(jnp.asarray, cols), maxIntersections=maxI,
                   maxRayLength=MAX_RAY_LENGTH, distTol=DIST_TOL)
  import torch
  _, rt = TT.trace(convert.recordSceneFromReference(deviceNp, 'cpu'),
                   *map(torch.as_tensor, cols), maxI, MAX_RAY_LENGTH,
                   DIST_TOL)
  return ({k: np.asarray(v) for k, v in rj.items()},
          {k: v.numpy() for k, v in rt.items()}, deviceNp)
