'''
Benchmark scenes and the step factory of the main path (counterpart of the
JAX package's benchmarks.py): the headline scene mirrors
examples/2-lens-and-mirror — Gaussian point source -> plano-convex lens ->
45deg fold mirror -> absorbing detector — so every ray traces ~4 segments
with refraction, reflection and medium tracking on the path, plus the
simpler examples/1 source->detector scene, the examples/3 lens whose
radius a parameter sweep varies, the examples/4 grating spectrometer, the
reference's surface-source scene (a Lambertian-like disc emitter), its
three stochastic-scatter scenes (a diffuser, an ideal-plus-conditioned
mixture, an astigmatic diffuser), its torus-mirror and mesh-fold throughput
scenes, the two slotted mirrors of its trim tests, a scene of the other
surface kinds and an emitter whose faces are of those kinds, its dish
mirrors of 200 to 12800 triangles (the triangle-table sweep), its walls
of 522 and 5,071 analytic surfaces (the surface-table sweep) and a fold
beside 32 mirrors no ray can reach (the per-bounce culls).
'''

import math

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


def buildTorusMirrorScene(tmpdir=None, height=80.):
  '''The reference's `sceneTorusMirror`: a toroidal mirror (R = 30 mm,
  tube r = 8 mm, full tube) at z = `height` (80 mm) above a point source
  of exp(-(theta-0.38)^2/0.01) over theta in [0.15, 0.55], which lights a
  band of the ring; the reflected light falls on an absorbing 400 x 400 mm
  detector plane at z = 0; 3 intersections (histograms over +-200 mm).'''
  scene = Scene(label='torus_tp', path=tmpdir and f'{tmpdir}/torus_tp')
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Mirror', Label='Ring',
      surfaces=[S.torus(np.eye(4), elem=0, majorRadius=30., minorRadius=8.)],
      placements=[T.translation(0, 0, float(height))]))
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Absorber', Label='Det',
      surfaces=[S.plane(np.eye(4), elem=0, halfExtents=(200., 200.))],
      placements=[T.translation(0, 0, 0)]))
  scene.addSource(PointSource(
      Label='Src', PowerDensity='exp(-(theta-0.38)^2/0.01)',
      ThetaDomain='0.15, 0.55', Wavelength=532.,
      ThetaResolutionNumericMode='1e3'))
  scene.addSimulationSettings(RaysPerIteration=1e6, MaxIntersections=3)
  return scene


def buildMeshFoldScene(tmpdir=None):
  '''The reference's `sceneMeshFold`: a 50 x 50 mm fold mirror made of two
  triangles tilted 45 deg about x at z = 60 mm, a point source of
  exp(-theta^2/0.05) over theta in [0, 0.3], and an absorbing sphere of
  radius 300 mm about the source as the detector; 3 intersections
  (histograms over +-300 mm).'''
  c, s = np.cos(np.radians(45.)), np.sin(np.radians(45.))

  def pt(x, y):
    return (x, y * c, 60. + y * s)

  scene = Scene(label='mesh_tp', path=tmpdir and f'{tmpdir}/mesh_tp')
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Mirror', Label='FoldTri',
      surfaces=[S.triangle(pt(-25, -25), pt(25, -25), pt(25, 25), elem=0),
                S.triangle(pt(-25, -25), pt(25, 25), pt(-25, 25), elem=0)],
      placements=[np.eye(4)]))
  scene.addOpticalGroup(_sphereDetector())
  scene.addSource(PointSource(
      Label='Src', PowerDensity='exp(-theta^2/0.05)',
      ThetaDomain='0, 0.3', Wavelength=532.,
      ThetaResolutionNumericMode='1e4'))
  scene.addSimulationSettings(RaysPerIteration=1e6, MaxIntersections=3)
  return scene


def dishTriangles(nQ, R0=40., z0=60.):
  '''The (nQ * nQ * 2, 3, 3) vertices of the reference's dish mirror: a
  paraboloid z = z0 + 0.004 r^2 of radius R0 cut into nQ rings of nQ quads,
  two triangles each, in the reference's order (the innermost ring's
  second triangles have zero area).'''
  def pt(ir, ip):
    r = R0 * ir / nQ
    ph = 2 * math.pi * ip / nQ
    return (r * math.cos(ph), r * math.sin(ph), z0 + 0.004 * r * r)

  tris = []
  for ir in range(nQ):
    for ip in range(nQ):
      a, b = pt(ir, ip), pt(ir + 1, ip)
      c, d = pt(ir + 1, ip + 1), pt(ir, ip + 1)
      tris += [(a, b, c), (a, c, d)]
  return np.array(tris, float)


def _dishScene(label, tris, sourceKw, tmpdir):
  scene = Scene(label=label, path=tmpdir and f'{tmpdir}/{label}')
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Mirror', Label='Dish',
      surfaces=[S.triangle(*t, elem=0) for t in tris],
      placements=[np.eye(4)]))
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Absorber', Label='Det',
      surfaces=[S.plane(np.eye(4), elem=0, halfExtents=(200., 200.))],
      placements=[T.translation(0, 0, 0)]))
  scene.addSource(PointSource(Label='Src', Wavelength=532.,
                              ThetaResolutionNumericMode='1e3', **sourceKw))
  scene.addSimulationSettings(RaysPerIteration=1e6, MaxIntersections=3)
  return scene


def buildMeshDishScene(nQ=10, tmpdir=None, detectorZ=0.):
  '''The reference's dish scenes (`_dishScene`): a paraboloid mirror of
  nQ * nQ * 2 triangles (nQ = 10 / 30 / 50 / 80: 200 / 1800 / 5000 / 12800,
  `dishTriangles`) over an absorbing 400 x 400 mm detector at z =
  `detectorZ` (0), lit from 1e-3 mm above it by exp(-theta^2/0.1) over
  theta in [0, 0.5]; 3 intersections (histograms over +-200 mm).'''
  scene = _dishScene(f'dish{nQ}_tp', dishTriangles(nQ), dict(
      PowerDensity='exp(-theta^2/0.1)', ThetaDomain='0, 0.5',
      placement=T.translation(0, 0, 1e-3)), tmpdir)
  if detectorZ:
    scene.getObject('Det').placements = [T.translation(0, 0, detectorZ)]
  return scene


def buildMeshDishCollimatedScene(tmpdir=None):
  '''The reference's `sceneMeshDishCollimated`: the 200-triangle dish lit
  by a narrow beam (exp(-theta^2/2e-4) over theta in [0, 0.03]) tilted 24
  deg about y towards its rim, so the chunk cull skips most of the mesh.'''
  aim = T.rotation((0., 1., 0.), 24.) @ T.translation(0, 0, 1e-3)
  return _dishScene('dishcoh_tp', dishTriangles(10), dict(
      PowerDensity='exp(-theta^2/2e-4)', ThetaDomain='0, 0.03',
      placement=aim), tmpdir)


def _wallScene(label, nx, ny, pitch, radius, tiltY, cap, tmpdir,
               detectorZ):
  '''The reference's mirror walls: nx x ny small mirror discs of `radius`
  on a `pitch` grid about z = 80 mm (each lifted by 2 sin(0.7 ix + iy) mm,
  tilted by 3 cos(ix + iy / 2) deg about x and, with `tiltY`, by
  3 sin(0.3 ix) deg about y), with `cap` a spherical mirror zone of radius
  60 mm about (0, 0, 140) over z in [-60, -40], over an absorbing
  600 x 600 mm detector at z = `detectorZ`, lit from 1e-3 mm above it by
  exp(-theta^2/0.3) over theta in [0, 0.9]; 3 intersections (histograms over
  +-300 mm).'''
  scene = Scene(label=label, path=tmpdir and f'{tmpdir}/{label}')
  mirrors = []
  for iy in range(ny):
    for ix in range(nx):
      cx = (ix - (nx - 1) / 2.) * pitch
      cy = (iy - (ny - 1) / 2.) * pitch
      parts = [T.translation(cx, cy, 80. + 2. * math.sin(ix * 0.7 + iy)),
               T.rotation((1, 0, 0), 3. * math.cos(ix + iy * 0.5))]
      if tiltY:
        parts.append(T.rotation((0, 1, 0), 3. * math.sin(ix * 0.3)))
      mirrors.append(S.plane(T.compose(*parts), elem=0, radius=radius,
                             orient=-1))
  if cap:
    mirrors.append(S.sphere(T.translation(0, 0, 140.), elem=0, radius=60.,
                            zRange=(-60., -40.), orient=+1))
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Mirror', Label='Wall', surfaces=mirrors,
      placements=[np.eye(4)]))
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Absorber', Label='Det',
      surfaces=[S.plane(np.eye(4), elem=0, halfExtents=(300., 300.))],
      placements=[T.translation(0, 0, detectorZ)]))
  scene.addSource(PointSource(
      Label='Src', PowerDensity='exp(-theta^2/0.3)', ThetaDomain='0, 0.9',
      Wavelength=532., ThetaResolutionNumericMode='1e3',
      placement=T.translation(0, 0, 1e-3)))
  scene.addSimulationSettings(RaysPerIteration=1e6, MaxIntersections=3)
  return scene


def buildSurfWallScene(tmpdir=None, detectorZ=0.):
  '''The reference's `sceneSurfWall`: 522 analytic surfaces, a 26 x 20
  wall of tilted mirror discs (radius 5.6 mm, 8 mm pitch), a spherical
  mirror cap and the detector (`_wallScene`): past the 256 analytic
  surfaces of the surface rows, so every surface rides the surface table
  (a chunked run of 520 discs, a plain run of the cap, one of the
  detector).'''
  return _wallScene('surfwall_tp', 26, 20, 8., 0.7 * 8., True, True, tmpdir,
                    detectorZ)


def buildSurfWall5kScene(tmpdir=None, detectorZ=0.):
  '''The reference's `sceneFallbackSurf5k`: 5,071 analytic surfaces, a
  78 x 65 wall of mirror discs (radius 1.8 mm, 3 mm pitch, tilted about x
  only) and the detector (`_wallScene`).'''
  return _wallScene('surf5k_tp', 78, 65, 3., 0.6 * 3., False, False, tmpdir,
                    detectorZ)


def _sphereDetector():
  return OpticalGroup(
      OpticalType='Absorber', Label='Det',
      surfaces=[S.sphere(np.eye(4), elem=0, radius=300., orient=-1)],
      placements=[np.eye(4)])


def _slottedMirrorScene(label, slotted, tmpdir):
  scene = Scene(label=label, path=tmpdir and f'{tmpdir}/{label}')
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Mirror', Label='Slotted', surfaces=[slotted],
      placements=[T.translation(0, 0, 50)]))
  scene.addOpticalGroup(_sphereDetector())
  scene.addSource(PointSource(
      Label='Src', PowerDensity='exp(-theta^2/0.1)',
      ThetaDomain='0, 0.45', Wavelength=532.,
      ThetaResolutionNumericMode='1e4'))
  scene.addSimulationSettings(RaysPerIteration=1e6, MaxIntersections=4)
  return scene


def slotBitmap(R=64, rDisc=20., slotHalf=2., window=25.):
  '''A disc occupancy bitmap with a vertical slot cut (the shape of
  example 2's slotted mirrors), mask[iv, iu] over a square chart window:
  the `trimBitmap` of a plane face.'''
  ax = (np.arange(R) + .5) / R * (2 * window) - window
  X, Y = np.meshgrid(ax, ax)                     # row iv -> y, col iu -> x
  mask = ((X ** 2 + Y ** 2 <= rDisc ** 2)
          & (np.abs(X) >= slotHalf)).astype(np.uint8)
  return dict(mask=mask, u0=-window, v0=-window,
              invDu=R / (2 * window), invDv=R / (2 * window))


def buildBitmapSlotScene(tmpdir=None):
  '''The slotted bitmap mirror of the reference's trim tests: a plane
  mirror at z = 50 mm trimmed by a 64 x 64 bitmap (a disc of radius 20 mm
  with a 4 mm slot), a point source of exp(-theta^2/0.1) over [0, 0.45]
  and an absorbing sphere of radius 300 mm as the detector: rays through
  the slot and past the disc reach the far side, the rest fold back; 4
  intersections (histograms over +-300 mm).'''
  slotted = S.plane(np.eye(4), elem=0, halfExtents=(25., 25.))
  slotted['trimBitmap'] = slotBitmap()
  return _slottedMirrorScene('bitmap_slot', slotted, tmpdir)


def buildPrimSlotScene(tmpdir=None):
  '''The hole-primitive slotted mirror of the reference's trim tests: a
  disc mirror of radius 22 mm at z = 50 mm minus a rotated rectangular
  strip (half-width 2.2 mm at 30 deg) and a half-plane corner cut, with the
  source and detector of `buildBitmapSlotScene`.'''
  slotted = S.plane(np.eye(4), elem=0, radius=22.)
  slotted['trim'][0] = 3.                      # annulus base + prims
  ang = np.deg2rad(30.)
  slotted['trimPrims'] = dict(holes=[
      (1., 0.5, -0.25, 1e7, 2.2, float(np.cos(ang)), float(np.sin(ang))),
      (3., 14., 14., 1., 1., 0., 0.),          # half-plane corner cut
  ])
  return _slottedMirrorScene('prim_slot', slotted, tmpdir)


def _ellipsoidCoeffs(a, b, c):
  q = np.array([1. / a ** 2, 1. / b ** 2, 1. / c ** 2, 0., -1.])
  return tuple(q / q[:3].max())


def buildKindsScene(tmpdir=None):
  '''Every surface kind of B2 on one optical axis, onto an absorbing
  sphere of radius 300 mm about a point source of exp(-theta^2/0.1) over
  theta in [0, 0.5]:
    * a lens (n = 1.5) at z = 40 mm: an even asphere front (c = 1/50,
      a4 = -2e-6; it stays an ASPHERE), a conic back (c = -1/60, k = -0.5;
      rewritten as a QUADRIC) and a CONE barrel between their rims;
    * the reference's quadric lens (n = 1.6): a plane disc of radius 16 mm
      at z = 110 mm under the cap z in [160, 165] of an ellipsoid of
      semi-axes (20, 30, 15) mm centred at z = 150 mm (a QUADRIC);
    * a TORUS mirror (R = 30, r = 8 mm) at z = 80 mm trimmed to the outer
      half of its tube (v in [-pi/2, pi/2]), which the wider rays meet;
  8 intersections (histograms over +-300 mm).'''
  scene = Scene(label='kinds', path=tmpdir and f'{tmpdir}/kinds')
  cF, a4, rF = 1. / 50., -2e-6, 8.
  cB, kB, rB, thick = -1. / 60., -0.5, 8.5, 6.

  def sag(c, k, r, a4=0.):
    return c * r * r / (1. + np.sqrt(1. - (1. + k) * c * c * r * r)) \
        + a4 * r ** 4
  zF, zB = sag(cF, 0., rF, a4), thick + sag(cB, kB, rB)
  tanA = (rB - rF) / (zB - zF)
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Lens', Label='AsphLens', RefractiveIndex=1.5,
      surfaces=[
          S.asphere(np.eye(4), elem=0, curvature=cF, coeffs=(a4,), rMax=rF,
                    orient=-1),
          S.asphere(T.translation(0, 0, thick), elem=0, curvature=cB,
                    conic=kB, rMax=rB, orient=+1),
          S.cone(np.eye(4), elem=0, radius=rF - zF * tanA, tanAngle=tanA,
                 zRange=(zF, zB), orient=+1)],
      placements=[T.translation(0, 0, 40)]))
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Lens', Label='DomeLens', RefractiveIndex=1.6,
      surfaces=[
          S.quadric(T.translation(0, 0, 40), elem=0,
                    coeffs=_ellipsoidCoeffs(20., 30., 15.),
                    zRange=(10., 15.)),
          S.plane(np.eye(4), elem=0, radius=16., orient=-1)],
      placements=[T.translation(0, 0, 110)]))
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Mirror', Label='HalfRing',
      surfaces=[S.torus(np.eye(4), elem=0, majorRadius=30., minorRadius=8.,
                        vRange=(-1.5707, 1.5707))],
      placements=[T.translation(0, 0, 80.)]))
  scene.addOpticalGroup(_sphereDetector())
  scene.addSource(PointSource(
      Label='Src', PowerDensity='exp(-theta^2/0.1)',
      ThetaDomain='0, 0.5', Wavelength=532.,
      ThetaResolutionNumericMode='1e4'))
  scene.addSimulationSettings(RaysPerIteration=1e6, MaxIntersections=8)
  return scene


CULL_DECOYS = 32
CULL_DECOY_RING = 400.


def buildCullDecoyScene(tmpdir=None):
  '''The per-bounce culls' check scene (B12): the reference's fold scene of
  its cull tests with decoys no beam reaches. A point source at z = 1e-3 mm
  (exp(-theta^2/0.01) over theta in [0, 0.2], 532 nm) lights a 45 deg plane
  fold mirror of radius 60 mm at z = 100 mm, which sends the beam to an
  absorbing, recording 100 x 100 mm detector at (0, 200, 100) facing it;
  CULL_DECOYS mirrors, alternately even aspheres (c = 1/100, a4 = 1e-6,
  r <= 20 mm) and tori (R = 20, r = 5 mm), stand on a ring of radius
  CULL_DECOY_RING mm in the plane z = -300 mm, behind the source and out
  of every beam. 4 intersections (histograms over +-300 mm). Without the
  culls every segment sweeps all 34 surface rows; with them only the fold
  and the detector.'''
  scene = Scene(label='cull_decoy', path=tmpdir and f'{tmpdir}/cull_decoy')
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Mirror', Label='Fold',
      surfaces=[S.plane(np.eye(4), elem=0, radius=60.)],
      placements=[T.placement((0, 0, 100.), axis=(1, 0, 0), angleDeg=45.)]))
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Absorber', Label='Det', RecordHits=True,
      surfaces=[S.plane(np.eye(4), elem=0, halfExtents=(50., 50.))],
      placements=[T.placement((0, 200., 100.), axis=(1, 0, 0),
                              angleDeg=-90.)]))
  decoys = []
  for k in range(CULL_DECOYS):
    phi = 2. * np.pi * k / CULL_DECOYS
    at = T.translation(CULL_DECOY_RING * np.cos(phi),
                       CULL_DECOY_RING * np.sin(phi), -300.)
    decoys.append(
        S.asphere(at, elem=0, curvature=1. / 100., coeffs=(1e-6,), rMax=20.)
        if k % 2 == 0 else
        S.torus(at, elem=0, majorRadius=20., minorRadius=5.))
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Mirror', Label='Decoys', surfaces=decoys,
      placements=[np.eye(4)]))
  scene.addSource(PointSource(
      Label='Src', PowerDensity='exp(-theta^2/0.01)', ThetaDomain='0, 0.2',
      Wavelength=532., ThetaResolutionNumericMode='1e3',
      placement=T.translation(0, 0, 1e-3)))
  scene.addSimulationSettings(RaysPerIteration=1e6, MaxIntersections=4)
  return scene


def buildEmitterKindsScene(tmpdir=None):
  '''A surface source whose four emitting faces are of the kinds of B2:
  a cone (radius 10 + 0.3 z over z in [0, 10] mm) at x = -60 mm, an even
  asphere dish (c = -1/40, a4 = 1e-6, r <= 15 mm) at x = 60 mm, the upper
  outer quarter of a torus (R = 15, r = 4 mm, v in [0, pi/2]) at y = 60 mm
  and a triangle at y = -60 mm, all radiating cos(theta)^2 onto an
  absorbing 400 x 400 mm detector plane at z = 100 mm; 4 intersections
  (histograms over +-200 mm).'''
  from .models import SurfaceSource
  scene = Scene(label='emit_kinds', path=tmpdir and f'{tmpdir}/emit_kinds')
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Mirror', Label='Emitters',
      surfaces=[
          S.cone(T.translation(-60, 0, 0), elem=0, radius=10., tanAngle=0.3,
                 zRange=(0., 10.)),
          S.asphere(T.translation(60, 0, 0), elem=0, curvature=-1. / 40.,
                    coeffs=(1e-6,), rMax=15.),
          S.torus(T.translation(0, 60, 0), elem=0, majorRadius=15.,
                  minorRadius=4., vRange=(0., np.pi / 2)),
          S.triangle((-10., -70., 0.), (10., -70., 0.), (0., -50., 0.),
                     elem=0)],
      placements=[np.eye(4)]))
  scene.addOpticalGroup(OpticalGroup(
      OpticalType='Absorber', Label='Det',
      surfaces=[S.plane(np.eye(4), elem=0, halfExtents=(200., 200.))],
      placements=[T.translation(0, 0, 100)]))
  scene.addSource(SurfaceSource(Label='Source', ActiveSurfaces=['Emitters'],
                                PowerDensity='cos(theta)**2'))
  scene.addSimulationSettings(RaysPerIteration=1e6, MaxIntersections=4)
  return scene


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
                  stratified=False, histPrecision='default', useKernel='auto',
                  device='cuda'):
  '''Compile the fused sample+trace+histogram step for a benchmark scene
  (`histBounds`: the detector-local x0, x1, y0, y1 of the histograms).
  Returns (step, histograms, meta). step: (seed, hist) -> (hist, counters)
  with `seed` a python int or a torch.Generator; `hist` is accumulated in
  place. With useKernel 'auto' or True (the reference's `usePallas`) the
  step on a scene the kernels cover is ONE launch of the CUDA trace kernel
  with the in-kernel sampler (histPrecision='highest': one launch of the
  per-ray-bin kernel plus float64 binning outside, see
  `cuda_trace.makeTraceStep`), meta['backend'] 'cuda' ('plain' on the
  CPU). On a scene `cuda_trace.ineligibleReason` refuses, or with
  useKernel=False, it is the fused step's twin (`fused.makeFusedStep`,
  plain PyTorch over the record tracer's bounce, the source's device
  generator drawing the rays), meta['backend'] 'tracer', as the reference
  takes its XLA step. device='cpu' runs the plain PyTorch versions; the
  default 'cuda' raises without a card.'''
  dev = resolveDevice(device)
  if scene is None:
    scene = buildLensMirrorScene()
  sceneHost, info = scene.compile(device=None)
  src = scene.lightSources()[0]
  histSpec = fused.makeHistogramSpec(sceneHost, info,
                                     bounds=histBounds, bins=bins)
  hist = fused.initHistograms(histSpec, device=dev)
  settings = scene.activeSimulationSettings()
  if not useKernel or cuda_trace.ineligibleReason(sceneHost) is not None:
    sceneHost['powerTol'] = 1e-6
    step = fused.makeFusedStep(
        sceneHost, src.deviceGenerator(device=dev), histSpec, raysPerStep,
        maxIntersections, settings.maxRayLength(),
        max(settings.distanceTolerance(), 1e-4), stratified=stratified,
        device=dev)
    return step, hist, dict(scene=scene, device=sceneHost, info=info,
                            histSpec=histSpec, backend='tracer')
  step = cuda_trace.makeTraceStep(
      sceneHost, histSpec, src.deviceColumnsGenerator(device=dev),
      raysPerStep=raysPerStep, maxIntersections=maxIntersections,
      maxRayLength=settings.maxRayLength(),
      distTol=max(settings.distanceTolerance(), 1e-4), powerTol=1e-6,
      stratified=stratified, histPrecision=histPrecision,
      sampler=src.samplerSpec(), emissionBound=src.emissionBound(),
      device=dev)
  return step, hist, dict(scene=scene, device=sceneHost, info=info,
                          histSpec=histSpec,
                          backend='cuda' if dev.type == 'cuda' else 'plain')
