'''FCStd ingest on the PyTorch port: the port's `models/fcstd_ingest.py`
against the JAX package's on the synthetic projects of `fcstd_fixtures`
(the lens-and-mirror scene, the slotted plate, examples/1, containers and
links with every source kind, a host with an external document, a member
neither package can rebuild): Document.xml, the scenes and their compiled
host tables equal; placements composed as FreeCAD composes them; the
lens-and-mirror project traced like `benchmarks.buildLensMirrorScene` on
the same rays; and an ingested examples/1 run on the CPU.'''

import os

import numpy as np
import pytest
import torch

import fcstd_fixtures as F
from test_torch_brep import assertSurfacesEqual
from optics_design_workbench_tpu.models import fcstd_ingest as jaxIngest
from optics_design_workbench_tpu_torch import benchmarks, simulation
from optics_design_workbench_tpu_torch.geometry import surfaces as S
from optics_design_workbench_tpu_torch.jupyter_utils import RawFolder
from optics_design_workbench_tpu_torch.models import fcstd_ingest as P
from optics_design_workbench_tpu_torch.tracing import tracer

torch.set_num_threads(1)

PROJECTS = ('lensMirror', 'slotPlate', 'sourceDetector', 'structure',
            'external')


@pytest.fixture(scope='module')
def projects(tmp_path_factory):
  folder = str(tmp_path_factory.mktemp('projects'))
  return dict(
      lensMirror=F.lensMirrorProject(folder),
      slotPlate=F.slotPlateProject(folder),
      sourceDetector=F.sourceDetectorProject(folder),
      structure=F.structureProject(folder, replayFrom=folder),
      external=F.externalProjects(folder))


@pytest.fixture(scope='module')
def scenes(projects):
  '''{name: (port scene, JAX scene)}, each project loaded once.'''
  return {name: (P.loadFCStd(path), jaxIngest.loadFCStd(path))
          for name, path in projects.items()}


def _documents(path):
  import zipfile
  with zipfile.ZipFile(path) as z:
    xml = z.read('Document.xml')
  return P.parseDocumentXml(xml), jaxIngest.parseDocumentXml(xml)


def _assertValuesEqual(a, b, where):
  if isinstance(b, np.ndarray):
    np.testing.assert_allclose(np.asarray(a), b, rtol=0., atol=1e-12,
                               err_msg=where)
  else:
    assert type(a) is type(b) and a == b, where


@pytest.mark.parametrize('name', PROJECTS)
def test_document_matches_reference(name, projects):
  port, ref = _documents(projects[name])
  assert list(port) == list(ref)
  for key, b in ref.items():
    a = port[key]
    assert (a.name, a.type, a.label) == (b.name, b.type, b.label)
    assert sorted(a.props) == sorted(b.props)
    for prop, value in b.props.items():
      _assertValuesEqual(a.props[prop], value, f'{key}.{prop}')


def _sourceProps(src):
  return {k: getattr(src, k) for k in src.propertyNames()}


@pytest.mark.parametrize('name', PROJECTS)
def test_scene_matches_reference(name, scenes):
  port, ref = scenes[name]
  assert (port.label, port.path) == (ref.label, ref.path)
  ga, gb = port.opticalObjects(), ref.opticalObjects()
  assert [(g.Label, g.OpticalType, type(g).__name__) for g in ga] == \
      [(g.Label, g.OpticalType, type(g).__name__) for g in gb]
  for a, b in zip(ga, gb):
    assert _sourceProps(a) == _sourceProps(b)
    assert len(a.placements) == len(b.placements)
    for pa, pb in zip(a.placements, b.placements):
      np.testing.assert_array_equal(pa, pb)
    assertSurfacesEqual(a.surfaces, b.surfaces)
  sa, sb = port.lightSources(), ref.lightSources()
  assert [(type(s).__name__, s.Label) for s in sa] == \
      [(type(s).__name__, s.Label) for s in sb]
  for a, b in zip(sa, sb):
    assert _sourceProps(a) == _sourceProps(b)
    np.testing.assert_array_equal(a.placement, b.placement)
  assert _sourceProps(port.activeSimulationSettings()) == \
      _sourceProps(ref.activeSimulationSettings())


@pytest.mark.parametrize('name', PROJECTS)
def test_compiled_tables_match_reference(name, scenes):
  port, ref = scenes[name]
  a, _infoA = port.compile(device=None)
  b, _infoB = ref.compile(devicePut=False)
  for part in ('surfaces', 'elements'):
    # the JAX package's table also carries its own split by kind and the
    # rotations unpacked (the port's record tracer derives them)
    assert set(a[part]) <= set(b[part]), part
    for key, value in a[part].items():
      np.testing.assert_array_equal(value, np.asarray(b[part][key]),
                                    err_msg=key)


def test_placements_compose_as_freecad_does(scenes):
  '''The structure project's containers, links and sources, against the
  matrices FreeCAD composes (both packages already agree above).'''
  port = scenes['structure'][0]
  doc = {o.name: o for o in P.parseDocumentXml(
      _zipMember(port.path + '.FCStd', 'Document.xml')).values()}
  at = lambda name: doc[name].get('Placement')
  groups = {g.Label: g for g in port.opticalObjects()}
  # App::Part: its visible child only, under the Part's placement
  (sphere,) = groups['Mirrors'].surfaces
  np.testing.assert_allclose(sphere['transform'],
                             at('Part') @ at('Sphere'), atol=1e-12)
  # App::Link: LinkTransform false replaces the target's placement, true
  # composes with it (the rod's band is its first surface)
  lenses = groups['Lenses'].surfaces
  np.testing.assert_allclose(lenses[0]['transform'], at('LinkPlaced'),
                             atol=1e-12)
  np.testing.assert_allclose(lenses[3]['transform'],
                             at('LinkComposed') @ at('Rod'), atol=1e-12)
  # a group linked elsewhere exists at both placements
  rod = groups['RodItself']
  assert len(rod.placements) == 2
  found = sorted(np.round(m, 9).tobytes() for m in rod.placements)
  want = sorted(np.round(m, 9).tobytes()
                for m in (at('OpticalVacuumGroup'), at('GroupLink')))
  assert found == want
  # BRep members keep their blob's root location; the group adds its own
  shapes = groups['Shapes']
  np.testing.assert_allclose(shapes.placements[0],
                             F.translation(0., 0., -30.), atol=1e-12)
  sources = {s.Label: s for s in port.lightSources()}
  np.testing.assert_allclose(sources['PartSource'].placement,
                             at('Holder') @ at('OpticalPointSource'),
                             atol=1e-12)
  assert sources['Glow'].ActiveSurfaces == [('Emitter', [0, 2])]
  assert sources['Replay'].ReplayFromDir == os.path.dirname(port.path)
  np.testing.assert_allclose(sources['Replay'].placement,
                             F.translation(0., 0., 7.), atol=1e-12)
  ext = {g.Label: g for g in scenes['external'][0].opticalObjects()}
  assert len(ext['linkedMirrors'].surfaces) == 13
  assert 'ExtDetector' in ext


def _zipMember(path, member):
  import zipfile
  with zipfile.ZipFile(path) as z:
    return z.read(member)


def test_unsupported_member_uses_the_reference_words(tmp_path, monkeypatch):
  path = F.unsupportedProject(str(tmp_path))
  errors, warnings = [], {}
  for module in (P, jaxIngest):
    with pytest.raises(NotImplementedError) as e:
      module.loadFCStd(path)
    errors.append(str(e.value))
    got = warnings.setdefault(module.__name__, [])
    monkeypatch.setattr(module.io, 'warn', got.append)
    scene = module.loadFCStd(path, skipUnsupported=True)
    groups = {g.Label: len(g.surfaces) for g in scene.opticalObjects()}
    assert groups == {'Broken': 0, 'Det': 6}
  assert errors[0] == errors[1]
  assert "cannot rebuild geometry of 'Mystery' (PartDesign::Body)" in \
      errors[0] and 'not a CASCADE Topology V1 BRep blob' in errors[0]
  assert list(warnings.values())[0] == list(warnings.values())[1] == \
      [errors[0]]


def test_missing_external_document_loads_what_it_can(tmp_path, monkeypatch):
  host = F.externalProjects(str(tmp_path), withExternal=False)
  loaded = []
  for module in (P, jaxIngest):
    said = []
    monkeypatch.setattr(module.io, 'warn', said.append)
    scene = module.loadFCStd(host)
    assert len(said) == 1 and "'external.FCStd' not found" in said[0]
    loaded.append([(g.Label, len(g.surfaces)) for g in
                   scene.opticalObjects()])
  assert loaded[0] == loaded[1] == [('linkedMirrors', 1)]


# ---- physics: the ingested lens-and-mirror traces like the built scene

N_RAYS = 2048


def _rays():
  '''2,048 rays from the origin, theta in [0, 0.5] (past the lens's rim,
  so that some reach its barrel), phi in [0, 2 pi), from numpy seed 18.'''
  rng = np.random.default_rng(18)
  theta = rng.uniform(0., .5, N_RAYS)
  phi = rng.uniform(0., 2 * np.pi, N_RAYS)
  d = np.stack([np.sin(theta) * np.cos(phi), np.sin(theta) * np.sin(phi),
                np.cos(theta)], 1)
  f32 = lambda x: torch.as_tensor(x, dtype=torch.float32)
  return (f32(np.zeros((N_RAYS, 3))), f32(d), f32(np.ones(N_RAYS)),
          f32(np.full(N_RAYS, 532.)))


def _traceScene(scene):
  """(elements crossed (6, N), which rays meet a lens barrel, which meet
  any other cylinder (the project's mirror is a thin cylinder, its edge a
  band the built disc lacks), detector hit points (N, 3), NaN where none)
  of the port's record tracer on `_rays()`."""
  host, _info = scene.compile(device=None)
  host['powerTol'] = 1e-6
  _state, rec = tracer.trace(host, *_rays(), 6, 1000., 1e-4,
                             recordSegments=False)
  surf = host['surfaces']
  cylinder = np.asarray(surf['kind']) == S.CYLINDER
  lens = np.asarray(surf['elem']) == 0
  hitSurf = rec['hitSurface'].numpy()
  meets = lambda rows: np.isin(hitSurf, np.nonzero(rows)[0]).any(axis=0)
  elems = rec['hitElem'].numpy()
  detector = elems == 2
  point = np.where(detector.any(axis=0)[:, None],
                   rec['point'].numpy()[detector.argmax(axis=0),
                                        np.arange(N_RAYS)], np.nan)
  return elems, meets(cylinder & lens), meets(cylinder & ~lens), point


def test_lens_project_traces_like_the_built_scene(scenes):
  """The same 2,048 rays through the ingested lens-and-mirror project and
  through `buildLensMirrorScene` (the port's record tracer, CPU): every ray
  that meets no cylinder in either scene crosses the same elements and
  lands on the detector within 1e-3 mm. The cylinders differ on purpose:
  the built lens barrel spans z 0-6 mm, the solid's only its rim band at z
  5.46-6 mm, and the project's mirror is a 1 mm thick Part::Cylinder whose
  edge band the built disc lacks."""
  ingested = _traceScene(scenes['lensMirror'][0])
  built = _traceScene(benchmarks.buildLensMirrorScene())
  # rays at theta ~0.42-0.46 cross r = 25 mm at z 50-56 mm: 171 meet the
  # built barrel, 7 of those the solid's rim band; 10 graze the mirror's
  # edge band (counts on one x86 CPU; a ray on a rim may flip on another)
  barrel = ingested[1] | built[1]
  edge = ingested[2] & ~barrel
  assert 150 <= int(barrel.sum()) <= 190 and int(ingested[1].sum()) <= 12
  assert 0 < int(edge.sum()) <= 20
  assert not built[2].any()
  keep = ~(barrel | edge)
  np.testing.assert_array_equal(ingested[0][:, keep], built[0][:, keep])
  landed = np.isfinite(built[3][:, 0]) & keep
  assert landed.sum() > 0.6 * N_RAYS
  assert np.isfinite(ingested[3][landed]).all()
  assert np.abs(ingested[3][landed] - built[3][landed]).max() < 1e-3


def test_ingested_examples1_run_on_the_cpu(projects, tmp_path):
  '''examples/1 as a project runs through the port on the CPU (the
  reference's own check of its examples/1 project, singletrue at 3,000
  rays, seed 3): most rays land on the box's top face at z = 50.'''
  import shutil
  path = str(tmp_path / 'main.FCStd')
  shutil.copy(projects['sourceDetector'], path)
  scene = P.loadFCStd(path)
  settings = scene.getObject('OpticalSimulationSettings')
  settings.EnableStoreSingleShotData = True
  settings.RaysPerIteration = 3000
  runPath = simulation.runSimulation(scene, 'singletrue', seed=3,
                                     device='cpu')
  hits = RawFolder(runPath).loadHits('OpticalAbsorberGroup')
  assert len(hits) > 1000
  pts = hits.points()
  assert np.allclose(pts[:, 2], 50., atol=1.1)
  assert np.abs(pts[:, 0]).max() <= 5.01 and np.abs(pts[:, 1]).max() <= 5.01
