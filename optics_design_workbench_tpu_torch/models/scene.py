'''
Scene (document) model: the container of light sources, optical groups and
simulation settings that the reference keeps inside a FreeCAD document
(reference: freecad_elements/__init__.py:19-99 `loadAll`/`collectGlobalInfo`,
find.py:59-141 scene queries). Compiles to the device scene consumed by the
tracer, preserving multi-placement instancing (one group may occur at
several global transforms, common.py:36-109) and per-source ignore lists.
'''

import os

import numpy as np
import torch

from .. import resolveDevice
from ..geometry import surfaces as geomSurfaces
from ..tracing import buildElementTable
from .settings import SimulationSettings
from .optical_group import OpticalGroup
from .generic_source import GenericSource


class Scene:

  def __init__(self, label='scene', path=None):
    self.label = label
    self.path = path
    self.objects = []

  # --------------------------------------------------------------- additions

  def add(self, obj):
    self.objects.append(obj)
    return obj

  def addOpticalGroup(self, *args, **kwargs):
    obj = args[0] if args and isinstance(args[0], OpticalGroup) \
        else OpticalGroup(*args, **kwargs)
    return self.add(obj)

  def addSource(self, source):
    if hasattr(source, 'attachScene'):
      source.attachScene(self)
    return self.add(source)

  def addSimulationSettings(self, **kwargs):
    settings = (kwargs.pop('settings') if 'settings' in kwargs
                else SimulationSettings(**kwargs))
    # exactly-one-active semantics (reference: find.py:116-141,
    # simulation_settings.py:102-106)
    if settings.Active:
      for other in self.simulationSettingsObjects():
        other.Active = False
    return self.add(settings)

  # ----------------------------------------------------------------- queries

  def lightSources(self):
    return [o for o in self.objects if isinstance(o, GenericSource)]

  def opticalObjects(self):
    return [o for o in self.objects if isinstance(o, OpticalGroup)]

  def simulationSettingsObjects(self):
    return [o for o in self.objects if isinstance(o, SimulationSettings)]

  def activeSimulationSettings(self):
    active = [s for s in self.simulationSettingsObjects() if s.Active]
    if len(active) > 1:
      raise ValueError('more than one active SimulationSettings object')
    if active:
      return active[0]
    if self.simulationSettingsObjects():
      return None
    # like the reference, fall back to defaults when no settings exist
    return SimulationSettings()

  def getObject(self, label):
    for o in self.__dict__.get('objects', []):
      if getattr(o, 'Label', None) == label:
        return o
    raise KeyError(f'no object labelled {label!r}')

  def __getattr__(self, name):
    # attribute-style access by label, FreecadDocument-style
    # (reference: jupyter_utils/freecad_document.py:132-408); guard dunder
    # names so pickling/copy protocols don't recurse
    if name.startswith('_') or name == 'objects':
      raise AttributeError(name)
    try:
      return self.getObject(name)
    except KeyError:
      raise AttributeError(name)

  def relevantOpticalObjects(self, source):
    '''Optical groups minus the source's ignore list (reference:
    find.py:79-104).'''
    ignored = set(getattr(source, 'IgnoredOpticalElements', []) or [])
    return [g for g in self.opticalObjects() if g.Label not in ignored]

  # ------------------------------------------------------------- compilation

  def compile(self, dtype=np.float32, device='cuda'):
    '''Build the scene dict: surface table (one instance per group
    placement), element table, sequential-mode mask. Returns (sceneDict,
    info) where info maps element indices to labels and holds the
    per-source surface masks. Compilation is host-side numpy; `device`
    says where the leaves go afterwards: a torch device (default 'cuda',
    raising without a card) turns every array into a tensor there, and
    device=None keeps host numpy (what `buildTraceTables` reads —
    the counterpart of the reference's devicePut=False).

    `seqMask` (stages x surfaces, bool) comes from the active settings'
    SequentialModeElements; `info['surfaceMasks']` maps a source's label
    to the surfaces its IgnoredOpticalElements leave (the runner puts it
    into that source's scene as `surfMask`). Groups with stochastic
    scatter densities add `scatter`, the tables of
    `models/scatter.buildScatterTables`.'''
    groups = self.opticalObjects()
    if not groups:
      raise ValueError('scene has no optical elements')
    surfs, elems = [], []
    for e, group in enumerate(groups):
      elems.append(group.toElementDict())
      for placement in group.placements:
        for spec in group.surfaces:
          inst = dict(spec)
          inst['transform'] = np.asarray(placement, dtype=float) @ \
              np.asarray(spec['transform'], dtype=float)
          inst['elem'] = e
          surfs.append(inst)
    scene = dict(surfaces=geomSurfaces.buildSurfaceTable(surfs, dtype=dtype),
                 elements=buildElementTable(elems, dtype=dtype))
    surfElem = scene['surfaces']['elem']

    # stochastic scatter tables (Reflected / Refracted / RayModification
    # probability densities)
    from .scatter import buildScatterTables
    scatter = buildScatterTables(groups, dtype=dtype)
    if scatter is not None:
      scene['scatter'] = scatter

    settings = self.activeSimulationSettings()
    if settings is not None and settings.SequentialMode \
        and settings.SequentialModeElements:
      labelToIdx = {g.Label: i for i, g in enumerate(groups)}
      scene['seqMask'] = np.stack([
          np.isin(surfElem, [labelToIdx[l] for l in labels])
          for labels in settings.SequentialModeElements])

    surfMasks = {}
    for src in self.lightSources():
      ignored = set(getattr(src, 'IgnoredOpticalElements', []) or [])
      if ignored:
        surfMasks[src.Label] = np.array([groups[e].Label not in ignored
                                         for e in surfElem])
    if device is not None:
      dev = resolveDevice(device)
      put = lambda v: torch.as_tensor(v, device=dev)
      scene = {name: ({k: put(v) for k, v in leaf.items()}
                      if isinstance(leaf, dict) else put(leaf))
               for name, leaf in scene.items()}
      surfMasks = {k: put(v) for k, v in surfMasks.items()}
    info = dict(elementLabels=[g.Label for g in groups],
                surfaceMasks=surfMasks)
    return scene, info

  # ------------------------------------------------------------- global info

  def collectGlobalInfo(self):
    '''Pickleable dict with all object properties and placements, dumped as
    global-info per run (reference: freecad_elements/__init__.py:31-99).'''
    info = dict(label=self.label, path=self.path, settings={}, sources={},
                opticalObjects={})
    for s in self.simulationSettingsObjects():
      info['settings'][s.Label] = s.propertiesDict()
    for s in self.lightSources():
      d = s.propertiesDict()
      d['placement'] = np.asarray(s.placement).tolist()
      info['sources'][s.Label] = d
    for g in self.opticalObjects():
      d = g.propertiesDict()
      d['placements'] = [np.asarray(p).tolist() for p in g.placements]
      d['GratingLinesOrientation'] = list(d['GratingLinesOrientation'])
      info['opticalObjects'][g.Label] = d
    return info

  def resultsFolderPath(self):
    '''`<name>.OpticsDesign` folder next to the document (reference:
    results_store.py:28-72).'''
    base = self.path or os.path.join(os.getcwd(), self.label)
    base = os.path.splitext(base)[0]
    return base + '.OpticsDesign'
