'''
Replay light source — re-emits rays recorded by a previous simulation run
(reference: freecad_elements/replay_source.py): walks the hit files under
`ReplayFromDir` in shuffled order, emits each recorded (point, direction,
power) exactly once, marks consumed files under
`<results>/replay-source-used-files` so concurrent runs never replay the
same file (:56-113), applies the source's own placement transform (:146-152)
and ends the simulation when the stock is exhausted (:162-163). Fan mode is
unsupported (:133-136).
'''

import glob
import hashlib
import os

import numpy as np

from ..simulation.lifecycle import SimulationEnded
from ..utils import io
from .generic_source import GenericSource


class ReplaySource(GenericSource):

  def _properties(self):
    return [
        ('OpticalEmission', [
            ('ReplayFromDir', '',
             'folder with recorded *-hits.npz files (a simulation-run '
             'folder or any subfolder of one)'),
            ('Wavelength', None,
             'override wavelength (nm); None keeps recorded wavelengths '
             'when present, else 500'),
        ]),
    ] + self._baseProperties()

  def __init__(self, placement=None, usedFilesDir=None, **kwargs):
    super().__init__(placement=placement, **kwargs)
    self._usedFilesDir = usedFilesDir
    self._exhausted = False

  def _usedFlagFolder(self):
    if self._usedFilesDir is not None:
      return self._usedFilesDir
    # walk up from ReplayFromDir to the .OpticsDesign folder
    folder = os.path.abspath(self.ReplayFromDir)
    probe = folder
    while probe and probe != os.path.dirname(probe):
      if probe.endswith('.OpticsDesign'):
        return os.path.join(probe, 'replay-source-used-files')
      probe = os.path.dirname(probe)
    return os.path.join(folder, 'replay-source-used-files')

  def _claimFile(self, path):
    '''Atomic cross-process claim: create the flag with O_EXCL; only the
    creator replays the file (the reference uses unlink-as-claim on
    pre-created flags, replay_source.py:56-70 — create-exclusive gives the
    same mutual exclusion without the setup pass).'''
    folder = self._usedFlagFolder()
    os.makedirs(folder, exist_ok=True)
    digest = hashlib.sha1(os.path.abspath(path).encode()).hexdigest()[:16]
    flag = os.path.join(folder, f'{os.path.basename(path)}-{digest}')
    try:
      fd = os.open(flag, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
      os.close(fd)
      return True
    except FileExistsError:
      return False

  def resetUsedFiles(self):
    folder = self._usedFlagFolder()
    if os.path.isdir(folder):
      for f in os.listdir(folder):
        try:
          os.remove(os.path.join(folder, f))
        except OSError:
          pass
    self._exhausted = False

  def generateRays(self, mode, settings=None, rng=None, **kwargs):
    if mode == 'fans':
      raise ValueError('replay sources do not support fan mode '
                       '(reference: replay_source.py:133-136)')
    rng = rng or np.random.default_rng()
    if not self.ReplayFromDir:
      raise ValueError(f'replay source {self.Label} has no ReplayFromDir')
    # .pkl included so a reference-written run folder replays unchanged
    # (reference: replay_source.py:73-113 reads its own *-hits.pkl files)
    files = sorted(set(
        p for ext in ('npz', 'odwc', 'pkl')
        for p in glob.glob(os.path.join(self.ReplayFromDir, '**',
                                        f'*-hits.{ext}'), recursive=True)))
    if not files:
      raise SimulationEnded(f'replay source {self.Label}: no hit files '
                            f'under {self.ReplayFromDir}')
    order = rng.permutation(len(files))
    for idx in order:
      path = files[idx]
      if not self._claimFile(path):
        continue
      from ..simulation.results_store import loadResultFile
      data = loadResultFile(path)
      points = np.asarray(data['points'], float)
      directions = np.asarray(data['directions'], float)
      powers = np.asarray(data.get('powers', np.ones(len(points))), float)
      if self.Wavelength is not None:
        wl = np.full(len(points), float(self.Wavelength))
      elif 'initWavelength' in data:
        wl = np.asarray(data['initWavelength'], float)
      else:
        wl = np.full(len(points), 500.)
      # shuffle within the file (replay_source.py:73-113)
      perm = rng.permutation(len(points))
      points, directions = points[perm], directions[perm]
      powers, wl = powers[perm], wl[perm]
      # apply own placement (replay_source.py:146-152)
      R, off = self.placement[:3, :3], self.placement[:3, 3]
      origins = points @ R.T + off
      dirs = directions @ R.T
      dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
      io.verb(f'replay source {self.Label}: replaying {len(points)} rays '
              f'from {os.path.basename(path)}')
      return dict(origins=origins, directions=dirs, powers=powers,
                  wavelengths=wl, metadata={})
    self._exhausted = True
    raise SimulationEnded(f'replay source {self.Label}: all recorded rays '
                          f'have been replayed')
