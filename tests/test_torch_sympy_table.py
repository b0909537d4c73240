'''ROADMAP C.3: a compile whose time guard fires inside sympy's one-time fill
of its Meijer-G lookup table (`sympy.integrals.meijerint._lookup_table`)
leaves the table partial for the rest of the process, and a DiracDelta
density compiled later then fails. The port fills the table before its
guarded region and replaces a partial one; the JAX package does not. The
partial table is installed here directly (no timer), as the interrupted
fill leaves it: the first keys of a fresh table.

Also the hits-file half of the reference's same-millisecond faults
(ROADMAP C, "two `flush()` calls within one millisecond"): the port writes
two files, the JAX package's second flush overwrites its first.
'''

import glob
import os
import time

import numpy as np
import pytest
from sympy.core.cache import clear_cache
from sympy.integrals import meijerint

import jax  # noqa: F401  (both packages live in this process)

from optics_design_workbench_tpu.distributions import \
    random_variables as jaxRV
from optics_design_workbench_tpu.simulation import results_store as jaxRS
from optics_design_workbench_tpu_torch.distributions import \
    random_variables as torchRV
from optics_design_workbench_tpu_torch.simulation import \
    results_store as torchRS

DIRAC_ROW = 'DiracDelta(theta-0.3) + 5*exp(-(theta-0.3)**2/0.02)'
THETA_DOMAIN = (0., np.pi / 2)
PARTIAL_KEYS = 2          # 15 of the 44 formulas (sympy 1.14)


def _formulas(table):
  return sum(len(v) for v in (table or {}).values())


def _freshTable():
  fresh = {}
  meijerint._create_lookup_table(fresh)
  return fresh


@pytest.fixture
def partialTable():
  '''Install a partial table; put a complete one back afterwards, so that
  no later test on this worker inherits the fault. sympy's cache is
  cleared before (an integral that an earlier test cached would never reach
  the table) and after (the integrals worked out with the partial table
  must not outlive it).'''
  clear_cache()
  fresh = _freshTable()
  partial = {k: fresh[k] for k in list(fresh)[:PARTIAL_KEYS]}
  assert 0 < _formulas(partial) < _formulas(fresh)
  meijerint._lookup_table = partial
  yield _formulas(fresh)
  meijerint._lookup_table = _freshTable()
  clear_cache()


@pytest.mark.parametrize('package', [
    'torch',
    pytest.param('jax', marks=pytest.mark.xfail(
        strict=True, reason='fault of the reference (ROADMAP C.3): its '
        'compile never repairs a partial Meijer-G table, so the DiracDelta '
        'row falls to numeric mode and raises', raises=ValueError))])
def test_dirac_row_compiles_after_partial_table(partialTable, package):
  RV = dict(torch=torchRV, jax=jaxRV)[package]
  rv = RV.ScalarRandomVariable(DIRAC_ROW, THETA_DOMAIN, 'theta')
  rv.compile(timeout=20)
  assert rv.mode() == 'analytic'
  assert _formulas(meijerint._lookup_table) == partialTable
  draws = np.asarray(rv.draw(N=4000), dtype=float)
  assert np.all(np.isfinite(draws))
  # the delta carries 1 / (1 + 5 sqrt(0.02 pi)) = 0.44 of the weight
  assert 0.35 < np.mean(np.abs(draws - 0.3) < 1e-9) < 0.53


def test_complete_table_is_left_alone():
  '''A complete table is the same object afterwards: the repair costs one
  count of its formulas.'''
  torchRV.ensureMeijerTable()
  table = meijerint._lookup_table
  torchRV.ensureMeijerTable()
  assert meijerint._lookup_table is table
  assert _formulas(table) == _formulas(_freshTable())


class _PinnedClock:
  '''The `time` module as the writer module sees it, its `time()` pinned.'''

  def __init__(self, now):
    self.now = now

  def time(self):
    return self.now

  def __getattr__(self, name):
    return getattr(time, name)


@pytest.mark.parametrize('writer', [
    'torch',
    pytest.param('jax', marks=pytest.mark.xfail(
        strict=True, reason='fault of the reference (ROADMAP C, "two '
        'flush() calls within one millisecond write the same name"): its '
        'second hits file overwrites the first, 1 file of 51 rows',
        raises=AssertionError))])
def test_hits_flush_same_millisecond(tmp_path, writer, monkeypatch):
  RS = dict(torch=torchRS, jax=jaxRS)[writer]
  monkeypatch.setattr(RS, 'time', _PinnedClock(1.7e9))
  res = RS.SimulationResults(
      simulationType='true', basePath=str(tmp_path),
      simulationRunFolder='raw/simulation-run-000000', fileFormat='npz')
  rng = np.random.default_rng(3)
  for n in (50, 51):
    res.addHitBatch('Source', 'Detector',
                    rng.normal(size=(n, 3)).astype(np.float32),
                    rng.normal(size=(n, 3)).astype(np.float32),
                    rng.random(n).astype(np.float32), rng.random(n) > 0.5)
    res.flush()
  folder = os.path.join(res.runPath(), 'source-Source', 'object-Detector')
  files = glob.glob(os.path.join(folder, '*-hits.*'))
  rows = sum(len(torchRS.loadResultFile(f)['points']) for f in files)
  assert (len(files), rows) == (2, 101)
