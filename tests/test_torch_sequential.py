'''Sequential mode and per-source surface masks in the PyTorch port (a
per-ray stage index gating each surface, and a source's
IgnoredOpticalElements, in the trace kernels' shared body; on the CPU their
plain versions) against the JAX package:

  * the reference suite's sequential ball-lens scene (stages [Ball], [Det]:
    lens entry does not advance the stage, so the exit face stays open) and
    a two-source scene in which source 'Blind' ignores the fold mirror that
    source 'Src' is folded by, traced as the JAX runner traces 'Blind';
  * the Pallas kernel (interpret mode) and the port's plain versions on the
    same uniforms: counters equal, counts within the 2-ray bin-edge budget,
    power per bin within 1 %, raw rows ray by ray within atol 1e-4;
  * `Scene.compile` builds the JAX package's `seqMask` and `surfaceMasks`;
  * `runSimulation` traces each source through its own mask, as the
    reference runner does;
  * `evaluateBatched` ignores a source's IgnoredOpticalElements, as the
    reference sweeper does (it never builds `surfMask`; ROADMAP C), and
    takes one launch per variant for a scene in sequential mode, with the
    stage gate (the reference's sweep kernel refuses `seqMask`).
'''

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (both frameworks live in this process)

import torch_port_helpers as H
from optics_design_workbench_tpu.jupyter_utils import \
    ParameterSweeper as RefSweeper
from optics_design_workbench_tpu.ops import pallas_trace
from optics_design_workbench_tpu_torch import simulation as torchSim
from optics_design_workbench_tpu_torch.jupyter_utils import (ParameterSweeper,
                                                             RawFolder)
from optics_design_workbench_tpu_torch.ops import cuda_trace

torch.set_num_threads(1)

MASK_SCENES = ('seqBall', 'maskedSource')
BOUNDS = (-40., 40., -40., 40.)


@pytest.fixture(scope='module', params=MASK_SCENES)
def maskCase(request):
  return dict(H.runB4Case(request.param), name=request.param)


def test_masked_histograms_match_reference(maskCase):
  H.assertHistogramsMatch(maskCase)


def test_masked_raw_rows_match_reference(maskCase):
  H.assertRawRowsMatch(maskCase)


def test_gate_flags_and_paths(maskCase):
  '''The ball's exit face stays open (3 segments a ray: entry, exit,
  detector); 'Blind' passes the fold mirror's surface and reaches the back
  detector in one segment.'''
  tables, n = maskCase['tables'], H.N_RAYS
  _, port = maskCase['hist']
  assert tables['gate'] and not tables['hasGrating']
  if maskCase['name'] == 'seqBall':
    assert tables['nStages'] == 2
    assert port['counters']['segments'] == 3 * n
  else:
    assert tables['nStages'] == 0
    assert [r['stages'] for r in tables['surfRows']] == [0, 1, 1]
    assert port['counters']['segments'] == n
  assert port['counters']['hits'] == n


@pytest.mark.parametrize('name', MASK_SCENES)
def test_compile_builds_the_reference_masks(name):
  build, _source = H.B4_SCENES[name]
  jaxScene, _, _ = build(H.jaxNs())
  torchScene, _, _ = build(H.torchNs())
  ref, refInfo = jaxScene.compile(devicePut=False)
  own, ownInfo = torchScene.compile(device=None)
  assert ('seqMask' in own) == ('seqMask' in ref)
  if 'seqMask' in ref:
    np.testing.assert_array_equal(own['seqMask'], np.asarray(ref['seqMask']))
  assert set(ownInfo['surfaceMasks']) == set(refInfo['surfaceMasks'])
  for label, mask in refInfo['surfaceMasks'].items():
    np.testing.assert_array_equal(ownInfo['surfaceMasks'][label],
                                  np.asarray(mask))
  for src in torchScene.lightSources():
    mask = ownInfo['surfaceMasks'].get(src.Label)
    scene = own if mask is None else dict(own, surfMask=mask)
    refScene = ref if mask is None else dict(ref, surfMask=mask)
    assert cuda_trace._staticMasks(scene) == \
        pallas_trace._staticMasks(refScene)


def _maskedScene(ns, path, sources=('Src', 'Blind')):
  scene, _, _ = H.buildMaskedSourcesScene(ns)
  scene.path = path
  scene.objects = [o for o in scene.objects
                   if o not in scene.lightSources()
                   or o.Label in sources]
  settings = scene.activeSimulationSettings()
  settings.RaysPerIteration = 2048
  settings.EnableStoreSingleShotData = True
  return scene


def test_runner_traces_each_source_through_its_own_mask(tmp_path):
  scene = _maskedScene(H.torchNs(), str(tmp_path / 'masked'))
  runPath = torchSim.runSimulation(scene, 'singletrue', seed=5, device='cpu')
  raw = RawFolder(runPath)
  side = len(raw.loadHits('Side', source='Src'))
  back = len(raw.loadHits('Back', source='Blind'))
  assert back == 2048                       # straight through the mirror
  assert side > 0.9 * 2048                  # folded onto the side detector
  for label, source in (('Side', 'Blind'), ('Back', 'Src')):
    try:
      rows = len(raw.loadHits(label, source=source))
    except (FileNotFoundError, KeyError, ValueError):
      rows = 0
    assert rows == 0, (label, source)


def _countsPerDetector(power, counts):
  return tuple(float(c) for c in counts.sum(axis=(1, 2)))


def test_sweeper_ignores_per_source_masks_like_the_reference(tmp_path):
  '''A one-source scene whose source ignores the fold mirror: both
  packages' `evaluateBatched` still fold the beam onto the side detector.'''
  out = {}
  for label, ns, Sweeper, kw in (
      ('port', H.torchNs(), ParameterSweeper, dict(device='cpu')),
      ('reference', H.jaxNs(), RefSweeper, {})):
    scene = _maskedScene(ns, str(tmp_path / label), sources=('Blind',))
    sweeper = Sweeper(
        lambda sc: dict(r=(sc.getObject('Fold'), 'Reflectivity')),
        scene=scene, **kw)
    out[label] = sweeper.evaluateBatched(
        [dict(r=0.9), dict(r=0.95)], _countsPerDetector, raysPerScene=512,
        maxIntersections=4, bins=(16, 16), histBounds=BOUNDS)
    if label == 'port':
      assert sweeper.lastBatchedRoute == 'sweep'
      scene.lightSources()[0].IgnoredOpticalElements = []
      unmasked = sweeper.evaluateBatched(
          [dict(r=0.9), dict(r=0.95)], _countsPerDetector, raysPerScene=512,
          maxIntersections=4, bins=(16, 16), histBounds=BOUNDS)
      np.testing.assert_array_equal(out[label], unmasked)
  for label in ('port', 'reference'):
    side, back = out[label][0]
    assert side > 0.9 * 512 and back == 0, (label, out[label])


def test_sequential_sweep_keeps_the_stage_gate(tmp_path):
  '''A sequential scene whose stages leave the ball out ([Det] only): the
  sweep kernel is not used (as the reference's refuses `seqMask`), each
  variant is one launch of the histogram kernel with the gate, so the ball's
  index does not matter and no ray is focused.'''
  ns = H.torchNs()
  scene, _, _ = H.buildSequentialBallScene(ns)
  scene.path = str(tmp_path / 'seq')
  settings = scene.activeSimulationSettings()
  sweeper = ParameterSweeper(
      lambda sc: dict(n=(sc.getObject('Ball'), 'RefractiveIndex')),
      scene=scene, device='cpu')
  kw = dict(raysPerScene=1024, maxIntersections=5, bins=(32, 32),
            histBounds=(-80., 80., -80., 80.))
  sets = [dict(n=1.5), dict(n=1.7)]
  focused = sweeper.evaluateBatched(sets, H.spotMetric, **kw)
  assert sweeper.lastBatchedRoute == 'perVariant'
  settings.SequentialModeElements = [['Det']]
  gated = sweeper.evaluateBatched(sets, H.spotMetric, **kw)
  assert sweeper.lastBatchedRoute == 'perVariant'
  assert gated[0] == gated[1]
  assert gated[0] > 2 * min(focused) and gated[0] not in focused


def test_compile_mode_does_not_follow_the_wall_clock(monkeypatch):
  '''Machine load stops the main thread without spending its CPU time. A
  density whose analytic inverse fits the compile's CPU budget stays
  analytic however much wall time passes (here the wall clock runs 15 s
  ahead at every reading) and draws what it draws on an idle machine; a
  wall-clock limit used to flip it to numeric mode, whose draws differ.'''
  import time
  from optics_design_workbench_tpu_torch.distributions import \
      random_variables as RV

  def compiled():
    v = RV.ScalarRandomVariable('1 + x', (0., 2.), variable='x')
    v.compile()
    return v

  idle = compiled()
  real, ticks = time.time, [0]

  def ahead():
    ticks[0] += 1
    return real() + 15. * ticks[0]

  with monkeypatch.context() as m:
    m.setattr(RV.time, 'time', ahead)
    loaded = compiled()
  assert idle.mode() == loaded.mode() == 'analytic'
  np.testing.assert_array_equal(
      idle.draw(N=64, rng=np.random.default_rng(1)),
      loaded.draw(N=64, rng=np.random.default_rng(1)))


def test_more_stages_than_the_bitmask_holds_are_refused_by_name():
  '''More stages than a float32 bitmask held (24) run (ROADMAP C.2): the
  stage words of each surface are ceil(stages / 32) uint32 words; what is
  refused by name is a table past a thread block's shared memory.'''
  scene, _, _ = H.buildSequentialBallScene(H.torchNs())
  settings = scene.activeSimulationSettings()
  settings.SequentialModeElements = [['Ball']] * 40 + [['Det']]
  dev, _info = scene.compile(device=None)
  assert dev['seqMask'].shape[0] == 41
  assert cuda_trace.eligible(dev)
  spec = dict(elemToDet=np.array([-1, 0]), bounds=np.zeros((1, 4)),
              bins=(8, 8))
  tables = cuda_trace.buildTraceTables(dev, spec, device='cpu')
  S = tables['nSurf']
  words = tables['table'].numpy()[-2 * S:].view(np.uint32).reshape(S, 2)
  # the detector (stage 40) and the ball (stages 0-39), sorted by kind
  assert words.tolist() == [[0, 0x100], [0xffffffff, 0xff]]
  seq = np.ones((1_000_000, S), bool)
  seq[0, 0] = False                  # a gate: the words are in the table
  huge = dict(dev, seqMask=seq)
  assert cuda_trace.eligible(huge)
  with pytest.raises(ValueError, match='shared memory'):
    cuda_trace.buildTraceTables(huge, spec, device='cpu')


def test_thirty_stages_match_reference_fused_step():
  '''30 sequential stages (`buildManyStagesScene`: 29 Vacuum planes, an
  absorbing strip allowed at stages 3 and 27, the detector last), past the
  24 of the former float32 bitmask: the plain version against the JAX
  package's XLA fused step on the same ray columns, counters equal and
  counts bin for bin; the strip stops the rays at stage 27.'''
  from optics_design_workbench_tpu_torch import convert
  from optics_design_workbench_tpu_torch.tracing import fused
  scene, bounds, maxI = H.buildManyStagesScene(H.jaxNs())
  H.compileOnce(scene)
  deviceNp, histNp, spec = H.referenceArrays(scene, bounds)
  tables = convert.sceneFromReference(deviceNp, histNp, samplerSpec=spec,
                                      device='cpu')
  assert (tables['nStages'], tables['gate']) == (30, True)
  n = H.N_RAYS
  us = torch.as_tensor(np.random.default_rng(30).random((2, n))
                       .astype(np.float32))
  cols = cuda_trace.sampleRaysPlain(tables, us[0], us[1])
  colsT = torch.stack(list(cols) + [torch.full_like(cols[0], 532.)])
  ref = H.runReferenceColumns(scene, {k: v.numpy() for k, v in
                                      zip(H.COLS, colsT)}, bounds, maxI,
                              withPallas=False)['fused']
  hist = fused.initHistograms(histNp, device='cpu')
  c = cuda_trace.traceHistogram(tables, hist, n, maxI, H.MAX_RAY_LENGTH,
                                H.DIST_TOL, hitSlots=1,
                                columns=colsT.contiguous())
  assert [int(c[0]), int(c[1])] == [ref['counters']['segments'],
                                    ref['counters']['hits']]
  np.testing.assert_array_equal(hist['counts'].numpy(), ref['counts'])
  assert 0.5 * n < int(c[1]) < 0.9 * n      # the strip took its rays
