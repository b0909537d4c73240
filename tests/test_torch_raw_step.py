'''The PyTorch port's raw-record step (ops/cuda_trace.traceRaw, the module
that holds the raw-record CUDA kernel) against the JAX package's
`makePallasRawStep` on the same numpy-seeded inputs.

On the CPU the port runs the kernel's plain PyTorch version; the JAX kernel
runs in Mosaic interpret mode as tests/test_pallas_interpret.py runs it.
Mode (c): numpy-made ray columns go into both. Mode (b): both in-kernel
samplers are fed the uniforms the JAX step draws for its
`uniformProvider='input'` seam (that step applies no tile strata).

Tolerances: segment / hit / overflow counters equal; the hit multisets
(element, point, direction, power, isEntering, as the reference suite
builds them) equal in shape, and equal row for row — same ray, same ring
slot — within atol 1e-4 (mm, unit power: the reference suite's own
tolerance for raw rows — float op order differs by an ulp between XLA
fusions and eager torch).
'''

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (both frameworks live in this process)

import torch_port_helpers as H
from optics_design_workbench_tpu_torch import convert
from optics_design_workbench_tpu_torch.ops import cuda_trace
from optics_design_workbench_tpu_torch.simulation import runner as torchRunner

torch.set_num_threads(1)

ROW_ATOL = 1e-4

# (scene, hitSlots): the one-slot case exercises the ring's overflow rule
CASES = (('lensMirror', 'auto'), ('absorbing', 'auto'), ('absorbing', 1),
         ('stacked', 'auto'))


def _portRecords(tables, maxI, hitSlots, **inputs):
  ring, c = cuda_trace.traceRaw(tables, H.N_RAYS, maxI, H.MAX_RAY_LENGTH,
                                H.DIST_TOL, hitSlots=hitSlots, **inputs)
  return (convert.recordsToNumpy(cuda_trace.recordsFromRing(ring)),
          dict(segments=int(c[0]), hits=int(c[1]), hitOverflow=int(c[2])))


@pytest.fixture(scope='module', params=CASES,
                ids=lambda c: f'{c[0]}-{c[1]}')
def rawCase(request):
  '''One scene and slot count, both modes: the JAX raw step's records and
  the port's on the same inputs (JAX steps built once per module).'''
  name, slots = request.param
  scene, bounds, maxI = H.SCENES_BY_NAME[name](H.jaxNs())
  deviceNp, histNp, spec = H.referenceArrays(scene, bounds)
  tables = convert.sceneFromReference(deviceNp, histNp, samplerSpec=spec,
                                      device='cpu')
  hitSlots = (cuda_trace.autoHitSlots(deviceNp, histNp, maxI)
              if slots == 'auto' else slots)
  rng = np.random.default_rng(20261016)
  u = torch.as_tensor(rng.random((2, H.N_RAYS), dtype=np.float32))
  cols = cuda_trace.sampleRaysPlain(tables, u[0], u[1])
  colsT = torch.stack(list(cols) + [torch.full_like(cols[0], 532.)])
  colsNp = {k: colsT[i].numpy().copy() for i, k in enumerate(H.COLS)}
  out = dict(name=name, slots=slots, hitSlots=hitSlots)
  refC = H.runReferenceRaw(scene, bounds, maxI, hitSlots=slots,
                           colsNp=colsNp)
  out['columns'] = dict(ref=refC[:2], port=_portRecords(
      tables, maxI, hitSlots, columns=colsT.contiguous()))
  refU = H.runReferenceRaw(scene, bounds, maxI, hitSlots=slots)
  out['uniforms'] = dict(ref=refU[:2], port=_portRecords(
      tables, maxI, hitSlots, uniforms=torch.as_tensor(refU[2])))
  out['labels'] = refC[3]
  return out


@pytest.mark.parametrize('mode', ('columns', 'uniforms'))
def test_raw_counters_equal(rawCase, mode):
  (_, refC), (_, portC) = rawCase[mode]['ref'], rawCase[mode]['port']
  for k in ('segments', 'hits', 'hitOverflow'):
    assert portC[k] == refC[k], k
  assert portC['hits'] > H.N_RAYS // 4


@pytest.mark.parametrize('mode', ('columns', 'uniforms'))
def test_raw_hit_multisets_match(rawCase, mode):
  (refR, _), (portR, _) = rawCase[mode]['ref'], rawCase[mode]['port']
  rRef, rPort = H.hitRowset(refR), H.hitRowset(portR)
  assert rPort.shape == rRef.shape
  # The rows are compared ray by ray and slot by slot, which implies the
  # multisets agree: sorting first (as the reference suite does on a scene
  # whose leading coordinate is exact) pairs the wrong rows where that
  # coordinate differs by an ulp between the two sides.
  m = refR['recordHit']
  np.testing.assert_array_equal(portR['recordHit'], m)
  for k in ('hitElem', 'isEntering'):
    np.testing.assert_array_equal(portR[k][m], refR[k][m], err_msg=k)
  for k in ('point', 'direction', 'power'):
    np.testing.assert_allclose(portR[k][m], refR[k][m], rtol=0.,
                               atol=ROW_ATOL, err_msg=k)


@pytest.mark.parametrize('mode', ('columns', 'uniforms'))
def test_raw_records_have_the_reference_layout(rawCase, mode):
  (refR, _), (portR, _) = rawCase[mode]['ref'], rawCase[mode]['port']
  assert set(portR) == set(refR)
  for k in refR:
    assert portR[k].shape == refR[k].shape, k
    assert portR[k].dtype == refR[k].dtype, k
  # same slot for the same ray: the ring fills in hit order on both sides
  np.testing.assert_array_equal(portR['recordHit'], refR['recordHit'])
  np.testing.assert_array_equal(portR['hitElem'], refR['hitElem'])


def test_raw_scene_branches_are_exercised(rawCase):
  name, slots = rawCase['name'], rawCase['slots']
  _, c = rawCase['columns']['port']
  n = H.N_RAYS
  if name == 'stacked':
    assert rawCase['hitSlots'] == 4
    assert c['hits'] == 4 * n and c['hitOverflow'] == 0   # two passes each
  elif name == 'absorbing' and slots == 1:
    assert c['hits'] == n and c['hitOverflow'] == n       # 2nd overwrites 1st
  elif name == 'absorbing':
    assert c['hits'] == 2 * n and c['hitOverflow'] == 0
  else:
    assert 0.9 * n < c['hits'] <= n


def test_raw_overflow_keeps_the_last_pass():
  '''With one slot on the two-pass scene the kept row is the LATER pass:
  weaker (slab, mirror) and travelling back towards the source; with two
  slots the first slot holds the outbound pass.'''
  from optics_design_workbench_tpu_torch.tracing import fused
  scene, bounds, maxI = H.buildAbsorbingScene(H.torchNs())
  sceneNp, info = scene.compile(device=None)
  histSpec = fused.makeHistogramSpec(sceneNp, info, bounds=bounds,
                                     bins=H.BINS)
  tables = cuda_trace.buildTraceTables(
      sceneNp, histSpec, samplerSpec=scene.lightSources()[0].samplerSpec(),
      device='cpu')
  us = torch.as_tensor(np.random.default_rng(5).random(
      (2, H.N_RAYS), dtype=np.float32))
  one, cOne = _portRecords(tables, maxI, 1, uniforms=us)
  two, cTwo = _portRecords(tables, maxI, 2, uniforms=us)
  assert cOne['hitOverflow'] == H.N_RAYS and cTwo['hitOverflow'] == 0
  assert one['recordHit'].all() and two['recordHit'].all()
  assert (one['direction'][..., 2] < 0).all()
  assert (two['direction'][0, :, 2] > 0).all()
  np.testing.assert_array_equal(one['power'][0], two['power'][1])
  np.testing.assert_array_equal(one['point'][0], two['point'][1])
  # outbound: ~exp(-10 / 20) = 0.61 after the slab; back: x 0.9 (mirror)
  assert one['power'].max() < 0.575 < two['power'][0].min()


@pytest.mark.parametrize('convertFn', ('compactRecordsToHits',
                                       'recordsToHits'))
def test_record_converters_match_the_reference(rawCase, convertFn):
  '''(c) of the slice: the port's record -> per-element hit converters
  against the JAX package's on the SAME records (the JAX step's, carried
  across by `convert`): same element labels, same columns, equal multisets
  (row order within an element is not part of the contract). Exact: both
  only move float32 values.'''
  from optics_design_workbench_tpu.simulation import runner as jaxRunner
  refR, _ = rawCase['columns']['ref']
  labels = rawCase['labels']
  ref = getattr(jaxRunner, convertFn)(refR, {}, labels)
  port = getattr(torchRunner, convertFn)(
      convert.recordsFromReference(refR, device='cpu'), {}, labels)
  assert set(port) == set(ref) and ref

  def rows(cols):
    a = np.concatenate([np.asarray(cols['points']),
                        np.asarray(cols['directions']),
                        np.asarray(cols['powers'])[:, None],
                        np.asarray(cols['isEntering'])[:, None]
                        .astype(float)], axis=1)
    return a[np.lexsort(a.T[::-1])]

  for label in ref:
    assert set(port[label]) == set(ref[label])
    for k in ref[label]:
      assert port[label][k].dtype == np.asarray(ref[label][k]).dtype, k
    np.testing.assert_array_equal(rows(port[label]), rows(ref[label]))
