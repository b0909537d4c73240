'''ROADMAP C.2: more than 64 surfaces and 16 elements in one scene, held
against the JAX package on the same ray columns; 257 plain discs are
eligible (the surface table), and the caps that remain (256 surfaces that
stay surface rows, stage gates and source masks past 256 analytic surfaces,
a table that fits a block's shared memory) refuse by name.'''

import numpy as np
import pytest
import torch

import torch_port_helpers as H

torch.set_num_threads(1)

N = 4096


def test_many_surfaces_and_elements_match_reference():
  '''72 surfaces, 22 elements (20 glass slabs, an 11-disc baffle, the
  detector): the port's plain version against the JAX package's XLA fused
  step and its Pallas kernel (interpret mode) on the same columns: counters
  equal, counts equal bin for bin.'''
  from optics_design_workbench_tpu_torch import convert
  from optics_design_workbench_tpu_torch.ops import cuda_trace
  from optics_design_workbench_tpu_torch.tracing import fused
  scene, bounds, maxI = H.buildManySurfacesScene(H.jaxNs())
  H.compileOnce(scene)
  deviceNp, histNp, spec = H.referenceArrays(scene, bounds)
  tables = convert.sceneFromReference(deviceNp, histNp, samplerSpec=spec,
                                      device='cpu')
  assert (tables['nSurf'], tables['nElem']) == (72, 22)
  us = torch.rand((2, N), generator=torch.Generator().manual_seed(5))
  cols = cuda_trace.sampleRaysPlain(tables, us[0], us[1])
  colsT = torch.stack(list(cols) + [torch.full_like(cols[0], 532.)])
  ref = H.runReferenceColumns(
      scene, {k: v.numpy() for k, v in zip(H.COLS, colsT)}, bounds, maxI)
  hist = fused.initHistograms(histNp, device='cpu')
  c = cuda_trace.traceHistogram(tables, hist, N, maxI, H.MAX_RAY_LENGTH,
                                H.DIST_TOL, hitSlots=1,
                                columns=colsT.contiguous())
  for name, r in ref.items():
    assert [int(c[0]), int(c[1])] == [r['counters']['segments'],
                                      r['counters']['hits']], name
    np.testing.assert_array_equal(hist['counts'].numpy(), r['counts'],
                                  err_msg=name)
  # the slabs and the baffle took part: some rays stopped at the baffle,
  # every ray crossed a slab or passed between them
  assert 0 < int(c[1]) < N and int(c[0]) > 2 * N


def test_remaining_caps_refuse_by_name():
  from optics_design_workbench_tpu_torch.ops import cuda_trace
  histSpec = dict(elemToDet=np.array([0]), bounds=np.zeros((1, 4)),
                  bins=(8, 8))
  elems = lambda E: dict(packed=np.zeros((E, 11), np.float32),
                         optType=np.full(E, 3, np.int32),
                         recordHits=np.zeros(E, bool))
  S = cuda_trace.MAX_SURFACES + 1
  planes = lambda trim0: dict(
      packed=np.zeros((S, 24), np.float32),
      trim=np.tile(np.float32([trim0, 0., 1., 0., 0., 0.]), (S, 1)),
      kind=np.zeros(S, np.int32), trimPrims=np.zeros((S, 4, 7), np.float32))
  # 257 plain discs ride the surface table (ROADMAP B8)
  many = dict(surfaces=planes(0.), elements=elems(1))
  assert cuda_trace.ineligibleReason(many) is None
  assert cuda_trace.tableSurfaces(many).all()
  # what the reference refuses past 256 analytic surfaces: more than 256
  # rows that stay surface rows, and stage gates or source masks
  complexRows = dict(many, surfaces=planes(3.))
  assert ('257 analytic surfaces with bitmap/prim trims or iterative kinds '
          '> the 256-surface immediates budget'
          in cuda_trace.ineligibleReason(complexRows))
  for key, mask in (('surfMask', np.ones(S, bool)),
                    ('seqMask', np.ones((2, S), bool))):
    assert ('257 analytic surfaces with sequential mode or a per-source '
            'ignore mask' in cuda_trace.ineligibleReason(
                dict(many, **{key: mask})))
  E = cuda_trace.MAX_TABLE_BYTES // (4 * cuda_trace.ELEM_COLS) + 1
  huge = dict(surfaces=dict(packed=np.zeros((1, 24), np.float32),
                            trim=np.zeros((1, 6), np.float32),
                            kind=np.zeros(1, np.int32)),
              elements=elems(E))
  assert cuda_trace.ineligibleReason(huge) is None
  with pytest.raises(ValueError, match='shared memory'):
    cuda_trace.buildTraceTables(
        huge, dict(histSpec, elemToDet=np.full(E, -1)), device='cpu')
