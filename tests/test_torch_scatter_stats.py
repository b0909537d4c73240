'''The seed-mode statistics of the conditioned-Dirac scatter scene: the JAX
package's fused step at 65,536 rays (seed 0) gives the constants
chip_smoke.py holds the card's runs to (REF_SCATTER['dirac']), and the
port's fused step on the CPU (its own draws) agrees with them within 3
sigma.'''

import pytest
import torch

import torch_port_helpers as H

torch.set_num_threads(1)

REF_RAYS = 1 << 16
# chip_smoke.py REF_SCATTER['dirac']
REF_DIRAC = dict(share=0.9994354248046875, power=1.0, r2=71.26806608569406,
                 r4=44136.73619874265)


def test_fused_step_statistics_agree_with_reference():
  scene, _bounds, _maxI = H.buildScatterScene(H.jaxNs(), 'dirac')
  H.compileOnce(scene)
  ref = H.scatterStatsOfReference('dirac', REF_RAYS, scene=scene)
  for k, v in REF_DIRAC.items():
    assert ref[k] == pytest.approx(v, abs=1e-9), k
  H.assertScatterStatsAgree(H.portScatterStats(scene, REF_RAYS), ref,
                            REF_RAYS, REF_RAYS)
