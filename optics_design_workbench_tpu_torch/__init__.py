'''
optics_design_workbench_tpu_torch — the PyTorch / CUDA port of the optics
ray tracer, for one NVIDIA Hopper card.

Counterpart of `optics_design_workbench_tpu` (the JAX package, which stays
the reference): same sub-package and function names, PyTorch idiom inside.
The sample + trace steps run in hand-written CUDA kernels (csrc/, one shared
body with three output modes — in-kernel histogram, per-ray bins, raw hit
records — and a variant-major sweep of the first; wrapped by
ops/cuda_trace.py); `simulation.runSimulation` drives them and writes the
JAX package's on-disk run-folder layout, and
`jupyter_utils.ParameterSweeper` sweeps and optimises designs over them
(`evaluateBatched`: every variant in one launch); host-side scene
compilation stays numpy / sympy. This package imports torch, never jax, and
nothing of the JAX package.

Device rule: every entry point takes `device=` and defaults to 'cuda'. It
raises when no card is present; the CPU is used only when the caller passes
device='cpu' (as the tests do), and then through the kernel's plain PyTorch
version.
'''

__version__ = '0.1.0'

# sources that shape the compiled kernels: the build directory is keyed by
# a digest of these, so an edited kernel can never load a stale binary. Each
# .cu file becomes one shared library; the header holds their common body.
_KERNEL_SOURCES = ('csrc/trace_common.cuh', 'csrc/trace_kernel.cu',
                   'csrc/trace_bins_kernel.cu', 'csrc/trace_raw_kernel.cu',
                   'csrc/trace_sweep_kernel.cu', 'csrc/trace_kernel_tri.cu',
                   'csrc/trace_bins_kernel_tri.cu',
                   'csrc/trace_raw_kernel_tri.cu',
                   'csrc/trace_sweep_kernel_tri.cu')


def kernelSourceDigest():
  '''Short digest of the CUDA sources; names the first-use build output
  under `_build/` (see _build.buildKernels).'''
  import hashlib
  import os
  base = os.path.dirname(__file__)
  h = hashlib.sha1()
  for rel in _KERNEL_SOURCES:
    with open(os.path.join(base, rel), 'rb') as f:
      h.update(f.read())
  return h.hexdigest()[:10]


class KernelError(RuntimeError):
  '''The card or one of its kernels cannot be used: no CUDA device, no
  `nvcc`, a build that fails, a launch that returns an error. Nothing
  treats it as a bad design point: the optimiser's loops let it through.'''


def resolveDevice(device='cuda'):
  '''The package-wide device rule: returns a torch.device; a CUDA request
  without a card RAISES instead of falling back to the CPU.'''
  import torch
  dev = torch.device(device)
  if dev.type == 'cuda' and not torch.cuda.is_available():
    raise KernelError(
        "device='cuda' requested but no CUDA device is available; pass "
        "device='cpu' explicitly to run the plain PyTorch version")
  return dev


def hostArray(x):
  '''numpy view of a scene-table leaf, whether it is still host numpy or
  already a tensor on some device.'''
  import numpy as np
  import torch
  return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
      else np.asarray(x)


def versionInfo():
  import torch
  return dict(version=__version__, torch=torch.__version__,
              cuda=torch.version.cuda,
              cudaAvailable=torch.cuda.is_available())
