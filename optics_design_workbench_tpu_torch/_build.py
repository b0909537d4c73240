'''
First-use build of the CUDA kernels: `nvcc` compiles each csrc/*.cu for
sm_90a into a shared library with a plain C interface under
`_build/<digest>/` (git-ignored), loaded with ctypes. The digest covers the sources and the
compiler flags, so editing a kernel rolls the build over. No PyTorch headers
are included by the kernels, which keeps a build at a few seconds.
'''

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

from . import KernelError, _KERNEL_SOURCES, kernelSourceDigest

# -fmad=false: the kernel rounds every multiply and add separately, exactly
# like the plain PyTorch version it is held against (eager tensor ops never
# contract a*b+c). With contraction on, a hit one ulp from a trim edge or a
# bin edge lands differently in the two versions.
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-fmad=false', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_loaded = {}


def _findNvcc():
  nvcc = shutil.which('nvcc')
  if nvcc is None:
    for cand in (os.path.join(os.environ.get('CUDA_HOME', ''), 'bin', 'nvcc'),
                 '/usr/local/cuda/bin/nvcc'):
      if os.path.isfile(cand):
        nvcc = cand
        break
  if nvcc is None:
    raise KernelError('nvcc not found: the CUDA kernels build at first use '
                      'and need the CUDA toolkit (nvcc on PATH, or CUDA_HOME)')
  return nvcc


def buildDir(flags):
  base = os.path.dirname(__file__)
  key = hashlib.sha1((kernelSourceDigest() + ' '.join(flags)).encode())
  return os.path.join(base, '_build', key.hexdigest()[:12])


def buildKernels(flags=None):
  '''Compile (once per source digest) and load the kernel libraries.
  Returns (libs, info): libs maps a source's stem ('trace_kernel',
  'trace_bins_kernel', 'trace_raw_kernel', 'trace_sweep_kernel' and their
  '_tri' twins) to its ctypes library, info =
  dict(path, seconds, log, cached), `log` nvcc's output of the build that
  made these libraries. One nvcc process per .cu source, all
  started together; a failed build raises with nvcc's output. `flags`
  defaults to NVCC_FLAGS (read at call time).'''
  flags = tuple(NVCC_FLAGS if flags is None else flags)
  if flags in _loaded:
    return _loaded[flags]
  base = os.path.dirname(__file__)
  out = buildDir(flags)
  os.makedirs(out, exist_ok=True)
  t0 = time.time()
  jobs, logs, cached = [], [], True
  stems = [os.path.splitext(os.path.basename(rel))[0]
           for rel in _KERNEL_SOURCES if rel.endswith('.cu')]
  for stem in stems:
    src = os.path.join(base, 'csrc', stem + '.cu')
    lib = os.path.join(out, f'lib{stem}.so')
    if not os.path.isfile(lib):
      cached = False
      tmp = lib + f'.tmp{os.getpid()}'
      cmd = [_findNvcc(), *flags, '-o', tmp, src]
      jobs.append((cmd, tmp, lib, subprocess.Popen(
          cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
  for cmd, tmp, lib, proc in jobs:
    log, _ = proc.communicate()
    logs.append(log)
    if proc.returncode != 0:
      raise KernelError(f'nvcc failed ({proc.returncode}): {" ".join(cmd)}\n'
                        f'{log}')
    os.replace(tmp, lib)            # atomic: concurrent builds never race
  libs = {stem: ctypes.CDLL(os.path.join(out, f'lib{stem}.so'))
          for stem in stems}
  # nvcc's output (ptxas's registers and spills per instance) is kept
  # beside the libraries, so a cached build reports it too
  logPath = os.path.join(out, 'build.log')
  if logs:
    with open(logPath + f'.tmp{os.getpid()}', 'w') as f:
      f.write('\n'.join(logs))
    os.replace(logPath + f'.tmp{os.getpid()}', logPath)
  log = ''
  if os.path.isfile(logPath):
    with open(logPath) as f:
      log = f.read()
  info = dict(path=out, seconds=time.time() - t0, log=log, cached=cached)
  _loaded[flags] = (libs, info)
  return _loaded[flags]
