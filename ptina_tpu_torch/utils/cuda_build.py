'''
Build a CUDA source of the package into a shared library with nvcc, at
first use, and load it with ctypes.

Shared by every kernel library of the port (intersect/dense_cast.py,
engine/fused.py).  The library goes into build/ptina_tpu_torch/ beside the
package; its file name carries a hash of the sources and the flags, so a
stale library is never loaded, and it is renamed into place atomically,
so concurrent builds agree.  nvcc comes from PATH, else CUDA_HOME /
CUDA_PATH / /usr/local/cuda.  Importing this module needs neither nvcc nor
a GPU.
'''

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

__all__ = ['NVCC_FLAGS', 'CSRC', 'BUILD_DIR', 'build_shared_library', 'ptr',
           'stream_ptr', 'raise_on']

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / 'csrc'
BUILD_DIR = PKG.parent / 'build' / 'ptina_tpu_torch'

# IEEE f32 throughout: no --use_fast_math (the hit contract's sign,
# An * B > 0 and far-clip tests rely on exact division and denormals), and
# no FMA contraction (--fmad=false): every product and sum rounds as in
# the plain torch versions, whose elementwise ops never contract.
# -Xptxas -v puts each kernel's registers, spills and shared memory in
# the build log.
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '--fmad=false', '-shared', '-Xcompiler', '-fPIC',
              '-Xptxas', '-v')


def _nvcc():
    cuda_home = os.environ.get('CUDA_HOME') or os.environ.get('CUDA_PATH') \
        or '/usr/local/cuda'
    cand = shutil.which('nvcc') or os.path.join(cuda_home, 'bin', 'nvcc')
    if not os.path.exists(cand):
        raise RuntimeError('nvcc not found: the CUDA kernels are built from '
                           'csrc/ at first use and need the CUDA toolkit')
    return cand


def build_shared_library(stem, main, sources, flags=NVCC_FLAGS):
    '''Compile csrc/<main> (sources: every csrc file it includes, main
    first) into build/ptina_tpu_torch/lib<stem>_<hash>.so unless that
    file exists, and load it.  Returns (ctypes.CDLL, nvcc log text —
    empty when an existing build was loaded).  Raises RuntimeError with
    the log when nvcc fails.'''
    h = hashlib.sha256(' '.join(flags).encode())
    for name in sources:
        h.update((CSRC / name).read_bytes())
    lib_path = BUILD_DIR / f'lib{stem}_{h.hexdigest()[:16]}.so'
    log = ''
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run(
                [_nvcc(), *flags, '-o', tmp, str(CSRC / main)],
                capture_output=True, text=True, check=False)
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f'nvcc failed ({proc.returncode}):\n{log}')
            os.replace(tmp, lib_path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return ctypes.CDLL(str(lib_path)), log


def ptr(t):
    '''A contiguous tensor's device address as a ctypes argument.'''
    if not t.is_contiguous():
        raise ValueError('kernel operands must be contiguous')
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr():
    '''PyTorch's current CUDA stream as a ctypes argument.'''
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def raise_on(err, name):
    '''Raise on the cudaGetLastError() code a launcher returned.'''
    if err != 0:
        raise RuntimeError(f'{name} launch failed: cudaError {err}')
