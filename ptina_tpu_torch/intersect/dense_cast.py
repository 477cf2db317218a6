'''
Dense single-pass ray casts: the wavefront integrator's two kernels.

Reference: ptina_tpu/intersect/pallas_cast.py (`_shade_kernel` through
`pallas_cast_shade`, `_any_kernel` through `pallas_cast_any`).

Each cast has a hand-written CUDA kernel (csrc/dense_cast.cu, sm_90a) and
a plain torch version beside it (the hit contract of plucker.py in torch
ops).  The wrapper picks by the tensors' device and nothing else:

  * CPU tensors  -> the plain version;
  * CUDA tensors -> the kernel, or an exception.  There is no fallback.

The kernel library is compiled with nvcc at first use on a CUDA tensor,
from the package's own sources, into build/ptina_tpu_torch/ beside the
package (the file name carries a hash of the sources and flags, so a
stale library is never loaded), and bound with ctypes.  Importing this
module needs neither nvcc nor a GPU.

LAUNCHES counts kernel launches per wrapper (incremented only where a
kernel is launched), so a run can show that its main path went through
the kernels.
'''

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from ptina_tpu_torch.utils.mathutils import INF
from ptina_tpu_torch.intersect.brute import Hit
from ptina_tpu_torch.intersect.plucker import (
    KEY_MISS, N_COEF, key_mask_for, ray_features, pair_hits, pair_keys,
    key_decode_t, winner_uv)

__all__ = ['cast_shade', 'cast_any', 'cast_shade_plain', 'cast_any_plain',
           'build_library', 'LAUNCHES', 'MAX_DENSE_FACES', 'N_ATTR']

MAX_DENSE_FACES = 8192  # reference MAX_VMEM_FACES
N_ATTR = 18             # 3 corners x (nrm3, uv2, mtlid)

LAUNCHES = {'shade': 0, 'any': 0}

_PKG = Path(__file__).resolve().parents[1]
_CSRC = _PKG / 'csrc'
_SOURCES = ('dense_cast.cu', 'plucker.cuh')
_BUILD_DIR = _PKG.parent / 'build' / 'ptina_tpu_torch'
# IEEE f32 throughout: no --use_fast_math (the contract's sign, An * B > 0
# and far-clip tests rely on exact division and denormals), and no FMA
# contraction (--fmad=false): every product and sum rounds as in the plain
# torch version, so kernel and plain agree bit for bit.  With contraction
# the decoded t of grazing rays moved by up to 5.8e-4 relative (H100 run).
_NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
               '-O3', '--fmad=false', '-shared', '-Xcompiler', '-fPIC',
               '-Xptxas', '-v')

# elements per [N, Fc] temporary of the plain casts (bounds their memory)
_PLAIN_PAIRS = 1 << 24


def _nvcc():
    cuda_home = os.environ.get('CUDA_HOME') or os.environ.get('CUDA_PATH') \
        or '/usr/local/cuda'
    cand = shutil.which('nvcc') or os.path.join(cuda_home, 'bin', 'nvcc')
    if not os.path.exists(cand):
        raise RuntimeError('nvcc not found: the CUDA casts are built from '
                           'csrc/ at first use and need the CUDA toolkit')
    return cand


@functools.lru_cache(maxsize=1)
def build_library():
    '''Compile (once per source hash) and load the cast library.  Returns
    (ctypes.CDLL, nvcc log text — empty when an existing build was
    loaded).'''
    h = hashlib.sha256(' '.join(_NVCC_FLAGS).encode())
    for name in _SOURCES:
        h.update((_CSRC / name).read_bytes())
    lib_path = _BUILD_DIR / f'libptina_dense_cast_{h.hexdigest()[:16]}.so'
    log = ''
    if not lib_path.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix='.so', dir=_BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run(
                [_nvcc(), *_NVCC_FLAGS, '-o', tmp,
                 str(_CSRC / 'dense_cast.cu')],
                capture_output=True, text=True, check=False)
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f'nvcc failed ({proc.returncode}):\n{log}')
            os.replace(tmp, lib_path)  # atomic: concurrent builders agree
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    lib = ctypes.CDLL(str(lib_path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ptina_cast_shade.argtypes = [p] * 9 + [i, i, i] + [p] * 7
    lib.ptina_cast_shade.restype = i
    lib.ptina_cast_any.argtypes = [p] * 9 + [i, i] + [p] * 2
    lib.ptina_cast_any.restype = i
    return lib, log


def _check_rays(ro, rd, avoid, extra=()):
    rows = (ro.x, ro.y, ro.z, rd.x, rd.y, rd.z) + tuple(extra)
    n = ro.x.shape[0]
    dev = ro.x.device
    for r in rows:
        if r.dtype != torch.float32 or r.dim() != 1 or r.shape[0] != n:
            raise ValueError('ray rows must be [N] float32')
        if r.device != dev:
            raise ValueError('ray rows must share one device')
    if avoid.dtype != torch.int32 or avoid.shape != (n,) \
            or avoid.device != dev:
        raise ValueError('avoid must be [N] int32 on the rays\' device')
    return n, dev


def _check_table(t, cols, dev, name):
    if t.dtype != torch.float32 or t.dim() != 2 or t.shape[1] != cols:
        raise ValueError(f'{name} must be [F, {cols}] float32')
    if t.device != dev:
        raise ValueError(f'{name} must lie on the rays\' device')
    if t.shape[0] > MAX_DENSE_FACES:
        raise ValueError(f'{t.shape[0]} faces exceed the dense casts\' '
                         f'{MAX_DENSE_FACES}')


def _ptr(t):
    if not t.is_contiguous():
        raise ValueError('kernel operands must be contiguous')
    return ctypes.c_void_p(t.data_ptr())


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _raise_on(err, name):
    if err != 0:
        raise RuntimeError(f'{name} launch failed: cudaError {err}')


def _face_chunk(n, f):
    return max(1, min(f, _PLAIN_PAIRS // max(n, 1)))


def cast_shade_plain(ro, rd, avoid, coef, attr):
    '''Plain torch version of the shade kernel: (Hit, attrs [6, N]).'''
    n, f = ro.x.shape[0], coef.shape[0]
    fid_mask = key_mask_for(f)
    p = ray_features(ro, rd)
    best = torch.full((n,), KEY_MISS, dtype=torch.int32, device=ro.x.device)
    fc = _face_chunk(n, f)
    for base in range(0, f, fc):
        best = torch.minimum(best, pair_keys(p, ro, rd, coef[base:base + fc],
                                             base, avoid, fid_mask))
    hitm = best != KEY_MISS
    w = torch.where(hitm, best & fid_mask, 0).long()
    u, v = winner_uv(p, rd, coef[w])
    a = attr[w]  # [N, 18] corner-major: a[:, k * 6 + c]
    w0 = 1.0 - u - v
    att = (a[:, 0:6] * w0[:, None] + a[:, 6:12] * u[:, None]
           + a[:, 12:18] * v[:, None])
    hit = Hit(hit=hitm,
              t=torch.where(hitm, key_decode_t(best, fid_mask), INF),
              index=torch.where(hitm, best & fid_mask, -1),
              u=torch.where(hitm, u, 0.0), v=torch.where(hitm, v, 0.0))
    return hit, torch.where(hitm[None, :], att.t(), 0.0)


def cast_any_plain(ro, rd, avoid, tmax, coef):
    '''Plain torch version of the occlusion kernel: occ [N] bool, True
    where a valid hit lies at t < min(tmax, INF).'''
    n, f = ro.x.shape[0], coef.shape[0]
    p = ray_features(ro, rd)
    occ = torch.zeros(n, dtype=torch.bool, device=ro.x.device)
    fc = _face_chunk(n, f)
    for base in range(0, f, fc):
        valid, ts, _ = pair_hits(p, ro, rd, coef[base:base + fc], base, avoid)
        occ = occ | torch.any(valid & (ts < INF) & (ts < tmax[:, None]),
                              dim=1)
    return occ


def cast_shade(ro, rd, avoid, coef, attr):
    '''Closest hit + interpolated corner attributes.  ro, rd: V3 of [N]
    float32 rows; avoid [N] int32 (-1 = none); coef [F, 16] and attr
    [F, 18] from plucker.pack_faces.  Returns (Hit, attrs [6, N]:
    nrm.xyz, uv.xy, mtlid; zeros on a miss).'''
    n, dev = _check_rays(ro, rd, avoid)
    _check_table(coef, N_COEF, dev, 'coef')
    _check_table(attr, N_ATTR, dev, 'attr')
    if dev.type == 'cpu':
        return cast_shade_plain(ro, rd, avoid, coef, attr)
    if dev.type != 'cuda':
        raise ValueError(f'no cast for device {dev}')
    f = coef.shape[0]
    t = torch.empty(n, dtype=torch.float32, device=dev)
    idx = torch.empty(n, dtype=torch.int32, device=dev)
    hit = torch.empty(n, dtype=torch.bool, device=dev)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    attrs = torch.empty((6, n), dtype=torch.float32, device=dev)
    if n:
        if coef.data_ptr() % 16:
            raise ValueError('coef must be 16-byte aligned')
        lib, _ = build_library()
        err = lib.ptina_cast_shade(
            _ptr(ro.x), _ptr(ro.y), _ptr(ro.z), _ptr(rd.x), _ptr(rd.y),
            _ptr(rd.z), _ptr(avoid), _ptr(coef), _ptr(attr), n, f,
            key_mask_for(f), _ptr(t), _ptr(idx), _ptr(hit), _ptr(u),
            _ptr(v), _ptr(attrs), _stream())
        _raise_on(err, 'shade_kernel')
        LAUNCHES['shade'] += 1
    return Hit(hit=hit, t=t, index=idx, u=u, v=v), attrs


def cast_any(ro, rd, avoid, tmax, coef):
    '''Occlusion cast: [N] bool, True where a face other than avoid is hit
    at t < min(tmax, INF).  coef [F, 16] from plucker.pack_faces.'''
    n, dev = _check_rays(ro, rd, avoid, extra=(tmax,))
    _check_table(coef, N_COEF, dev, 'coef')
    if dev.type == 'cpu':
        return cast_any_plain(ro, rd, avoid, tmax, coef)
    if dev.type != 'cuda':
        raise ValueError(f'no cast for device {dev}')
    occ = torch.empty(n, dtype=torch.bool, device=dev)
    if n:
        if coef.data_ptr() % 16:
            raise ValueError('coef must be 16-byte aligned')
        lib, _ = build_library()
        err = lib.ptina_cast_any(
            _ptr(ro.x), _ptr(ro.y), _ptr(ro.z), _ptr(rd.x), _ptr(rd.y),
            _ptr(rd.z), _ptr(avoid), _ptr(tmax), _ptr(coef), n,
            coef.shape[0], _ptr(occ), _stream())
        _raise_on(err, 'any_kernel')
        LAUNCHES['any'] += 1
    return occ
