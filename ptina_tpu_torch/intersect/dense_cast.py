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
package (utils/cuda_build.py: the file name carries a hash of the sources
and flags, so a stale library is never loaded), and bound with ctypes.
It is built with --fmad=false, so the kernels round every product and
sum as the plain versions do and agree with them bit for bit (with FMA
contraction the decoded t of grazing rays moved by up to 5.8e-4 relative
on the H100).  Importing this module needs neither nvcc nor a GPU.

LAUNCHES counts kernel launches per wrapper (incremented only where a
kernel is launched), so a run can show that its main path went through
the kernels.
'''

import ctypes
import functools

import torch

from ptina_tpu_torch.utils.mathutils import INF
from ptina_tpu_torch.utils.cuda_build import (build_shared_library, ptr,
                                              raise_on, stream_ptr)
from ptina_tpu_torch.intersect.brute import Hit
from ptina_tpu_torch.intersect.plucker import (
    KEY_MISS, N_COEF, key_mask_for, ray_features, pair_hits, pair_keys,
    key_decode_t, winner_uv)

__all__ = ['cast_shade', 'cast_any', 'cast_shade_plain', 'cast_any_plain',
           'build_library', 'LAUNCHES', 'MAX_DENSE_FACES', 'N_ATTR']

MAX_DENSE_FACES = 8192  # reference MAX_VMEM_FACES
N_ATTR = 18             # 3 corners x (nrm3, uv2, mtlid)

LAUNCHES = {'shade': 0, 'any': 0}

_SOURCES = ('dense_cast.cu', 'plucker.cuh')

# elements per [N, Fc] temporary of the plain casts (bounds their memory)
_PLAIN_PAIRS = 1 << 24


@functools.lru_cache(maxsize=1)
def build_library():
    '''Compile (once per source hash; utils/cuda_build.py) and load the
    cast library.  Returns (ctypes.CDLL, nvcc log text — empty when an
    existing build was loaded).'''
    lib, log = build_shared_library('ptina_dense_cast', _SOURCES[0],
                                    _SOURCES)
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
            ptr(ro.x), ptr(ro.y), ptr(ro.z), ptr(rd.x), ptr(rd.y),
            ptr(rd.z), ptr(avoid), ptr(coef), ptr(attr), n, f,
            key_mask_for(f), ptr(t), ptr(idx), ptr(hit), ptr(u),
            ptr(v), ptr(attrs), stream_ptr())
        raise_on(err, 'shade_kernel')
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
            ptr(ro.x), ptr(ro.y), ptr(ro.z), ptr(rd.x), ptr(rd.y),
            ptr(rd.z), ptr(avoid), ptr(tmax), ptr(coef), n,
            coef.shape[0], ptr(occ), stream_ptr())
        raise_on(err, 'any_kernel')
        LAUNCHES['any'] += 1
    return occ
