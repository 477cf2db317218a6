'''
Dense single-pass ray casts: the wavefront integrator's two kernels, and
the table-level closest cast.

Reference: ptina_tpu/intersect/pallas_cast.py (`_shade_kernel` through
`pallas_cast_shade`, `_any_kernel` through `pallas_cast_any`,
`_closest_kernel` through `pallas_cast_closest`).

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
    KEY_MISS, N_ATTR, N_COEF, check_rays, check_table, face_chunk,
    key_mask_for, ray_features, pair_hits, pair_keys, key_decode_t,
    winner_hit)

__all__ = ['cast_shade', 'cast_any', 'cast_closest', 'cast_shade_plain',
           'cast_any_plain', 'cast_closest_plain', 'build_library',
           'LAUNCHES', 'MAX_DENSE_FACES', 'N_ATTR']

MAX_DENSE_FACES = 8192  # reference MAX_VMEM_FACES

LAUNCHES = {'shade': 0, 'any': 0, 'closest': 0}

_SOURCES = ('dense_cast.cu', 'plucker.cuh')


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
    lib.ptina_cast_closest.argtypes = [p] * 8 + [i, i, i] + [p] * 6
    lib.ptina_cast_closest.restype = i
    return lib, log


def _best_keys(ro, rd, avoid, coef):
    n, f = ro.x.shape[0], coef.shape[0]
    fid_mask = key_mask_for(f)
    p = ray_features(ro, rd)
    best = torch.full((n,), KEY_MISS, dtype=torch.int32, device=ro.x.device)
    fc = face_chunk(n, f)
    for base in range(0, f, fc):
        best = torch.minimum(best, pair_keys(p, ro, rd, coef[base:base + fc],
                                             base, avoid, fid_mask))
    return p, best, fid_mask


def cast_shade_plain(ro, rd, avoid, coef, attr):
    '''Plain torch version of the shade kernel: (Hit, attrs [6, N]).'''
    p, best, fid_mask = _best_keys(ro, rd, avoid, coef)
    return winner_hit(p, rd, coef, attr, best != KEY_MISS, best & fid_mask,
                      key_decode_t(best, fid_mask))


def cast_closest_plain(ro, rd, avoid, coef):
    '''Plain torch version of the closest kernel: Hit.'''
    p, best, fid_mask = _best_keys(ro, rd, avoid, coef)
    return winner_hit(p, rd, coef, None, best != KEY_MISS, best & fid_mask,
                      key_decode_t(best, fid_mask))


def cast_any_plain(ro, rd, avoid, tmax, coef):
    '''Plain torch version of the occlusion kernel: occ [N] bool, True
    where a valid hit lies at t < min(tmax, INF).'''
    n, f = ro.x.shape[0], coef.shape[0]
    p = ray_features(ro, rd)
    occ = torch.zeros(n, dtype=torch.bool, device=ro.x.device)
    fc = face_chunk(n, f)
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
    n, dev = check_rays(ro, rd, avoid)
    check_table(coef, N_COEF, dev, 'coef', MAX_DENSE_FACES)
    check_table(attr, N_ATTR, dev, 'attr', MAX_DENSE_FACES)
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
    n, dev = check_rays(ro, rd, avoid, extra=(tmax,))
    check_table(coef, N_COEF, dev, 'coef', MAX_DENSE_FACES)
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


def cast_closest(ro, rd, avoid, coef):
    '''Closest hit without attributes: Hit (t INF, index -1 and u, v 0 on a
    miss).  coef [F, 16] from plucker.pack_faces.'''
    n, dev = check_rays(ro, rd, avoid)
    check_table(coef, N_COEF, dev, 'coef', MAX_DENSE_FACES)
    if dev.type == 'cpu':
        return cast_closest_plain(ro, rd, avoid, coef)
    if dev.type != 'cuda':
        raise ValueError(f'no cast for device {dev}')
    f = coef.shape[0]
    t = torch.empty(n, dtype=torch.float32, device=dev)
    idx = torch.empty(n, dtype=torch.int32, device=dev)
    hit = torch.empty(n, dtype=torch.bool, device=dev)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    if n:
        if coef.data_ptr() % 16:
            raise ValueError('coef must be 16-byte aligned')
        lib, _ = build_library()
        err = lib.ptina_cast_closest(
            ptr(ro.x), ptr(ro.y), ptr(ro.z), ptr(rd.x), ptr(rd.y),
            ptr(rd.z), ptr(avoid), ptr(coef), n, f, key_mask_for(f),
            ptr(t), ptr(idx), ptr(hit), ptr(u), ptr(v), stream_ptr())
        raise_on(err, 'closest_kernel')
        LAUNCHES['closest'] += 1
    return Hit(hit=hit, t=t, index=idx, u=u, v=v)
