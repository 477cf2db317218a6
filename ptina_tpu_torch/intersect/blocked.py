'''
Blocked two-level ray casts for big scenes: the wavefront integrator's
closest and occlusion casts on the blocked route.

Reference: ptina_tpu/intersect/blocked.py (`_blocked_shade_kernel` through
`blocked_cast_shade`, `_blocked_mint_kernel` through `blocked_cast_any`).

The scene's faces are Morton-ordered and padded to whole BLOCK_FACES
blocks (scene.make_scene); block b is rows b * 512 ... b * 512 + 511 of the
face_coef / face_attr tables, and block_bounds [nb, 8] holds its box.  The
contract is brute's winners, t, u, v and attributes, with the reference's
BLOCK-LOCAL packed key:

    key = (bits(t) & ~KEY_FID_MASK) | (fid - 512 * blk)    (mask 2047)

so t sits on the 2^-12 grid at every scene size (not the dense route's
widened key_mask_for(F) grid); `avoid` is a global face id, localised per
block; the nearest hit is the minimum of (key, block) taken
lexicographically, and the winner is blk * 512 + (key & 2047).  An exact
key tie across blocks goes to the lower block id (the reference breaks it
by its visit order; measure-zero).

Each cast has a hand-written CUDA kernel (csrc/blocked_cast.cu, sm_90a:
one thread per ray walks the blocks, culled by a conservative slab test of
its box) and a plain torch version beside it: a loop over the blocks in
index order with a strict < update of (key, block), which tests every
block (the box test only culls).  The wrappers pick by the tensors'
device, as intersect/dense_cast.py does: CPU tensors go to the plain
version, CUDA tensors to the kernel or an exception, with no fallback.
The library is built with nvcc at first use (utils/cuda_build.py, with
--fmad=false, so kernel and plain version round alike); importing this
module needs neither nvcc nor a GPU.

Not ported, being TPU devices for coherence and memory rather than part
of the result: the ray sort into coherent tiles (_coherence_order,
_gather_rays, _unsort_shade), the tile broad phase (_tile_ray_bounds,
_candidate_blocks, _tile_spans, SMEM_CAND_BUDGET), _traverse's 8-visit
rounds, the transposed block tables (blocked_tables) and the streamed mode
above MAX_BLOCKED_VMEM_FACES: on the card every table is in device memory.

LAUNCHES counts kernel launches per wrapper (incremented only where a
kernel is launched).
'''

import ctypes
import functools

import torch

from ptina_tpu_torch.utils.cuda_build import (build_shared_library, ptr,
                                              raise_on, stream_ptr)
from ptina_tpu_torch.intersect.brute import Hit
from ptina_tpu_torch.intersect.plucker import (
    KEY_FID_MASK, KEY_MISS, N_ATTR, N_COEF, check_rays, check_table,
    face_chunk, ray_features, pair_hits, pair_keys, key_decode_t,
    winner_hit)
from ptina_tpu_torch.utils.mathutils import INF

__all__ = ['blocked_cast_shade', 'blocked_cast_any',
           'blocked_cast_shade_plain', 'blocked_cast_any_plain',
           'build_library', 'LAUNCHES', 'BLOCK_FACES', 'MAX_BLOCKS',
           'MAX_BLOCKED_FACES']

# Face-block granularity: Morton-ordered faces in blocks of this size,
# each with its box in Scene.block_bounds (reference scene.BLOCK_FACES).
BLOCK_FACES = 512
# The reference's capacity: 4096 blocks (its 12-bit candidate block id,
# blocked.py:66-68), i.e. 2^21 faces.
MAX_BLOCKS = 4096
MAX_BLOCKED_FACES = BLOCK_FACES * MAX_BLOCKS

LAUNCHES = {'blocked_shade': 0, 'blocked_any': 0}

_SOURCES = ('blocked_cast.cu', 'plucker.cuh')


@functools.lru_cache(maxsize=1)
def build_library():
    '''Compile (once per source hash; utils/cuda_build.py) and load the
    blocked cast library.  Returns (ctypes.CDLL, nvcc log text — empty
    when an existing build was loaded).'''
    lib, log = build_shared_library('ptina_blocked_cast', _SOURCES[0],
                                    _SOURCES)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ptina_blocked_cast_shade.argtypes = [p] * 10 + [i] * 3 + [p] * 7
    lib.ptina_blocked_cast_shade.restype = i
    lib.ptina_blocked_cast_any.argtypes = [p] * 10 + [i] * 3 + [p] * 2
    lib.ptina_blocked_cast_any.restype = i
    return lib, log


def _check_bounds(block_bounds, f, dev):
    nb = -(-f // BLOCK_FACES)
    if block_bounds.dtype != torch.float32 \
            or tuple(block_bounds.shape) != (nb, 8):
        raise ValueError(f'block_bounds must be [{nb}, 8] float32 for {f} '
                         f'faces')
    if block_bounds.device != dev:
        raise ValueError('block_bounds must lie on the rays\' device')
    return nb


def _check(ro, rd, avoid, coef, block_bounds, extra=()):
    n, dev = check_rays(ro, rd, avoid, extra)
    check_table(coef, N_COEF, dev, 'coef', MAX_BLOCKED_FACES)
    return n, dev, _check_bounds(block_bounds, coef.shape[0], dev)


def _blocks(f):
    '''(block id, first face, face count) of each block, in index order.'''
    return [(b, s, min(BLOCK_FACES, f - s))
            for b, s in enumerate(range(0, f, BLOCK_FACES))]


def blocked_cast_shade_plain(ro, rd, avoid, coef, attr, block_bounds):
    '''Plain torch version of the blocked shade kernel: (Hit, attrs
    [6, N]).  block_bounds is not read: the box test only culls.'''
    n = ro.x.shape[0]
    dev = ro.x.device
    p = ray_features(ro, rd)
    best = torch.full((n,), KEY_MISS, dtype=torch.int32, device=dev)
    best_blk = torch.zeros((n,), dtype=torch.int32, device=dev)
    fc = face_chunk(n, BLOCK_FACES)
    for b, base, cnt in _blocks(coef.shape[0]):
        local_avoid = avoid - base
        kb = torch.full((n,), KEY_MISS, dtype=torch.int32, device=dev)
        for s in range(0, cnt, fc):
            rows = coef[base + s:base + min(s + fc, cnt)]
            kb = torch.minimum(kb, pair_keys(p, ro, rd, rows, s, local_avoid,
                                             KEY_FID_MASK))
        better = kb < best  # strict: an equal key keeps the lower block
        best = torch.where(better, kb, best)
        best_blk = torch.where(better, b, best_blk)
    return winner_hit(p, rd, coef, attr, best != KEY_MISS,
                      best_blk * BLOCK_FACES + (best & KEY_FID_MASK),
                      key_decode_t(best, KEY_FID_MASK))


def blocked_cast_any_plain(ro, rd, avoid, tmax, coef, block_bounds):
    '''Plain torch version of the blocked occlusion kernel: occ [N] bool,
    True where a valid hit lies at t < min(tmax, INF).  block_bounds is
    not read.'''
    n = ro.x.shape[0]
    p = ray_features(ro, rd)
    occ = torch.zeros(n, dtype=torch.bool, device=ro.x.device)
    fc = face_chunk(n, BLOCK_FACES)
    for _, base, cnt in _blocks(coef.shape[0]):
        local_avoid = avoid - base
        for s in range(0, cnt, fc):
            rows = coef[base + s:base + min(s + fc, cnt)]
            valid, ts, _ = pair_hits(p, ro, rd, rows, s, local_avoid)
            occ = occ | torch.any(valid & (ts < INF) & (ts < tmax[:, None]),
                                  dim=1)
    return occ


def blocked_cast_shade(ro, rd, avoid, coef, attr, block_bounds):
    '''Closest hit + interpolated corner attributes over a blocked face
    table.  ro, rd: V3 of [N] float32 rows; avoid [N] int32 global face id
    (-1 = none); coef [F, 16] and attr [F, 18] from plucker.pack_faces;
    block_bounds [ceil(F / 512), 8] (scene.compute_block_bounds).  Returns
    (Hit, attrs [6, N]: nrm.xyz, uv.xy, mtlid; zeros on a miss).'''
    n, dev, nb = _check(ro, rd, avoid, coef, block_bounds)
    check_table(attr, N_ATTR, dev, 'attr', MAX_BLOCKED_FACES)
    if dev.type == 'cpu':
        return blocked_cast_shade_plain(ro, rd, avoid, coef, attr,
                                        block_bounds)
    if dev.type != 'cuda':
        raise ValueError(f'no cast for device {dev}')
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
        err = lib.ptina_blocked_cast_shade(
            ptr(ro.x), ptr(ro.y), ptr(ro.z), ptr(rd.x), ptr(rd.y),
            ptr(rd.z), ptr(avoid), ptr(coef), ptr(attr), ptr(block_bounds),
            n, coef.shape[0], nb, ptr(t), ptr(idx), ptr(hit), ptr(u),
            ptr(v), ptr(attrs), stream_ptr())
        raise_on(err, 'blocked_shade_kernel')
        LAUNCHES['blocked_shade'] += 1
    return Hit(hit=hit, t=t, index=idx, u=u, v=v), attrs


def blocked_cast_any(ro, rd, avoid, tmax, coef, block_bounds):
    '''Occlusion cast over a blocked face table: [N] bool, True where a
    face other than avoid is hit at t < min(tmax, INF).'''
    n, dev, nb = _check(ro, rd, avoid, coef, block_bounds, extra=(tmax,))
    if dev.type == 'cpu':
        return blocked_cast_any_plain(ro, rd, avoid, tmax, coef,
                                      block_bounds)
    if dev.type != 'cuda':
        raise ValueError(f'no cast for device {dev}')
    occ = torch.empty(n, dtype=torch.bool, device=dev)
    if n:
        if coef.data_ptr() % 16:
            raise ValueError('coef must be 16-byte aligned')
        lib, _ = build_library()
        err = lib.ptina_blocked_cast_any(
            ptr(ro.x), ptr(ro.y), ptr(ro.z), ptr(rd.x), ptr(rd.y),
            ptr(rd.z), ptr(avoid), ptr(tmax), ptr(coef), ptr(block_bounds),
            n, coef.shape[0], nb, ptr(occ), stream_ptr())
        raise_on(err, 'blocked_any_kernel')
        LAUNCHES['blocked_any'] += 1
    return occ
