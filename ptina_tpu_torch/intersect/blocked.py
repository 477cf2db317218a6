'''
Blocked two-level ray casts for big scenes: the wavefront integrator's
closest and occlusion casts on the blocked route.

Reference: ptina_tpu/intersect/blocked.py (`_blocked_shade_kernel` through
`blocked_cast_shade` and its hit-only view `blocked_cast_closest`,
`_blocked_mint_kernel` through `blocked_cast_any`).

The scene's faces are Morton-ordered and padded to whole BLOCK_FACES
blocks (scene.make_scene); block b is rows b * 512 ... b * 512 + 511 of the
face_coef / face_attr tables, and block_bounds [nb, 8] holds its box.
node_bounds [2P, 8] (scene.compute_node_bounds) is the port's own box
tree over leaves of LEAF_FACES = 32 consecutive faces: leaf l is heap
node P + l and lies in block l // 16.  The contract is brute's winners,
t, u, v and attributes, with the reference's BLOCK-LOCAL packed key:

    key = (bits(t) & ~KEY_FID_MASK) | (fid - 512 * blk)    (mask 2047)

so t sits on the 2^-12 grid at every scene size (not the dense route's
widened key_mask_for(F) grid); `avoid` is a global face id, localised per
block; the nearest hit is the minimum of (key, block) taken
lexicographically, and the winner is blk * 512 + (key & 2047).  An exact
key tie across blocks goes to the lower block id (the reference breaks it
by its visit order; measure-zero).

Each cast has a hand-written CUDA kernel (csrc/blocked_cast.cu, sm_90a:
one thread per ray walks the box tree nearest-first with a short stack,
culled by a conservative slab test of each box) and a plain torch version
beside it: a loop over the blocks in index order with a strict < update
of (key, block), which tests every block (the tree only culls, so the
plain versions take node_bounds and do not read it).  box_entries is the
torch twin of the kernels' slab test: the tests hold the culling to it,
and leaf_pairs counts with it the pair tests a ray needs (the kernels'
bound in chip_smoke.py).  The wrappers pick by the tensors'
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
kernel is launched); blocked_cast_visits launches both kernels once each
to read their traversal counters, and counts those launches too.  While
tracing is on (utils/trace.py) every launch of blocked_cast_shade /
blocked_cast_any fills the same counters into a
trace.walk_buffer('blocked_casts', ...), counted on the device (a parked
shadow ray counts as a cast).
'''

import contextlib
import ctypes
import functools

import numpy as np
import torch

from ptina_tpu_torch.utils import trace
from ptina_tpu_torch.utils.cuda_build import (build_shared_library, ptr,
                                              raise_on, stream_ptr)
from ptina_tpu_torch.intersect.brute import Hit
from ptina_tpu_torch.intersect.plucker import (
    KEY_FID_MASK, KEY_MISS, N_ATTR, N_COEF, check_rays, check_table,
    face_chunk, ray_features, pair_hits, pair_keys, key_decode_t,
    winner_hit)
from ptina_tpu_torch.utils.mathutils import INF
from ptina_tpu_torch.utils.vec import V3

__all__ = ['blocked_cast_shade', 'blocked_cast_closest', 'blocked_cast_any',
           'blocked_cast_shade_plain', 'blocked_cast_any_plain',
           'blocked_cast_visits', 'box_entries', 'leaf_pairs',
           'build_library', 'LAUNCHES', 'BLOCK_FACES', 'LEAF_FACES',
           'MAX_BLOCKS', 'MAX_BLOCKED_FACES', 'MAX_TREE_DEPTH']

# Face-block granularity: Morton-ordered faces in blocks of this size,
# each with its box in Scene.block_bounds (reference scene.BLOCK_FACES).
BLOCK_FACES = 512
# The reference's capacity: 4096 blocks (its 12-bit candidate block id,
# blocked.py:66-68), i.e. 2^21 faces.
MAX_BLOCKS = 4096
MAX_BLOCKED_FACES = BLOCK_FACES * MAX_BLOCKS
# Faces per leaf of the box tree (scene.compute_node_bounds); a constant of
# the kernels (csrc/blocked_cast.cu kLeafFaces), dividing BLOCK_FACES.
LEAF_FACES = 32
# log2 of the most leaves, MAX_BLOCKS * 16: the kernels' stack holds one
# entry per level, plus one.
MAX_TREE_DEPTH = 16

LAUNCHES = {'blocked_shade': 0, 'blocked_any': 0}

_SOURCES = ('blocked_cast.cu', 'plucker.cuh', 'tree.cuh')


@functools.lru_cache(maxsize=1)
def build_library():
    '''Compile (once per source hash; utils/cuda_build.py) and load the
    blocked cast library.  Returns (ctypes.CDLL, nvcc log text — empty
    when an existing build was loaded).'''
    lib, log = build_shared_library('ptina_blocked_cast', _SOURCES[0],
                                    _SOURCES)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ptina_blocked_cast_shade.argtypes = [p] * 10 + [i] * 3 + [p] * 8
    lib.ptina_blocked_cast_shade.restype = i
    lib.ptina_blocked_cast_any.argtypes = [p] * 10 + [i] * 3 + [p] * 3
    lib.ptina_blocked_cast_any.restype = i
    return lib, log


def tree_leaves(f):
    '''P, the leaf slots of the box tree over f faces: the least power of
    two >= ceil(f / LEAF_FACES).'''
    return 1 << (max(1, -(-f // LEAF_FACES)) - 1).bit_length()


def _check_boxes(name, boxes, rows, f, dev):
    if boxes.dtype != torch.float32 or tuple(boxes.shape) != (rows, 8):
        raise ValueError(f'{name} must be [{rows}, 8] float32 for {f} '
                         f'faces')
    if boxes.device != dev:
        raise ValueError(f'{name} must lie on the rays\' device')


def _check(ro, rd, avoid, coef, block_bounds, node_bounds, extra=()):
    '''Validate the operands; returns (N, device, P).'''
    n, dev = check_rays(ro, rd, avoid, extra)
    check_table(coef, N_COEF, dev, 'coef', MAX_BLOCKED_FACES)
    f = coef.shape[0]
    _check_boxes('block_bounds', block_bounds, -(-f // BLOCK_FACES), f, dev)
    p = tree_leaves(f)
    _check_boxes('node_bounds', node_bounds, 2 * p, f, dev)
    return n, dev, p


def _blocks(f):
    '''(block id, first face, face count) of each block, in index order.'''
    return [(b, s, min(BLOCK_FACES, f - s))
            for b, s in enumerate(range(0, f, BLOCK_FACES))]


def blocked_cast_shade_plain(ro, rd, avoid, coef, attr, block_bounds,
                             node_bounds):
    '''Plain torch version of the blocked shade kernel: (Hit, attrs
    [6, N]).  block_bounds and node_bounds are not read: the boxes only
    cull.'''
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


def blocked_cast_any_plain(ro, rd, avoid, tmax, coef, block_bounds,
                           node_bounds):
    '''Plain torch version of the blocked occlusion kernel: occ [N] bool,
    True where a valid hit lies at t < min(tmax, INF).  block_bounds and
    node_bounds are not read.'''
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


# The FP32 constants of box_entry, rounded as the C++ source rounds them
_NEAR_SCALE = float(np.float32(1.0) - np.float32(1e-6))
_FAR_SCALE = float(np.float32(1.0) + np.float32(1e-6))


def box_entries(ro, rd, boxes):
    '''Torch twin of csrc/tree.cuh:box_entry, every ray against every box:
    entry [N, B] float32, a lower bound on the t of any hit inside the
    box, and +inf where the slab test rejects the box (no point of it
    ahead of the origin, or an inverted padding box).  boxes: [B, 8] rows
    (lo.xyz, hi.xyz, 0, 0).  The same operations in the same order (the
    direction's reciprocal, then a difference and a product a slab), each
    rounded once, so it agrees with the kernels bit for bit.'''
    o = torch.stack([ro.x, ro.y, ro.z], 1)[:, None, :]
    d = torch.stack([rd.x, rd.y, rd.z], 1)[:, None, :]
    lo, hi = boxes[None, :, 0:3], boxes[None, :, 3:6]
    zero = d == 0.0
    inv = 1.0 / d
    t1 = (lo - o) * inv
    t2 = (hi - o) * inv
    inf = torch.tensor(float('inf'), dtype=torch.float32, device=o.device)
    near = torch.where(zero, -inf, torch.fmin(t1, t2)).amax(-1)
    far = torch.where(zero, inf, torch.fmax(t1, t2)).amin(-1)
    near = near * _NEAR_SCALE
    far = far * _FAR_SCALE
    ok = ((lo <= hi) & (~zero | ((o >= lo) & (o <= hi)))).all(-1) \
        & (far > 0.0) & (near <= far) & torch.isfinite(near)
    return torch.where(ok, torch.clamp_min(near, 0.0), inf)


def leaf_pairs(ro, rd, node_bounds, nfaces, t_stop, inclusive):
    '''The pair tests each ray needs on the box tree: the live faces
    (index < nfaces) of the leaves whose box it enters at an entry <= t_stop
    (inclusive: a closest cast, t_stop its hit t, +inf on a miss) or
    < t_stop (an occlusion cast that finds no occluder, t_stop
    min(tmax, INF)).  [N] int64; the slab test is box_entries.'''
    p = node_bounds.shape[0] // 2
    leaves = node_bounds[p:]
    live = torch.clamp(nfaces - LEAF_FACES * torch.arange(
        p, device=leaves.device), 0, LEAF_FACES)
    n = ro.x.shape[0]
    out = torch.zeros(n, dtype=torch.int64, device=ro.x.device)
    step = max(1, (1 << 22) // p)
    for s in range(0, n, step):
        sl = slice(s, s + step)
        e = box_entries(V3(ro.x[sl], ro.y[sl], ro.z[sl]),
                        V3(rd.x[sl], rd.y[sl], rd.z[sl]), leaves)
        ts = t_stop[sl, None]
        enters = torch.isfinite(e) & ((e <= ts) if inclusive else (e < ts))
        out[sl] = (enters.to(torch.int64) * live[None, :]).sum(1)
    return out


def _launch_shade(lib, ro, rd, avoid, coef, attr, node_bounds, p, out,
                  visits):
    n = ro.x.shape[0]
    hit, t, idx, u, v, attrs = out
    raise_on(lib.ptina_blocked_cast_shade(
        ptr(ro.x), ptr(ro.y), ptr(ro.z), ptr(rd.x), ptr(rd.y), ptr(rd.z),
        ptr(avoid), ptr(coef), ptr(attr), ptr(node_bounds), n,
        coef.shape[0], p, ptr(t), ptr(idx), ptr(hit), ptr(u), ptr(v),
        ptr(attrs), visits, stream_ptr()), 'blocked_shade_kernel')
    LAUNCHES['blocked_shade'] += 1


def _launch_any(lib, ro, rd, avoid, tmax, coef, node_bounds, p, occ,
                visits):
    raise_on(lib.ptina_blocked_cast_any(
        ptr(ro.x), ptr(ro.y), ptr(ro.z), ptr(rd.x), ptr(rd.y), ptr(rd.z),
        ptr(avoid), ptr(tmax), ptr(coef), ptr(node_bounds), ro.x.shape[0],
        coef.shape[0], p, ptr(occ), visits, stream_ptr()),
        'blocked_any_kernel')
    LAUNCHES['blocked_any'] += 1


def _library(coef, node_bounds):
    if coef.data_ptr() % 16 or node_bounds.data_ptr() % 16:
        raise ValueError('coef and node_bounds must be 16-byte aligned')
    return build_library()[0]


@contextlib.contextmanager
def _walks(n, dev):
    '''Around a launch: the address of the kernels' per-ray walk counters
    (a utils/trace.walk_buffer) while tracing is on, else None.'''
    if not trace.tracing():
        trace.warm_walks('blocked_casts', (n, 2), 0, dev)
        yield None
        return
    with trace.walk_buffer('blocked_casts', (n, 2), 0, dev) as vis:
        yield ptr(vis)


def _shade_out(n, dev):
    f32 = dict(dtype=torch.float32, device=dev)
    return (torch.empty(n, dtype=torch.bool, device=dev),
            torch.empty(n, **f32),
            torch.empty(n, dtype=torch.int32, device=dev),
            torch.empty(n, **f32), torch.empty(n, **f32),
            torch.empty((6, n), **f32))


def blocked_cast_shade(ro, rd, avoid, coef, attr, block_bounds,
                       node_bounds):
    '''Closest hit + interpolated corner attributes over a blocked face
    table.  ro, rd: V3 of [N] float32 rows; avoid [N] int32 global face id
    (-1 = none); coef [F, 16] and attr [F, 18] from plucker.pack_faces;
    block_bounds [ceil(F / 512), 8] (scene.compute_block_bounds) and
    node_bounds [2P, 8] (scene.compute_node_bounds).  Returns (Hit,
    attrs [6, N]: nrm.xyz, uv.xy, mtlid; zeros on a miss).'''
    n, dev, p = _check(ro, rd, avoid, coef, block_bounds, node_bounds)
    check_table(attr, N_ATTR, dev, 'attr', MAX_BLOCKED_FACES)
    if dev.type == 'cpu':
        return blocked_cast_shade_plain(ro, rd, avoid, coef, attr,
                                        block_bounds, node_bounds)
    if dev.type != 'cuda':
        raise ValueError(f'no cast for device {dev}')
    out = _shade_out(n, dev)
    if n:
        with _walks(n, dev) as vis:
            _launch_shade(_library(coef, node_bounds), ro, rd, avoid, coef,
                          attr, node_bounds, p, out, vis)
    hit, t, idx, u, v, attrs = out
    return Hit(hit=hit, t=t, index=idx, u=u, v=v), attrs


def blocked_cast_closest(ro, rd, avoid, coef, attr, block_bounds,
                         node_bounds):
    '''Hit-only view of blocked_cast_shade (the same kernel pass): Hit.'''
    hit, _ = blocked_cast_shade(ro, rd, avoid, coef, attr, block_bounds,
                                node_bounds)
    return hit


def blocked_cast_any(ro, rd, avoid, tmax, coef, block_bounds, node_bounds):
    '''Occlusion cast over a blocked face table: [N] bool, True where a
    face other than avoid is hit at t < min(tmax, INF).'''
    n, dev, p = _check(ro, rd, avoid, coef, block_bounds, node_bounds,
                       extra=(tmax,))
    if dev.type == 'cpu':
        return blocked_cast_any_plain(ro, rd, avoid, tmax, coef,
                                      block_bounds, node_bounds)
    if dev.type != 'cuda':
        raise ValueError(f'no cast for device {dev}')
    occ = torch.empty(n, dtype=torch.bool, device=dev)
    if n:
        with _walks(n, dev) as vis:
            _launch_any(_library(coef, node_bounds), ro, rd, avoid, tmax,
                        coef, node_bounds, p, occ, vis)
    return occ


def blocked_cast_visits(ro, rd, avoid, tmax, coef, attr, block_bounds,
                        node_bounds):
    '''What the two kernels' traversals do on these rays, read from their
    own counters: (shade, any), each [N, 2] int32 of (inner nodes
    visited, leaves whose faces were tested) per ray.  One launch of each
    kernel, counted in LAUNCHES.  The counters live in the kernels only,
    so CPU tensors raise.'''
    n, dev, p = _check(ro, rd, avoid, coef, block_bounds, node_bounds,
                       extra=(tmax,))
    check_table(attr, N_ATTR, dev, 'attr', MAX_BLOCKED_FACES)
    if dev.type != 'cuda':
        raise ValueError('blocked_cast_visits reads the CUDA kernels\' '
                         'counters: it needs CUDA tensors')
    lib = _library(coef, node_bounds)
    vis = torch.zeros((2, n, 2), dtype=torch.int32, device=dev)
    if n:
        _launch_shade(lib, ro, rd, avoid, coef, attr, node_bounds, p,
                      _shade_out(n, dev), ptr(vis[0]))
        _launch_any(lib, ro, rd, avoid, tmax, coef, node_bounds, p,
                    torch.empty(n, dtype=torch.bool, device=dev),
                    ptr(vis[1]))
    return vis[0], vis[1]
