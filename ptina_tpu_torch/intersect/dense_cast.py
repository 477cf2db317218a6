'''
Dense single-pass ray casts: the wavefront integrator's two scene-level
casts, which walk the scene's box tree, and the two table-level casts,
which loop over a bare face table.

Reference: ptina_tpu/intersect/pallas_cast.py (`_shade_kernel` through
`pallas_cast_shade`, `_any_kernel` through `pallas_cast_any`,
`_closest_kernel` through `pallas_cast_closest`).

  * cast_shade / cast_any — the scene-level casts (dispatch.cast_shaded /
    cast_shadow on the dense route).  Their kernels walk the box tree the
    path megakernel walks (scene.py: fused_coef, fused_nodes and
    fused_order, passed as tree_coef, tree_nodes and tree_order), keyed
    by the original face id, so they return what every-face loops return;
    `avoid` is an original face id.
  * cast_closest / cast_any_flat — the table-level casts
    (dispatch.cast_closest / cast_any), whose caller packs a bare face
    table per call and has no tree: their kernels test every face,
    streaming the table through shared memory, each thread holding two
    rays.

Each cast has a hand-written CUDA kernel (csrc/dense_cast.cu, sm_90a) and
a plain torch version beside it (the hit contract of plucker.py in torch
ops), which loops over every face in index order: the tree only culls, so
the plain versions take the tree tables and do not read them.  The
wrapper picks by the tensors' device and nothing else:

  * CPU tensors  -> the plain version;
  * CUDA tensors -> the kernel, or an exception.  There is no fallback,
    and a missing or misshapen tree table raises on either device.

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
the kernels; dense_cast_visits launches both tree kernels once each to
read their walk counters, and counts those launches too.
'''

import ctypes
import functools

import torch

from ptina_tpu_torch.utils.mathutils import INF
from ptina_tpu_torch.utils.cuda_build import (build_shared_library, ptr,
                                              raise_on, stream_ptr)
from ptina_tpu_torch.intersect.blocked import tree_leaves
from ptina_tpu_torch.intersect.brute import Hit
from ptina_tpu_torch.intersect.plucker import (
    KEY_MISS, N_ATTR, N_COEF, check_rays, check_table, face_chunk,
    key_mask_for, ray_features, pair_hits, pair_keys, key_decode_t,
    winner_hit)

__all__ = ['cast_shade', 'cast_any', 'cast_closest', 'cast_any_flat',
           'cast_shade_plain', 'cast_any_plain', 'cast_closest_plain',
           'dense_cast_visits', 'build_library', 'LAUNCHES',
           'MAX_DENSE_FACES', 'N_ATTR']

MAX_DENSE_FACES = 8192  # reference MAX_VMEM_FACES

LAUNCHES = {'shade': 0, 'any': 0, 'closest': 0, 'any_flat': 0}

_SOURCES = ('dense_cast.cu', 'plucker.cuh', 'tree.cuh')


@functools.lru_cache(maxsize=1)
def build_library():
    '''Compile (once per source hash; utils/cuda_build.py) and load the
    cast library.  Returns (ctypes.CDLL, nvcc log text — empty when an
    existing build was loaded).'''
    lib, log = build_shared_library('ptina_dense_cast', _SOURCES[0],
                                    _SOURCES)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ptina_cast_shade.argtypes = [p] * 12 + [i] * 4 + [p] * 8
    lib.ptina_cast_shade.restype = i
    lib.ptina_cast_any.argtypes = [p] * 11 + [i] * 3 + [p] * 3
    lib.ptina_cast_any.restype = i
    lib.ptina_cast_closest.argtypes = [p] * 8 + [i, i, i] + [p] * 6
    lib.ptina_cast_closest.restype = i
    lib.ptina_cast_any_flat.argtypes = [p] * 9 + [i, i] + [p] * 2
    lib.ptina_cast_any_flat.restype = i
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


def cast_shade_plain(ro, rd, avoid, coef, attr, tree_coef=None,
                     tree_nodes=None, tree_order=None):
    '''Plain torch version of the shade kernel: (Hit, attrs [6, N]).  The
    tree tables are not read: the box tree only culls.'''
    p, best, fid_mask = _best_keys(ro, rd, avoid, coef)
    return winner_hit(p, rd, coef, attr, best != KEY_MISS, best & fid_mask,
                      key_decode_t(best, fid_mask))


def cast_closest_plain(ro, rd, avoid, coef):
    '''Plain torch version of the closest kernel: Hit.'''
    p, best, fid_mask = _best_keys(ro, rd, avoid, coef)
    return winner_hit(p, rd, coef, None, best != KEY_MISS, best & fid_mask,
                      key_decode_t(best, fid_mask))


def cast_any_plain(ro, rd, avoid, tmax, coef, tree_coef=None,
                   tree_nodes=None, tree_order=None):
    '''Plain torch version of both occlusion kernels: occ [N] bool, True
    where a valid hit lies at t < min(tmax, INF).  The tree tables (the
    tree kernel's; the flat kernel has none) are not read.'''
    n, f = ro.x.shape[0], coef.shape[0]
    p = ray_features(ro, rd)
    occ = torch.zeros(n, dtype=torch.bool, device=ro.x.device)
    fc = face_chunk(n, f)
    for base in range(0, f, fc):
        valid, ts, _ = pair_hits(p, ro, rd, coef[base:base + fc], base, avoid)
        occ = occ | torch.any(valid & (ts < INF) & (ts < tmax[:, None]),
                              dim=1)
    return occ


def _check_tree(tree_coef, tree_nodes, tree_order, f, dev):
    '''Validate the box tree over a dense table of f faces (scene.py:
    fused_coef [F, 16], fused_nodes [2P, 8], fused_order [F] int32); on a
    CUDA device also its 16-byte alignment.  Returns P.'''
    p = tree_leaves(f)
    for name, t, dtype, shape in (
            ('tree_coef', tree_coef, torch.float32, (f, N_COEF)),
            ('tree_nodes', tree_nodes, torch.float32, (2 * p, 8)),
            ('tree_order', tree_order, torch.int32, (f,))):
        if not isinstance(t, torch.Tensor):
            raise ValueError(f'{name} is missing: the dense casts walk the '
                             f'scene\'s box tree')
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f'{name} must be {list(shape)} {dtype} for {f} '
                             f'faces, got {list(t.shape)} {t.dtype}')
        if t.device != dev:
            raise ValueError(f'{name} must lie on the rays\' device')
        if dev.type == 'cuda' and name != 'tree_order' \
                and t.data_ptr() % 16:
            raise ValueError(f'{name} must be 16-byte aligned')
    return p


def _check_shade(ro, rd, avoid, coef, attr, tree):
    n, dev = check_rays(ro, rd, avoid)
    check_table(coef, N_COEF, dev, 'coef', MAX_DENSE_FACES)
    check_table(attr, N_ATTR, dev, 'attr', MAX_DENSE_FACES)
    if attr.shape[0] != coef.shape[0]:
        raise ValueError('attr must have one row per face of coef')
    return n, dev, _check_tree(*tree, coef.shape[0], dev)


def _check_any(ro, rd, avoid, tmax, coef, tree):
    n, dev = check_rays(ro, rd, avoid, extra=(tmax,))
    check_table(coef, N_COEF, dev, 'coef', MAX_DENSE_FACES)
    return n, dev, _check_tree(*tree, coef.shape[0], dev)


def _on_cuda(dev):
    if dev.type != 'cuda':
        raise ValueError(f'no cast for device {dev}')


def _launch_shade(ro, rd, avoid, coef, attr, tree, p, visits):
    n, dev, f = ro.x.shape[0], ro.x.device, coef.shape[0]
    out = (torch.empty(n, dtype=torch.float32, device=dev),
           torch.empty(n, dtype=torch.int32, device=dev),
           torch.empty(n, dtype=torch.bool, device=dev),
           torch.empty(n, dtype=torch.float32, device=dev),
           torch.empty(n, dtype=torch.float32, device=dev),
           torch.empty((6, n), dtype=torch.float32, device=dev))
    if n:
        if coef.data_ptr() % 16:
            raise ValueError('coef must be 16-byte aligned')
        lib, _ = build_library()
        raise_on(lib.ptina_cast_shade(
            ptr(ro.x), ptr(ro.y), ptr(ro.z), ptr(rd.x), ptr(rd.y),
            ptr(rd.z), ptr(avoid), ptr(coef), ptr(attr), *map(ptr, tree),
            n, f, p, key_mask_for(f), *map(ptr, out), visits,
            stream_ptr()), 'shade_kernel')
        LAUNCHES['shade'] += 1
    t, idx, hit, u, v, attrs = out
    return Hit(hit=hit, t=t, index=idx, u=u, v=v), attrs


def _launch_any(ro, rd, avoid, tmax, tree, p, visits):
    n, f = ro.x.shape[0], tree[0].shape[0]
    occ = torch.empty(n, dtype=torch.bool, device=ro.x.device)
    if n:
        lib, _ = build_library()
        raise_on(lib.ptina_cast_any(
            ptr(ro.x), ptr(ro.y), ptr(ro.z), ptr(rd.x), ptr(rd.y),
            ptr(rd.z), ptr(avoid), ptr(tmax), *map(ptr, tree), n, f, p,
            ptr(occ), visits, stream_ptr()), 'any_kernel')
        LAUNCHES['any'] += 1
    return occ


def cast_shade(ro, rd, avoid, coef, attr, tree_coef, tree_nodes,
               tree_order):
    '''Closest hit + interpolated corner attributes over a dense scene
    table.  ro, rd: V3 of [N] float32 rows; avoid [N] int32 original face
    id (-1 = none); coef [F, 16] and attr [F, 18] from plucker.pack_faces,
    in the scene's face order; tree_coef [F, 16], tree_nodes [2P, 8] and
    tree_order [F] int32, the scene's box tree (scene.py: fused_coef,
    fused_nodes, fused_order).  Returns (Hit, attrs [6, N]: nrm.xyz,
    uv.xy, mtlid; zeros on a miss).'''
    tree = (tree_coef, tree_nodes, tree_order)
    n, dev, p = _check_shade(ro, rd, avoid, coef, attr, tree)
    if dev.type == 'cpu':
        return cast_shade_plain(ro, rd, avoid, coef, attr, *tree)
    _on_cuda(dev)
    return _launch_shade(ro, rd, avoid, coef, attr, tree, p, None)


def cast_any(ro, rd, avoid, tmax, coef, tree_coef, tree_nodes, tree_order):
    '''Occlusion cast over a dense scene table: [N] bool, True where a
    face other than avoid (an original id) is hit at t < min(tmax, INF).
    coef [F, 16] in the scene's face order (read by the plain version
    only); the tree tables as for cast_shade.'''
    tree = (tree_coef, tree_nodes, tree_order)
    n, dev, p = _check_any(ro, rd, avoid, tmax, coef, tree)
    if dev.type == 'cpu':
        return cast_any_plain(ro, rd, avoid, tmax, coef, *tree)
    _on_cuda(dev)
    return _launch_any(ro, rd, avoid, tmax, tree, p, None)


def dense_cast_visits(ro, rd, avoid, tmax, coef, attr, tree_coef,
                      tree_nodes, tree_order):
    '''What the two tree kernels' walks do on these rays, read from their
    own counters: (shade, any), each [N, 2] int32 of (inner nodes
    visited, leaves whose faces were tested) per ray.  One launch of each
    kernel, counted in LAUNCHES.  The counters live in the kernels only,
    so CPU tensors raise.'''
    tree = (tree_coef, tree_nodes, tree_order)
    n, dev, p = _check_shade(ro, rd, avoid, coef, attr, tree)
    _check_any(ro, rd, avoid, tmax, coef, tree)
    if dev.type != 'cuda':
        raise ValueError('dense_cast_visits reads the CUDA kernels\' '
                         'counters: it needs CUDA tensors')
    vis = torch.zeros((2, n, 2), dtype=torch.int32, device=dev)
    if n:
        _launch_shade(ro, rd, avoid, coef, attr, tree, p, ptr(vis[0]))
        _launch_any(ro, rd, avoid, tmax, tree, p, ptr(vis[1]))
    return vis[0], vis[1]


def cast_closest(ro, rd, avoid, coef):
    '''Closest hit without attributes over a bare face table: Hit (t INF,
    index -1 and u, v 0 on a miss).  coef [F, 16] from
    plucker.pack_faces.'''
    n, dev = check_rays(ro, rd, avoid)
    check_table(coef, N_COEF, dev, 'coef', MAX_DENSE_FACES)
    if dev.type == 'cpu':
        return cast_closest_plain(ro, rd, avoid, coef)
    _on_cuda(dev)
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


def cast_any_flat(ro, rd, avoid, tmax, coef):
    '''Occlusion over a bare face table: [N] bool, True where a face other
    than avoid is hit at t < min(tmax, INF).  coef [F, 16] from
    plucker.pack_faces.'''
    n, dev = check_rays(ro, rd, avoid, extra=(tmax,))
    check_table(coef, N_COEF, dev, 'coef', MAX_DENSE_FACES)
    if dev.type == 'cpu':
        return cast_any_plain(ro, rd, avoid, tmax, coef)
    _on_cuda(dev)
    occ = torch.empty(n, dtype=torch.bool, device=dev)
    if n:
        if coef.data_ptr() % 16:
            raise ValueError('coef must be 16-byte aligned')
        lib, _ = build_library()
        err = lib.ptina_cast_any_flat(
            ptr(ro.x), ptr(ro.y), ptr(ro.z), ptr(rd.x), ptr(rd.y),
            ptr(rd.z), ptr(avoid), ptr(tmax), ptr(coef), n,
            coef.shape[0], ptr(occ), stream_ptr())
        raise_on(err, 'any_flat_kernel')
        LAUNCHES['any_flat'] += 1
    return occ
