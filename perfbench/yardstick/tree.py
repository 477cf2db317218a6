'''
The yardstick's box trees and pair arithmetic, frozen, so that a change to
the program's tree, kernels or route moves only the measured side of a
roofline share.

Copied from ptina_tpu_torch/scene.py (compute_block_bounds,
compute_node_bounds, fused_face_order: the port's box-tree builds at
LEAF_FACES = 32, the dense route's tree over fused_face_order and the
blocked route's over the Morton-ordered table), intersect/blocked.py
(tree_leaves, box_entries: csrc/tree.cuh's slab test) and chip_smoke.py
(_rows_dot, _leaf_work, _tree_work, _cast_work: the pairs a cast needs
on a tree, and how many of them pass the sign test).
'''

import numpy as np
import torch

from perfbench.plainref.intersect.plucker import ray_features
from perfbench.plainref.scene import morton_face_order
from perfbench.plainref.vec import V3

LEAF_FACES = 32
# FP32 operations of one ray-face pair (csrc/plucker.cuh): the sign test,
# which every needed pair takes, and face_t, which a pair passing it takes
FLOPS_SIDE = 29
FLOPS_T = 7


def tree_leaves(f):
    return 1 << (max(1, -(-f // LEAF_FACES)) - 1).bit_length()


def compute_block_bounds(tri_pos, nfaces, block_faces):
    f = tri_pos.shape[0]
    nblocks = max(1, -(-f // block_faces))
    big = np.float32(3.4e38)
    out = np.zeros((nblocks, 8), np.float32)
    out[:, 0:3] = big
    out[:, 3:6] = -big
    for b in range(nblocks):
        s = b * block_faces
        e = min(min(s + block_faces, f), nfaces)
        if e <= s:
            continue
        verts = tri_pos[s:e].reshape(-1, 3)
        out[b, 0:3] = verts.min(axis=0)
        out[b, 3:6] = verts.max(axis=0)
    return out


def compute_node_bounds(tri_pos, nfaces):
    '''[2P, 8] heap-layout box tree over leaves of LEAF_FACES faces.'''
    leaves = compute_block_bounds(tri_pos, nfaces, LEAF_FACES)
    p = tree_leaves(tri_pos.shape[0])
    out = np.zeros((2 * p, 8), np.float32)
    out[:, 0:3] = np.float32(3.4e38)
    out[:, 3:6] = np.float32(-3.4e38)
    out[p:p + leaves.shape[0]] = leaves
    for s in range(p.bit_length() - 2, -1, -1):
        k = np.arange(1 << s, 2 << s)
        out[k, 0:3] = np.minimum(out[2 * k, 0:3], out[2 * k + 1, 0:3])
        out[k, 3:6] = np.maximum(out[2 * k, 3:6], out[2 * k + 1, 3:6])
    return out


def fused_face_order(tri_pos, nfaces):
    '''The dense route's tree order: large faces first in index order,
    then the rest in Morton order, then the padding.'''
    f = tri_pos.shape[0]
    if nfaces == 0:
        return np.arange(f)
    live = tri_pos[:nfaces]
    ext = live.max(axis=1) - live.min(axis=1)
    verts = live.reshape(-1, 3)
    large = ext.max(axis=1) > 0.25 * (verts.max(axis=0)
                                      - verts.min(axis=0)).max()
    rest = np.flatnonzero(~large)
    if rest.size > 1:
        rest = rest[morton_face_order(live[rest])]
    return np.concatenate([np.flatnonzero(large), rest,
                           np.arange(nfaces, f)]).astype(np.int64)


_NEAR_SCALE = float(np.float32(1.0) - np.float32(1e-6))
_FAR_SCALE = float(np.float32(1.0) + np.float32(1e-6))


def box_entries(ro, rd, boxes):
    '''[N, B] entry t of each ray into each box, +inf where rejected.'''
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


def _rows_dot(c, rows):
    acc = rows[0] * c[..., 0]
    for k in range(1, len(rows)):
        acc = acc + rows[k] * c[..., k]
    return acc


def leaf_work(ro, rd, nf, ray, leaf, coef):
    '''For (ray, leaf) entries: ([M] live faces of the leaf, [M] of them
    whose pair with the ray passes the sign test); coef holds the faces
    in tree slot order.'''
    dev = coef.device
    live = torch.clamp(nf - LEAF_FACES * leaf.long(), 0, LEAF_FACES)
    feats = ray_features(ro, rd)
    dirs = (rd.x, rd.y, rd.z)
    passing = torch.zeros_like(live)
    step = 1 << 15
    for s in range(0, ray.numel(), step):
        r, sl = ray[s:s + step], slice(s, s + step)
        slot = leaf[sl, None].long() * LEAF_FACES \
            + torch.arange(LEAF_FACES, device=dev)
        c = coef[torch.clamp_max(slot, coef.shape[0] - 1)]
        p = [f[r][:, None] for f in feats]
        u = _rows_dot(c[..., 0:6], p)
        v = _rows_dot(c[..., 6:12], p)
        b = _rows_dot(c[..., 12:15], [d[r][:, None] for d in dirs])
        w = b - u - v
        bi = b.view(torch.int32)
        side = ((u.view(torch.int32) ^ bi) | (v.view(torch.int32) ^ bi)
                | (w.view(torch.int32) ^ bi))
        passing[sl] = ((side >= 0) & (slot < nf)).sum(1)
    return live, passing


def tree_work(ro, rd, nodes, nf, t_stop, inclusive, coef):
    '''([N] pairs, [N] passing) of the leaves each ray enters at an entry
    <= t_stop (inclusive) or < t_stop.'''
    p = nodes.shape[0] // 2
    n = ro.x.shape[0]
    dev = nodes.device
    pairs = torch.zeros(n, dtype=torch.int64, device=dev)
    passing = torch.zeros_like(pairs)
    step = max(1, (1 << 22) // p)
    for s in range(0, n, step):
        sl = slice(s, s + step)
        e = box_entries(V3(ro.x[sl], ro.y[sl], ro.z[sl]),
                        V3(rd.x[sl], rd.y[sl], rd.z[sl]), nodes[p:])
        ts = t_stop[sl, None]
        enters = torch.isfinite(e) & ((e <= ts) if inclusive else (e < ts))
        ray, leaf = enters.nonzero(as_tuple=True)
        ray = ray + s
        live, ok = leaf_work(ro, rd, nf, ray, leaf, coef)
        pairs.index_add_(0, ray, live)
        passing.index_add_(0, ray, ok)
    return pairs, passing


def cast_work(lane, occluder, nodes, nf, slot, coef):
    '''((closest pairs, passing), (shadow pairs, passing)), [N] each, of
    one bounce's two casts: the closest cast the live faces of every leaf
    its ray enters at or before its hit; the shadow ray, where occluded,
    its nearest occluder's leaf, else every leaf it enters before
    min(tmax, INF).'''
    hit = lane['hit']
    inf = torch.full_like(hit.t, float('inf'))
    closest = tree_work(lane['ro'], lane['rd'], nodes, nf,
                        torch.where(hit.hit, hit.t, inf), True, coef)
    ro_sh, rd_sh = lane['ro_sh'], lane['rd_sh']
    leaf = slot[torch.clamp_min(occluder, 0).long()] // LEAF_FACES
    n = ro_sh.x.shape[0]
    own = leaf_work(ro_sh, rd_sh, nf, torch.arange(n, device=nodes.device),
                    leaf, coef)
    clear = tree_work(ro_sh, rd_sh, nodes, nf,
                      torch.clamp_max(lane['tmax'], 1e6), False, coef)
    shadow = tuple(torch.where(lane['occ'], a, b) for a, b in zip(own, clear))
    return closest, shadow
