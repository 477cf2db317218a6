'''
Linear BVH (Karras construction) and its lockstep traversal: a
correctness oracle beside the casts, not a render route.

Reference: ptina_tpu/intersect/lbvh.py (ptina/tree/lbvh.py).  Plain torch
on either device, step for step as the reference builds it with jnp (it
has no Pallas kernel):

  * 30-bit Morton codes over the centroids' box, in int64 (torch's uint32
    supports little arithmetic; every product stays below 2^41 and the
    masks keep the low 32 bits, so the codes equal the reference's uint32
    ones), and the leaf order by torch.sort(stable=True), as jnp.argsort
    is stable;
  * the Karras ranges and splits with the index-augmented common prefix
    (equal codes fall back to clz(i ^ j); torch has no clz, so
    _bit_length counts bits by five shifts), as fixed-trip loops over all
    n - 1 internal nodes at once;
  * the box fit as the reference's relaxation loop: each round fits the
    nodes whose two children are ready, so it ends after the tree's depth.

Node ids as in the reference: a child id below n is a leaf slot (sorted
order), n + k is internal node k, and internal node 0 is the root.

lbvh_traverse advances every ray's 32-entry stack in lockstep, one node a
ray an iteration, masked, as the reference does.  It is an oracle: each
iteration is some thirty small tensor operations, so it is slower than the
casts' box-tree kernels (intersect/dense_cast.py, intersect/blocked.py) by
orders of magnitude.
'''

import dataclasses
import math

import numpy as np
import torch

from ptina_tpu_torch.utils.mathutils import EPS, INF
from ptina_tpu_torch.intersect.brute import Hit

__all__ = ['LBVH', 'morton3d', 'lbvh_build', 'lbvh_from_numpy', 'ray_aabb',
           'lbvh_traverse', 'STACK_DEPTH']

STACK_DEPTH = 32  # the reference's stack capacity (ptina/tree/stack.py:11)
_CHECK_EVERY = 8  # lockstep iterations between host checks of the stacks


@dataclasses.dataclass
class LBVH:
    leaf: torch.Tensor       # [n] int32 face id per sorted leaf slot
    child: torch.Tensor      # [n-1, 2] int32 (< n leaf, >= n internal + n)
    bmin: torch.Tensor       # [n-1, 3] f32 internal node box min
    bmax: torch.Tensor       # [n-1, 3] f32
    leaf_bmin: torch.Tensor  # [n, 3] f32 per-leaf box
    leaf_bmax: torch.Tensor  # [n, 3] f32


def lbvh_from_numpy(arrays, device='cuda'):
    '''The port's LBVH from a tree's six arrays (a mapping of numpy
    arrays under LBVH's field names, e.g. a JAX LBVH's fields read with
    np.asarray), on `device`.'''
    def t(name):
        return torch.from_numpy(np.array(arrays[name])).to(device)
    return LBVH(**{f.name: t(f.name) for f in dataclasses.fields(LBVH)})


def _expand_bits(v):
    '''Spread 10 bits to every third position (Morton interleave), in
    int64 with the reference's uint32 masks.'''
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def morton3d(p):
    '''30-bit Morton codes [...] int64 of points p [..., 3] in [0, 1].'''
    q = torch.clamp(torch.floor(p * 1024.0), 0, 1023).to(torch.int64)
    return (_expand_bits(q[..., 0]) * 4 + _expand_bits(q[..., 1]) * 2
            + _expand_bits(q[..., 2]))


def _bit_length(x):
    '''Bits of x [...] int64 in [0, 2^32): 32 - clz32(x).'''
    n = torch.zeros_like(x)
    for s in (16, 8, 4, 2, 1):
        big = x >= (1 << s)
        x = torch.where(big, x >> s, x)
        n = n + torch.where(big, s, 0)
    return n + (x > 0).to(x.dtype)


def _delta(codes, n, i, j):
    '''Karras common-prefix length with index augmentation for equal
    codes; -1 where j is outside [0, n).'''
    valid = (j >= 0) & (j < n)
    jc = torch.clamp(j, 0, n - 1)
    x = codes[i] ^ codes[jc]
    d = torch.where(x == 0, 64 - _bit_length(i ^ jc), 32 - _bit_length(x))
    return torch.where(valid, d, -1)


def _fit_boxes(child, leaf_bmin, leaf_bmax):
    '''Internal node boxes by relaxation (reference lbvh.py:251-294): each
    round fits the nodes whose children are ready.'''
    n = leaf_bmin.shape[0]
    dev = leaf_bmin.device
    ready = torch.zeros(n - 1, dtype=torch.bool, device=dev)
    bmin = torch.zeros((n - 1, 3), dtype=torch.float32, device=dev)
    bmax = torch.zeros((n - 1, 3), dtype=torch.float32, device=dev)

    def get_box(cid):
        is_leaf = cid < n
        li = torch.clamp(cid, 0, n - 1)
        ni = torch.clamp(cid - n, 0, n - 2)
        r = is_leaf | ready[ni]
        mn = torch.where(is_leaf[:, None], leaf_bmin[li], bmin[ni])
        mx = torch.where(is_leaf[:, None], leaf_bmax[li], bmax[ni])
        return r, mn, mx

    while not bool(ready.all()):
        r1, mn1, mx1 = get_box(child[:, 0])
        r2, mn2, mx2 = get_box(child[:, 1])
        can = r1 & r2 & ~ready
        bmin = torch.where(can[:, None], torch.minimum(mn1, mn2), bmin)
        bmax = torch.where(can[:, None], torch.maximum(mx1, mx2), bmax)
        ready = ready | can
    return bmin, bmax


def lbvh_build(tri_pos):
    '''Build over every triangle of tri_pos [F, 3, 3] f32 (F >= 2; pass
    live faces only: padding triangles are points at the origin), on its
    device.'''
    f = tri_pos.shape[0]
    if f < 2:
        raise ValueError(f'an LBVH needs at least 2 faces, got {f}')
    n = f
    dev = tri_pos.device

    centers = torch.mean(tri_pos, dim=1)
    cmin = torch.amin(centers, dim=0)
    cmax = torch.amax(centers, dim=0)
    norm = (centers - cmin) / torch.clamp_min(cmax - cmin, 1e-12)
    codes_unsorted = morton3d(norm)
    codes, order = torch.sort(codes_unsorted, stable=True)
    leaf = order.to(torch.int32)
    leaf_bmin = torch.amin(tri_pos, dim=1)[order]
    leaf_bmax = torch.amax(tri_pos, dim=1)[order]

    # Karras ranges and splits, over all internal nodes at once
    i = torch.arange(n - 1, dtype=torch.int64, device=dev)
    d = torch.sign(_delta(codes, n, i, i + 1) - _delta(codes, n, i, i - 1))
    d = torch.where(d == 0, 1, d)
    dmin = _delta(codes, n, i, i - d)
    # enough trips for any n (extra trips change nothing)
    nbits = math.ceil(math.log2(max(n, 2))) + 2

    # exponential search for an upper bound of the range's length
    lmax = torch.full_like(i, 2)
    for _ in range(nbits):
        lmax = torch.where(_delta(codes, n, i, i + lmax * d) > dmin,
                           lmax * 2, lmax)
    # binary search of its other end
    ln, t = torch.zeros_like(i), lmax // 2
    for _ in range(nbits + 1):
        probe = _delta(codes, n, i, i + (ln + t) * d) > dmin
        ln = torch.where((t > 0) & probe, ln + t, ln)
        t = t // 2
    j = i + ln * d
    lo = torch.minimum(i, j)
    hi = torch.maximum(i, j)

    # binary search of the split (the highest differing bit), with the
    # ceil-halving series t = ceil(len / 2), ceil(t / 2), ..., 1 (Karras)
    dnode = _delta(codes, n, i, j)
    s, t = torch.zeros_like(i), (hi - lo + 1) // 2
    for _ in range(nbits + 2):
        probe = _delta(codes, n, i, i + (s + t) * d) > dnode
        s = torch.where((t > 0) & probe, s + t, s)
        t = torch.where(t > 1, (t + 1) // 2, 0)
    gamma = i + s * d + torch.clamp_max(d, 0)

    left = torch.where(lo == gamma, gamma, gamma + n)
    right = torch.where(hi == gamma + 1, gamma + 1, gamma + 1 + n)
    child = torch.stack([left, right], dim=1).to(torch.int32)
    bmin, bmax = _fit_boxes(child.to(torch.int64), leaf_bmin, leaf_bmax)
    return LBVH(leaf=leaf, child=child, bmin=bmin, bmax=bmax,
                leaf_bmin=leaf_bmin, leaf_bmax=leaf_bmax)


def ray_aabb(ro, rd, lo, hi, tmax):
    '''Slab test (reference Box.intersect, ptina/geometries.py:23-46).
    ro, rd: [..., 3]; lo, hi: box corners (broadcastable).  Returns (hit,
    near, far), near clamped to 0 for origins inside the box.'''
    inv = 1.0 / torch.where(torch.abs(rd) < 1e-12, 1e-12, rd)
    t1 = (lo - ro) * inv
    t2 = (hi - ro) * inv
    near = torch.amax(torch.minimum(t1, t2), dim=-1)
    far = torch.amin(torch.maximum(t1, t2), dim=-1)
    hit = (near <= far) & (far > 0.0) & (near < tmax)
    return hit, torch.clamp_min(near, 0.0), far


def _tri_hit(tri_w2b, fid, ro, rd):
    '''One face's test through its affine functionals, per ray.'''
    m = tri_w2b[fid]  # [N, 3, 4]
    a = (m[..., 0] * ro[:, None, 0] + m[..., 1] * ro[:, None, 1]
         + m[..., 2] * ro[:, None, 2] + m[..., 3])
    b = (m[..., 0] * rd[:, None, 0] + m[..., 1] * rd[:, None, 1]
         + m[..., 2] * rd[:, None, 2])
    live = torch.abs(b[:, 0]) >= EPS
    t = -a[:, 0] / torch.where(live, b[:, 0], 1.0)
    u = a[:, 1] + t * b[:, 1]
    v = a[:, 2] + t * b[:, 2]
    ok = live & (t > 0) & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1)
    return ok, t, u, v


@torch.no_grad()
def lbvh_traverse(bvh, tri_w2b, ro, rd, avoid):
    '''Closest hit of every ray, all rays in lockstep (reference
    lbvh.py:313-347): each iteration an active ray pops one node; an
    internal node is box-tested against the best t so far and pushes both
    children, a leaf tests its face.  ro, rd: [N, 3] f32; tri_w2b
    [F, 3, 4]; avoid [N] int32 (-1 = none).  Returns a Hit.  The host
    checks for live stacks every _CHECK_EVERY iterations (an iteration with
    no live stack changes nothing).'''
    n = bvh.leaf.shape[0]
    nr = ro.shape[0]
    dev = ro.device
    rows = torch.arange(nr, device=dev)
    leaf = bvh.leaf.to(torch.int64)
    child = bvh.child.to(torch.int64)
    avoid = avoid.to(torch.int64)

    stack = torch.zeros((nr, STACK_DEPTH), dtype=torch.int64, device=dev)
    stack[:, 0] = n  # the root: internal node 0
    sp = torch.ones(nr, dtype=torch.int64, device=dev)
    bt = torch.full((nr,), INF, dtype=torch.float32, device=dev)
    bi = torch.full((nr,), -1, dtype=torch.int64, device=dev)
    bu = torch.zeros(nr, dtype=torch.float32, device=dev)
    bv = torch.zeros(nr, dtype=torch.float32, device=dev)

    it = 0
    while it % _CHECK_EVERY or bool((sp > 0).any()):
        it += 1
        active = sp > 0
        node = stack[rows, torch.clamp(sp - 1, 0, STACK_DEPTH - 1)]
        sp = torch.where(active, sp - 1, sp)
        is_leaf = node < n

        # leaf: test its face
        fid = leaf[torch.clamp(node, 0, n - 1)]
        ok, t, u, v = _tri_hit(tri_w2b, fid, ro, rd)
        take = active & is_leaf & ok & (fid != avoid) & (t < bt)
        bt = torch.where(take, t, bt)
        bi = torch.where(take, fid, bi)
        bu = torch.where(take, u, bu)
        bv = torch.where(take, v, bv)

        # internal: box test, push both children
        ni = torch.clamp(node - n, 0, n - 2)
        hitbox = ray_aabb(ro, rd, bvh.bmin[ni], bvh.bmax[ni], bt)[0]
        push = active & ~is_leaf & hitbox
        for c in (child[ni, 0], child[ni, 1]):
            idx = torch.clamp(sp, 0, STACK_DEPTH - 1)
            stack[rows, idx] = torch.where(push, c, stack[rows, idx])
            sp = torch.where(push, torch.clamp_max(sp + 1, STACK_DEPTH), sp)
    return Hit(hit=bi >= 0, t=bt, index=bi.to(torch.int32), u=bu, v=bv)
