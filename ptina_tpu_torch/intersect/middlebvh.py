'''
Middle-split BVH: the reference's alternative accelerator.

Reference: ptina_tpu/intersect/middlebvh.py, copied (host numpy), itself
after ptina/tree/middlebvh.py:48-76 — recursive host-side median split on
the longest axis.  The reference stores it as an implicit heap and notes it
traverses SLOWER than the LBVH (README.md:50-55); it is kept here for
the same reason — an independent build to cross-check the Karras LBVH —
but re-targeted: the build emits the exact node arrays of
`intersect.lbvh.LBVH` (leaves 0..n-1, internals n..2n-2), so
`lbvh_traverse` runs both trees with zero extra device code.

Build is host-side numpy (it is a one-off per scene, like the
reference's python recursion); the result is the port's LBVH on the
requested device.
'''

import numpy as np
import torch

from ptina_tpu_torch.intersect.lbvh import lbvh_from_numpy

__all__ = ['middlebvh_build']


def middlebvh_build(tri_pos, device='cuda'):
    '''tri_pos: [F, 3, 3] vertex positions (numpy, or a tensor on any
    device).  Returns an LBVH-format tree with one face per leaf, on
    `device`.'''
    if isinstance(tri_pos, torch.Tensor):
        tri_pos = tri_pos.detach().cpu().numpy()
    tri = np.asarray(tri_pos, np.float32)
    f = tri.shape[0]
    assert f >= 1
    lo = tri.min(axis=1)   # [F, 3] per-face AABB
    hi = tri.max(axis=1)
    cen = 0.5 * (lo + hi)

    n_int = max(f - 1, 1)
    child = np.zeros((n_int, 2), np.int32)
    bmin = np.zeros((n_int, 3), np.float32)
    bmax = np.zeros((n_int, 3), np.float32)
    leaf = np.zeros(f, np.int32)

    next_leaf = [0]
    next_int = [0]

    def build(idx):
        '''Returns the node id (leaf j -> j, internal k -> f + k).'''
        if len(idx) == 1:
            j = next_leaf[0]
            next_leaf[0] += 1
            leaf[j] = idx[0]
            return j
        k = next_int[0]
        next_int[0] += 1
        bmin[k] = lo[idx].min(axis=0)
        bmax[k] = hi[idx].max(axis=0)
        # split at the centroid median of the longest axis
        # (reference middlebvh.py:56-66)
        axis = int(np.argmax(bmax[k] - bmin[k]))
        order = idx[np.argsort(cen[idx, axis], kind='stable')]
        half = len(order) // 2
        c0 = build(order[:half])
        c1 = build(order[half:])
        child[k] = (c0, c1)
        return f + k

    import sys
    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 4 * f + 100))
    try:
        if f == 1:
            leaf[0] = 0
            bmin[0], bmax[0] = lo[0], hi[0]
            child[0] = (0, 0)
        else:
            build(np.arange(f))
    finally:
        sys.setrecursionlimit(old_limit)

    return lbvh_from_numpy(dict(leaf=leaf, child=child, bmin=bmin, bmax=bmax,
                                leaf_bmin=lo, leaf_bmax=hi), device)
