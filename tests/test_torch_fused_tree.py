'''
The path megakernel's box tree (scene.py: fused_order, fused_coef,
fused_nodes; walked by csrc/fused_path.cu) on the CPU, on the four dense
benchmark scenes, against the JAX build and the hit contract.

The kernel itself runs only on the card (tests/test_torch_cuda_kernels.py
holds it against its twin there).  Here its culling is held through the
torch twin of its slab test, blocked.box_entries, which rounds as the
kernel's box_entry does: for the contract's winner of every ray (the
packed-key minimum over all faces, dense_cast.cast_closest_plain) every
node from the root to the winner's leaf is entered at a floored entry at
or below the winner's floored key, so the closest cast's gate cannot
prune it in any visit order; for a shadow ray the nearest occluder's
leaf chain is entered before tmax.  The order rule (fused_face_order) is
held to the JAX package's Morton order and to its purpose: no more pair
tests than index order (blocked.leaf_pairs).
'''

import numpy as np
import pytest
import torch

from ptina_tpu import scenes as jscenes
from ptina_tpu.scene import morton_face_order as jmorton_face_order
from ptina_tpu_torch import scenes as tscenes
from ptina_tpu_torch.camera import camera_rays
from ptina_tpu_torch.engine.path import path_trace, pixel_grid
from ptina_tpu_torch.intersect import dense_cast
from ptina_tpu_torch.intersect.blocked import (box_entries, leaf_pairs,
                                               tree_leaves, LEAF_FACES)
from ptina_tpu_torch.intersect.plucker import key_mask_for
from ptina_tpu_torch.scene import compute_node_bounds, morton_face_order
from ptina_tpu_torch.utils.vec import V3

from test_torch_cuda_kernels import _fused_tie_scene

torch.set_num_threads(2)

SCENES = ('cornell_box', 'cornell_monkey', 'envlight_scene', 'matball')
# faces whose box spans more than a quarter of the scene's: every face of
# the cornell box (walls and the two boxes), the monkey's room and boxes,
# the ground's two triangles
LARGE = {'cornell_box': 34, 'cornell_monkey': 14, 'envlight_scene': 2,
         'matball': 2}

_BUILT = {}


def _scene(name):
    if name not in _BUILT:
        _BUILT[name] = getattr(tscenes, name)(device='cpu')
    return _BUILT[name]


def _v3(a):
    return V3(*(torch.from_numpy(np.ascontiguousarray(a[:, k], np.float32))
                for k in range(3)))


def _rays(scene, seed, n=256):
    '''Seeded rays from inside the scene's box in random directions, the
    first 32 straight down onto the floor (y = 0, a wall on its leaves'
    box planes), then 64 camera rays through pixel centres; a quarter of
    the random ones avoid a random face.'''
    nf = int(scene.nfaces)
    v = scene.tri_pos[:nf].reshape(-1, 3).numpy()
    lo, hi = v.min(0), v.max(0)
    rng = np.random.RandomState(seed)
    o = rng.uniform(lo + 0.05, hi - 0.05, (n, 3))
    o[:, 1] = rng.uniform(0.1, hi[1] - 0.1, n)
    d = rng.randn(n, 3)
    d[:32] = [0.0, -1.0, 0.0]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    avoid = np.where(rng.rand(n) < 0.25, rng.randint(0, nf, n), -1)
    avoid[:32] = -1
    ii, jj = pixel_grid(8, 8, device='cpu')
    cro, crd = camera_rays(scene.cam_v2w,
                           (ii.float() + 0.5) / 8 * 2.0 - 1.0,
                           (jj.float() + 0.5) / 8 * 2.0 - 1.0)
    ro, rd = _v3(o), _v3(d)
    ro, rd = (V3(*(torch.cat([getattr(a, c), getattr(b, c)]) for c in 'xyz'))
              for a, b in ((ro, cro), (rd, crd)))
    avoid = torch.cat([torch.from_numpy(avoid.astype(np.int32)),
                       torch.full((64,), -1, dtype=torch.int32)])
    return ro, rd, avoid


def _bits(x):
    return x.contiguous().view(torch.int32)


def _chain(scene, faces):
    '''Heap nodes [K, depth + 1] from each face's leaf up to the root.'''
    slot = torch.empty_like(scene.fused_order)
    slot[scene.fused_order.long()] = torch.arange(
        scene.fused_order.shape[0], dtype=torch.int32)
    k = tree_leaves(scene.face_coef.shape[0]) \
        + slot[faces.long()].long() // LEAF_FACES
    out = [k]
    while (k > 1).any():
        k = k // 2
        out.append(k)
    return torch.stack(out, 1)


@pytest.mark.parametrize('name', SCENES)
def test_fused_tables(name):
    '''fused_order is a permutation with the live faces first and the
    large faces ahead of the rest, which follow the JAX package's Morton
    order; fused_coef and fused_nodes are the scene's rows in that order;
    the scene's own tables and face ids stay the JAX build's.'''
    scene = _scene(name)
    js = getattr(jscenes, name)()
    f, nf = scene.face_coef.shape[0], int(scene.nfaces)
    order = scene.fused_order.numpy()
    assert order.dtype == np.int32 and order.shape == (f,)
    np.testing.assert_array_equal(np.sort(order), np.arange(f))
    np.testing.assert_array_equal(order[nf:], np.arange(nf, f))
    pos = scene.tri_pos.numpy()
    nl = LARGE[name]
    rest = np.sort(order[nl:nf])
    np.testing.assert_array_equal(order[:nl], np.sort(order[:nl]))
    if rest.size:
        ext = (pos[:nf].max(1) - pos[:nf].min(1)).max(1)
        assert ext[order[:nl]].min() > ext[rest].max()
        np.testing.assert_array_equal(order[nl:nf],
                                      rest[jmorton_face_order(pos[rest])])
    assert torch.equal(scene.fused_coef, scene.face_coef[order])
    np.testing.assert_array_equal(scene.fused_nodes.numpy(),
                                  compute_node_bounds(pos[order], nf))
    assert scene.fused_nodes.shape == (2 * tree_leaves(f), 8)
    for k in ('tri_pos', 'tri_attrs', 'tri_mtl', 'nfaces'):
        np.testing.assert_array_equal(getattr(scene, k).numpy(),
                                      np.asarray(getattr(js, k)), err_msg=k)


@pytest.mark.parametrize('name', SCENES)
def test_fused_tree_gate_keeps_winner(name):
    '''The closest cast's floored gate keeps the whole leaf chain of the
    contract's winner, and the shadow cast's tmax gate the chain of the
    nearest occluder, on random, floor-plane and camera rays.'''
    scene = _scene(name)
    ro, rd, avoid = _rays(scene, seed=len(name))
    n = ro.x.shape[0]
    hit = dense_cast.cast_closest_plain(ro, rd, avoid, scene.face_coef)
    assert hit.hit.float().mean() > 0.3 and hit.hit[:32].all()
    nodes = scene.fused_nodes
    entries = box_entries(ro, rd, nodes)  # [N, 2P]
    mask = key_mask_for(scene.face_coef.shape[0])
    rows = torch.nonzero(hit.hit)[:, 0]
    chain = _chain(scene, hit.index[rows])
    e = torch.gather(entries[rows], 1, chain)
    assert torch.isfinite(e).all()
    key_floor = _bits(hit.t[rows])  # the decoded t: the key's floored bits
    assert ((_bits(e) & ~mask) <= key_floor[:, None]).all()
    # floor rays that hit the floor hit it on their leaves' lower box face
    floor = (ro.y[rows] + rd.y[rows] * hit.t[rows]).abs() < 1e-4
    floor &= rows < 32
    assert floor.sum() >= 8
    assert (nodes[chain[floor, 0], 1] == 0.0).all()
    # shadow rays: tmax in (0, 1.5 t) of each ray's first hit
    tmax = torch.where(hit.hit, hit.t, 8.0) \
        * torch.from_numpy(np.random.RandomState(1).uniform(
            0.05, 1.5, n).astype(np.float32))
    occ = dense_cast.cast_any_plain(ro, rd, avoid, tmax, scene.face_coef)
    assert torch.equal(occ, hit.hit & (hit.t < tmax))
    assert 0.1 < occ.float().mean() < 0.9
    rows = torch.nonzero(occ)[:, 0]
    e = torch.gather(entries[rows], 1, _chain(scene, hit.index[rows]))
    assert (e < tmax[rows, None]).all()
    # the bound's count: a hit needs at least its winner's leaf
    nf = int(scene.nfaces)
    pairs = leaf_pairs(ro, rd, nodes, nf,
                       torch.where(hit.hit, hit.t, float('inf')), True)
    assert (pairs[hit.hit] >= 1).all() and (pairs <= nf).all()


def test_fused_cross_leaf_tie():
    '''An exact key tie across leaves: the copy with the higher id sits in
    the leaf the walk enters first; the contract's winner is the lower id,
    through the megakernel's twin as well.'''
    scene, (ro, rd) = _fused_tie_scene('cpu')
    order = scene.fused_order.tolist()
    assert order.index(3) == 2 * LEAF_FACES - 1  # the last slot of leaf 1
    assert order.index(65) == 2 * LEAF_FACES  # the first of leaf 2
    entries = box_entries(ro, rd, scene.fused_nodes)
    assert scene.fused_nodes.shape == (8, 8)  # four leaf slots
    # the walk takes node 3 (leaves 2-3) before node 2 (leaves 0-1), and
    # leaf 2 (node 6) before leaf 1 (node 5)
    assert (entries[:, 3] < entries[:, 2]).all()
    assert (entries[:, 6] < entries[:, 5]).all()
    n = ro.x.shape[0]
    avoid = torch.full((n,), -1, dtype=torch.int32)
    hit = dense_cast.cast_closest_plain(ro, rd, avoid, scene.face_coef)
    assert hit.hit.all() and (hit.index == 3).all()
    lanes = []
    u = torch.from_numpy(np.random.RandomState(6).rand(32, n)
                         .astype(np.float32))
    rad = path_trace(scene, ro, rd, u, lanes=lanes)
    assert (lanes[0]['hit'].index == 3).all()
    assert (rad.x > rad.y).all()  # the red copy's material


@pytest.mark.parametrize('name', SCENES)
def test_fused_order_needs_no_more_pairs(name):
    '''The order rule needs no more pair tests than index order on seeded
    random rays (blocked.leaf_pairs: the live faces of every leaf a ray
    enters at or before its hit), and, on the scenes with large faces
    among many small ones, fewer than plain Morton order.'''
    scene = _scene(name)
    ro, rd, avoid = _rays(scene, seed=11)
    avoid = torch.full_like(avoid, -1)
    hit = dense_cast.cast_closest_plain(ro, rd, avoid, scene.face_coef)
    t_stop = torch.where(hit.hit, hit.t, float('inf'))
    f, nf = scene.face_coef.shape[0], int(scene.nfaces)
    pos = scene.tri_pos.numpy()
    pad = np.arange(nf, f)
    orders = {'index': np.arange(f),
              'morton': np.concatenate([morton_face_order(pos[:nf]), pad]),
              'rule': scene.fused_order.numpy()}
    pairs = {k: int(leaf_pairs(ro, rd, torch.from_numpy(
        compute_node_bounds(pos[o], nf)), nf, t_stop, True).sum())
        for k, o in orders.items()}
    assert pairs['rule'] <= pairs['index']
    if name != 'cornell_box':
        assert pairs['rule'] < pairs['morton']
