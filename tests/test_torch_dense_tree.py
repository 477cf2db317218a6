'''
The dense scene-level casts (ptina_tpu_torch.intersect.dense_cast:
cast_shade, cast_any, reached from dispatch.cast_shaded / cast_shadow)
walk the scene's box tree on the card (csrc/dense_cast.cu; scene.py:
dense_tree, the fused_coef / fused_nodes / fused_order tables the path
megakernel walks too).  On the CPU they run their plain versions, which
loop over every face in index order and take the tree without reading it.

Here, on the CPU:
  * the wrappers, given each scene's tree, against the JAX package's
    pallas_cast_shade / pallas_cast_any in interpret mode on cornell
    (40 faces: the tree of two leaves, kBoxes false), cornell_monkey
    (968), envlight (2,216: the widened fid_mask) and a random 2,504-face
    make_scene table, at tests/test_torch_cast.py's tolerances (hit,
    index and occlusion exact; t rtol 5e-4; u, v rtol 1e-3 atol 1e-4;
    attributes atol 1e-4);
  * the kernels' culling, through the torch twin of their slab test
    (blocked.box_entries, which rounds as tree.cuh's box_entry does), on
    the wavefront's own per-bounce rays (path_trace's lanes) and on random
    rays: the floored gate of the closest cast never prunes a node on the
    contract winner's leaf chain, and the tmax gate of the occlusion cast
    never prunes the nearest occluder's;
  * an exact key tie across leaves returns the lower id's attributes;
  * the tree tables are validated: a missing or misshapen one raises.
The kernels themselves are held to these plain versions bit for bit on
the card (tests/test_torch_cuda_kernels.py).
'''

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ptina_tpu import scenes as jscenes
from ptina_tpu.intersect.pallas_cast import pallas_cast_shade, pallas_cast_any
from ptina_tpu.utils.vec import V3 as JV3
from ptina_tpu_torch.engine.fused import fused_trace_primary_plain
from ptina_tpu_torch.intersect import dense_cast, dispatch
from ptina_tpu_torch.intersect.blocked import box_entries, tree_leaves
from ptina_tpu_torch.intersect.plucker import key_mask_for
from ptina_tpu_torch.sampling.sobol import sobol_block
from ptina_tpu_torch.scene import dense_tree, make_scene, scene_from_numpy
from ptina_tpu_torch.utils.vec import V3

from test_torch_cuda_kernels import _fused_tie_scene
from test_torch_fused_tree import _chain, _rays
from test_torch_scene import jax_scene_arrays

torch.set_num_threads(2)

_BUILT = {}


def _random_2504():
    '''chip_compare.py's random table: 2,500 random triangles, 2,504
    padded.'''
    rng = np.random.RandomState(3)
    nf = 2500
    tris = (rng.randn(nf, 3, 3) * 2.0).astype(np.float32)
    verts = np.concatenate([tris.reshape(-1, 3),
                            np.tile([[0.0, 0.0, 1.0]], (nf * 3, 1)),
                            np.zeros((nf * 3, 2))], axis=1)
    return make_scene(verts, rng.randint(-1, 4, size=nf).astype(np.int32),
                      device='cpu')


def _scene(name):
    '''The port's scene, from the JAX package's arrays where it has the
    scene.'''
    if name not in _BUILT:
        if name == 'random_2504':
            _BUILT[name] = _random_2504()
        else:
            js = getattr(jscenes, name)()
            _BUILT[name] = scene_from_numpy(jax_scene_arrays(js),
                                            device='cpu')
    return _BUILT[name]


def _tree(scene):
    return scene.fused_coef, scene.fused_nodes, scene.fused_order


def _jax_rays(ro, rd):
    return (JV3(*(jnp.asarray(getattr(ro, c).numpy()) for c in 'xyz')),
            JV3(*(jnp.asarray(getattr(rd, c).numpy()) for c in 'xyz')))


SCENES = ('cornell_box', 'cornell_monkey', 'envlight_scene', 'random_2504')


@pytest.mark.parametrize('name', SCENES)
def test_tree_casts_match_pallas_interpret(name):
    scene = _scene(name)
    f = scene.face_coef.shape[0]
    tree = _tree(scene)
    # the tree is the scene's: dense_tree over its own tables
    for a, b in zip(tree, dense_tree(scene.tri_pos.numpy(),
                                     int(scene.nfaces), scene.face_coef)):
        assert torch.equal(a, b)
    assert tree[1].shape == (2 * tree_leaves(f), 8)
    ro, rd, avoid = _rays(scene, seed=21, n=192)
    jro, jrd = _jax_rays(ro, rd)
    w2b = jnp.asarray(scene.tri_w2b.numpy())
    ref, ref_att = pallas_cast_shade(jro, jrd, w2b, jnp.asarray(avoid.numpy()),
                                     jnp.asarray(scene.tri_attrs.numpy()),
                                     interpret=True)
    got, got_att = dense_cast.cast_shade(ro, rd, avoid, scene.face_coef,
                                         scene.face_attr, *tree)
    hit = np.asarray(ref.hit)
    assert hit.mean() > 0.2
    np.testing.assert_array_equal(got.hit.numpy(), hit)
    np.testing.assert_array_equal(got.index.numpy(), np.asarray(ref.index))
    np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(ref.t)[hit],
                               rtol=5e-4)
    for a, b in ((got.u, ref.u), (got.v, ref.v)):
        np.testing.assert_allclose(a.numpy()[hit], np.asarray(b)[hit],
                                   rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(got_att.numpy(), np.asarray(ref_att),
                               rtol=0, atol=1e-4)
    # shadow distances around each ray's first hit, a few parked
    tmax = torch.where(got.hit, got.t, 8.0) * torch.from_numpy(
        np.random.RandomState(2).uniform(0.05, 1.5, ro.x.shape[0])
        .astype(np.float32))
    tmax[:4] = 0.0
    occ_ref = np.asarray(pallas_cast_any(
        jro, jrd, w2b, jnp.asarray(avoid.numpy()),
        jnp.asarray(tmax.numpy()), interpret=True))
    occ = dense_cast.cast_any(ro, rd, avoid, tmax, scene.face_coef, *tree)
    np.testing.assert_array_equal(occ.numpy(), occ_ref)
    assert 0.05 < occ_ref.mean() < 0.95 and not occ_ref[:4].any()
    if name in ('envlight_scene', 'random_2504'):
        assert key_mask_for(f) == 4095  # the widened key


def _bits(x):
    return x.contiguous().view(torch.int32)


def _batches(scene, name):
    '''The casts the gate test holds: each bounce's closest and shadow
    casts of a 12x12 wavefront sample (path_trace's lanes: avoid the last
    hit's original id; not on the random table, whose material ids have
    no materials), then seeded random rays with shadow distances around
    their first hit.  [(ro, rd, avoid, tmax, label)].'''
    out = []
    lanes = []
    if name != 'random_2504':
        fused_trace_primary_plain(scene, sobol_block(9, 2 + 6 * 5), 12, 12,
                                  lanes=lanes)
    for b, lane in enumerate(lanes):
        alive, shadow = lane['alive'], lane['shadow']
        pick = lambda v, m: V3(v.x[m], v.y[m], v.z[m])
        out.append((pick(lane['ro'], alive), pick(lane['rd'], alive),
                    lane['avoid'][alive], None, f'bounce {b} closest'))
        out.append((pick(lane['ro_sh'], shadow), pick(lane['rd_sh'], shadow),
                    lane['hit'].index[shadow], lane['tmax'][shadow],
                    f'bounce {b} shadow'))
    ro, rd, avoid = _rays(scene, seed=len(name))
    out.append((ro, rd, avoid, None, 'random'))
    return out


@pytest.mark.parametrize('name', ('cornell_monkey', 'envlight_scene',
                                  'random_2504'))
def test_gate_keeps_winner_and_occluder(name):
    '''The floored <= gate (prune only a node whose floored entry is
    strictly beyond the floored running best) keeps every node from the
    root to the contract winner's leaf; the occlusion gate (prune entries
    at or beyond tmax) keeps the nearest occluder's, where the occluder is
    the nearest face but the avoided one and lies before tmax.'''
    scene = _scene(name)
    nodes, mask = scene.fused_nodes, key_mask_for(scene.face_coef.shape[0])
    held = 0
    for ro, rd, avoid, tmax, label in _batches(scene, name):
        if ro.x.shape[0] == 0:
            continue
        hit = dense_cast.cast_closest_plain(ro, rd, avoid, scene.face_coef)
        entries = box_entries(ro, rd, nodes)
        rows = torch.nonzero(hit.hit)[:, 0]
        e = torch.gather(entries[rows], 1, _chain(scene, hit.index[rows]))
        assert torch.isfinite(e).all(), label
        assert ((_bits(e) & ~mask) <= _bits(hit.t[rows])[:, None]).all(), \
            label
        if tmax is None:
            tmax = torch.where(hit.hit, hit.t, 8.0) * 1.25
        occ = dense_cast.cast_any(ro, rd, avoid, tmax, scene.face_coef,
                                  *_tree(scene))
        assert torch.equal(occ, hit.hit & (hit.t < tmax)), label
        rows = torch.nonzero(occ)[:, 0]
        e = torch.gather(entries[rows], 1, _chain(scene, hit.index[rows]))
        assert (e < tmax[rows, None]).all(), label
        held += int(hit.hit.sum()) + int(occ.sum())
    assert held > 200


def test_cross_leaf_tie_returns_lower_id():
    '''_fused_tie_scene: faces 3 (red, leaf 1) and 65 (green, leaf 2, which
    the walk enters first) are one triangle.  The closest cast returns
    face 3 and its material; avoid is an original id, so avoiding either
    copy leaves the other as hit and occluder.'''
    scene, (ro, rd) = _fused_tie_scene('cpu')
    n = ro.x.shape[0]
    entries = box_entries(ro, rd, scene.fused_nodes)
    assert (entries[:, 6] < entries[:, 5]).all()  # leaf 2 before leaf 1
    none = torch.full((n,), -1, dtype=torch.int32)
    hit, _, _, _, mtl = dispatch.cast_shaded(scene, ro, rd, none)
    assert hit.hit.all() and (hit.index == 3).all() and (mtl == 0).all()
    tmax = torch.full((n,), 10.0)
    for av, other in ((3, 65), (65, 3)):
        avoid = torch.full((n,), av, dtype=torch.int32)
        hit, _, _, _, mtl = dispatch.cast_shaded(scene, ro, rd, avoid)
        assert (hit.index == other).all()
        assert (mtl == (0 if other == 3 else 1)).all()
        assert dispatch.cast_shadow(scene, ro, rd, avoid, tmax).all()


def test_tree_tables_validated():
    '''No fallback to a flat loop: a missing, misshapen, mistyped or
    misplaced tree table raises on the CPU as on the card.'''
    scene = _scene('cornell_monkey')
    ro, rd, avoid = _rays(scene, seed=3, n=16)
    tmax = torch.ones(ro.x.shape[0])
    coef, nodes, order = _tree(scene)
    bad = [('tree_coef', None, nodes, order),
           ('tree_nodes', coef, None, order),
           ('tree_order', coef, nodes, None),
           ('tree_nodes', coef, nodes[:8], order),
           ('tree_coef', coef[:-8], nodes, order),
           ('tree_coef', coef.double(), nodes, order),
           ('tree_order', coef, nodes, order.long()),
           ('tree_nodes', coef, nodes.to('meta'), order)]
    for name, *tree in bad:
        with pytest.raises(ValueError, match=name):
            dense_cast.cast_shade(ro, rd, avoid, scene.face_coef,
                                  scene.face_attr, *tree)
        with pytest.raises(ValueError, match=name):
            dense_cast.cast_any(ro, rd, avoid, tmax, scene.face_coef, *tree)
    with pytest.raises(ValueError, match='CUDA'):
        dense_cast.dense_cast_visits(ro, rd, avoid, tmax, scene.face_coef,
                                     scene.face_attr, coef, nodes, order)
