'''
The port's CUDA kernels against their plain torch versions, on the card.
Marked `cuda`: each test skips where torch.cuda.is_available() is false
(the CPU-only test run).  On a machine with the card:

    python -m pytest tests/test_torch_cuda_kernels.py -q -m cuda --noconftest

The cast kernels (dense, closest and blocked) are built with
--fmad=false, so on identical inputs they agree with the plain versions
bit for bit; the tolerances stated in chip_smoke.py (index and occlusion
on >= 99.99% of rays) hold with room.  The dense scene-level casts
(shade_kernel, any_kernel) walk each scene's box tree (fused_nodes) and
equal their plain versions on random rays, a ragged count and the
wavefront's own per-bounce rays on the five dense benchmark scenes and a
random 2,500-face table; their walk counters (dense_cast_visits) cover
the pairs blocked.leaf_pairs counts; the table-level intersect.cast_closest
/ cast_any launch only the flat kernels, which equal their plain versions
at the edges of their register blocking (two rays a thread) and face
ring: 1 ray, counts that fill no whole block, 1 face, a table that
fills no whole chunk and the 8,192-face limit, `avoid` on every face,
tmax 0, and a table whose face 0 occludes every ray (the block vote's
early exit).  The blocked kernels run on
cornell_highpoly(nu=48, nv=24, accel='blocked') (2,560 faces, 5 blocks,
a box tree of 80 leaves in 128 slots), at 64^2 camera rays and on a
random ragged batch, and on a two-block table built for an exact key tie
across blocks that the tree's nearest-first walk meets in the higher
block first (_tie_table).

The path megakernel against its plain twin (the wavefront on the same
uniforms) at 64x64, with tests/test_fused.py's tolerances: cornell and
cornell_monkey >= 95% of paths within 1e-3 absolute and means within 2e-3
relative; the textured, environment-lit and matball scenes (and a scene
with every Disney lobe and both light kinds) >= 95% within 2e-2 relative
to max(|ref|, 0.05) and means within 1e-2.  Half frames compose the full
frame bit for bit.  The explicit-ray head (fused_trace) fed the primary
head's camera rays and wanghash2(i, j) equals fused_trace_primary bit for
bit, and its plain twin at the gate above.  blocked_cast_closest is the
blocked shade pass's hit.  The megakernel's two casts walk the scene's box tree
(fused_nodes): an exact key tie across leaves goes to the lower face id
though the walk meets the higher first (_fused_tie_scene); its visit
counters (fused_trace_visits) cover at least the pairs blocked.leaf_pairs
counts on the twin's rays; a scene without its tree tables raises.
'''

import dataclasses

import numpy as np
import pytest
import torch

from ptina_tpu_torch.camera import camera_rays
from ptina_tpu_torch.engine import fused
from ptina_tpu_torch.engine.path import (render, render_sample, pixel_grid,
                                         path_trace)
from ptina_tpu_torch.film import new_film
from ptina_tpu_torch.intersect import blocked, dense_cast
from ptina_tpu_torch.intersect.plucker import pack_faces
from ptina_tpu_torch.utils import cuda_build
from ptina_tpu_torch.sampling import wanghash2
from ptina_tpu_torch.sampling.sobol import (pixel_rotation, sample_dims,
                                            sobol_block)
from ptina_tpu_torch.scene import (make_scene, compute_block_bounds,
                                   compute_node_bounds,
                                   precompute_tri_functionals, LIGHT_POINT,
                                   DEFAULT_MATERIAL, MATERIAL_PARAMS)
from ptina_tpu_torch.scenes import (cornell_box, cornell_monkey,
                                    cornell_highpoly, envlight_scene, matball,
                                    BENCH_CAMERA)
from ptina_tpu_torch.utils.vec import V3

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (CUDA kernels have no CPU mode)')
    return torch.device('cuda')


def _random_scene(nf, dev):
    rng = np.random.RandomState(nf)
    tris = (rng.randn(nf, 3, 3) * 2.0).astype(np.float32)
    verts = np.concatenate([tris.reshape(-1, 3),
                            np.tile([[0.0, 1.0, 0.0]], (nf * 3, 1)),
                            rng.rand(nf * 3, 2)], axis=1)
    return make_scene(verts, rng.randint(-1, 3, nf), device=dev)


def _rays(n, f, dev, seed=0):
    rng = np.random.RandomState(seed)
    o = np.stack([rng.uniform(-1.9, 1.9, n), rng.uniform(0.1, 3.9, n),
                  rng.uniform(-1.9, 1.9, n)], 1).astype(np.float32)
    d = rng.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    avoid = np.where(rng.rand(n) < 0.25, rng.randint(0, f, n), -1)
    tmax = rng.uniform(0.0, 6.0, n).astype(np.float32)

    def t(a, dt=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=dev)
    return (V3(t(o[:, 0]), t(o[:, 1]), t(o[:, 2])),
            V3(t(d[:, 0]), t(d[:, 1]), t(d[:, 2])),
            t(avoid, torch.int32), t(tmax))


def _small_scene(dev):
    '''50 small random triangles and a large floor face: a table of two
    leaves (kBoxes false) whose tree order is not the index order.'''
    rng = np.random.RandomState(9)
    nf = 50
    c = rng.uniform(-1.5, 1.5, (nf, 1, 3)) + [0.0, 2.0, 0.0]
    tris = (c + rng.uniform(-0.4, 0.4, (nf, 3, 3))).astype(np.float32)
    tris[0] = [[-2, 0, -2], [2, 0, -2], [2, 0, 2]]
    verts = np.concatenate([tris.reshape(-1, 3),
                            np.tile([[0.0, 1.0, 0.0]], (nf * 3, 1)),
                            np.zeros((nf * 3, 2))], axis=1)
    scene = make_scene(verts, device=dev)
    assert scene.fused_nodes.shape == (4, 8)
    assert not torch.equal(scene.fused_order.cpu(),
                           torch.arange(56, dtype=torch.int32))
    return scene


SCENES = {'cornell': lambda d: cornell_box(device=d),
          'cornell_monkey': lambda d: cornell_monkey(device=d),
          'cornell_textured': lambda d: cornell_box(textured_image=_texture(),
                                                    device=d),
          'envlight': lambda d: envlight_scene(device=d),
          'matball': lambda d: matball(roughness_tex=_texture(), device=d),
          'random_2500': lambda d: _random_scene(2500, d),
          'small_56': _small_scene}


def _tree(scene):
    return scene.fused_coef, scene.fused_nodes, scene.fused_order


def _hold_dense(scene, ro, rd, avoid, tmax):
    '''The tree kernels and the flat ones against their plain versions,
    bit for bit.'''
    c, at, tree = scene.face_coef, scene.face_attr, _tree(scene)
    hk, ak = dense_cast.cast_shade(ro, rd, avoid, c, at, *tree)
    hp, ap = dense_cast.cast_shade_plain(ro, rd, avoid, c, at)
    ok = dense_cast.cast_any(ro, rd, avoid, tmax, c, *tree)
    op = dense_cast.cast_any_plain(ro, rd, avoid, tmax, c)
    fk = dense_cast.cast_any_flat(ro, rd, avoid, tmax, c)
    ck = dense_cast.cast_closest(ro, rd, avoid, c)
    cp = dense_cast.cast_closest_plain(ro, rd, avoid, c)
    torch.cuda.synchronize()
    _assert_same_hit(hk, hp)
    assert torch.equal(ak, ap)
    assert torch.equal(ok, op) and torch.equal(fk, op)
    _assert_same_hit(ck, cp)
    _assert_same_hit(ck, hk)  # the shade kernel's hit, without attributes


@pytest.mark.parametrize('name', sorted(SCENES))
@pytest.mark.parametrize('n', [262144, 1001])
def test_kernels_match_plain(dev, name, n):
    scene = SCENES[name](dev)
    _hold_dense(scene, *_rays(n, scene.face_coef.shape[0], dev))


@pytest.mark.parametrize('name', sorted(set(SCENES)
                                         - {'random_2500', 'small_56'}))
def test_tree_kernels_match_plain_on_wavefront_rays(dev, name):
    '''The casts the wavefront makes: every bounce's closest cast (avoid
    the last hit, an original face id) and shadow cast of a 64x64 sample
    at depth 5.'''
    scene = SCENES[name](dev)
    lanes = []
    fused.fused_trace_primary_plain(scene, sobol_block(9, 32), 64, 64,
                                    lanes=lanes)
    for lane in lanes:
        _hold_dense(scene, lane['ro'], lane['rd'], lane['avoid'],
                    torch.full_like(lane['ro'].x, 5.0))
        _hold_dense(scene, lane['ro_sh'], lane['rd_sh'], lane['hit'].index,
                    lane['tmax'])


def test_tree_kernels_cross_leaf_tie(dev):
    '''The exact key tie across leaves goes to face 3, the lower id, as in
    the plain version, though the walk enters face 65's leaf first; with
    either copy avoided (an original id) the other is hit and occludes.'''
    scene, (ro, rd) = _fused_tie_scene(dev)
    n = ro.x.shape[0]
    tmax = torch.full((n,), 10.0, device=dev)
    for av in (-1, 3, 65):
        avoid = torch.full((n,), av, dtype=torch.int32, device=dev)
        _hold_dense(scene, ro, rd, avoid, tmax)
    hit, _ = dense_cast.cast_shade(ro, rd, torch.full_like(avoid, -1),
                                   scene.face_coef, scene.face_attr,
                                   *_tree(scene))
    assert hit.hit.all() and (hit.index == 3).all()
    shade, _ = dense_cast.dense_cast_visits(
        ro, rd, torch.full_like(avoid, -1), tmax, scene.face_coef,
        scene.face_attr, *_tree(scene))
    assert (shade[:, 1] >= 2).all()  # both copies' leaves were tested


@pytest.mark.parametrize('name', ['cornell', 'cornell_monkey', 'envlight'])
def test_dense_visits_and_pair_count(dev, name):
    '''The walk counters: a parked shadow ray (tmax 0) leaves at the root,
    the two-leaf cornell tests its leaves in order with no inner node,
    and the closest cast tests at least the leaves whose box a ray enters
    before its hit (blocked.leaf_pairs, the bound's count).'''
    scene = SCENES[name](dev)
    ro, rd, avoid, tmax = _rays(1001, scene.face_coef.shape[0], dev)
    tmax[:16] = 0.0
    c, at = scene.face_coef, scene.face_attr
    before = dict(dense_cast.LAUNCHES)
    shade, occ = dense_cast.dense_cast_visits(ro, rd, avoid, tmax, c, at,
                                              *_tree(scene))
    hit, _ = dense_cast.cast_shade(ro, rd, avoid, c, at, *_tree(scene))
    assert dense_cast.LAUNCHES['shade'] - before['shade'] == 2
    assert dense_cast.LAUNCHES['any'] - before['any'] == 1
    if name == 'cornell':
        assert (shade[:, 0] == 0).all() and (shade[:, 1] == 2).all()
    else:
        assert not occ[:16].any()
        assert (shade[:, 0] <= scene.fused_nodes.shape[0] // 2).all()
    pairs = blocked.leaf_pairs(ro, rd, scene.fused_nodes, int(scene.nfaces),
                               torch.where(hit.hit, hit.t, float('inf')),
                               True)
    assert (pairs <= blocked.LEAF_FACES * shade[:, 1]).all()


def test_tree_kernels_raise_without_their_tree(dev):
    '''No fallback to the flat loop: a missing, misshapen, CPU or
    misaligned tree table raises before any launch.'''
    scene = cornell_monkey(device=dev)
    ro, rd, avoid, tmax = _rays(64, scene.face_coef.shape[0], dev)
    f = scene.face_coef.shape[0]
    misaligned = torch.empty(f * 16 + 1, device=dev)[1:].view(f, 16)
    misaligned.copy_(scene.fused_coef)
    coef, nodes, order = _tree(scene)
    before = dict(dense_cast.LAUNCHES)
    for name, tree in (('tree_nodes', (coef, None, order)),
                       ('tree_nodes', (coef, nodes[:4], order)),
                       ('tree_order', (coef, nodes, order.cpu())),
                       ('tree_coef', (misaligned, nodes, order))):
        with pytest.raises(ValueError, match=name):
            dense_cast.cast_shade(ro, rd, avoid, scene.face_coef,
                                  scene.face_attr, *tree)
        with pytest.raises(ValueError, match=name):
            dense_cast.cast_any(ro, rd, avoid, tmax, scene.face_coef, *tree)
    assert dense_cast.LAUNCHES == before


def test_table_level_casts_launch_flat_kernels(dev):
    '''intersect.cast_closest / cast_any pack a bare table per call and
    launch the flat kernels, never the tree ones.'''
    from ptina_tpu_torch import intersect
    scene = cornell_monkey(device=dev)
    ro, rd, avoid, tmax = _rays(4099, scene.face_coef.shape[0], dev)
    before = dict(dense_cast.LAUNCHES)
    hit = intersect.cast_closest(ro, rd, scene.tri_w2b, avoid)
    occ = intersect.cast_any(ro, rd, scene.tri_w2b, avoid, tmax)
    torch.cuda.synchronize()
    grew = {k: v - before[k] for k, v in dense_cast.LAUNCHES.items()}
    assert grew == {'shade': 0, 'any': 0, 'closest': 1, 'any_flat': 1}
    _assert_same_hit(hit, dense_cast.cast_closest_plain(ro, rd, avoid,
                                                        scene.face_coef))
    assert torch.equal(occ, dense_cast.cast_any_plain(ro, rd, avoid, tmax,
                                                      scene.face_coef))


def _assert_same_hit(a, b):
    for k in ('hit', 'index', 't', 'u', 'v'):
        assert torch.equal(getattr(a, k), getattr(b, k)), k


def _flat_table(nf, dev, seed=0):
    '''A bare table of nf random faces, as dispatch.cast_closest packs
    one.'''
    rng = np.random.RandomState(seed)
    tris = (rng.randn(nf, 3, 3) * 2.0).astype(np.float32)
    return pack_faces(precompute_tri_functionals(torch.from_numpy(tris))
                      )[0].to(dev)


def _hold_flat(coef, ro, rd, avoid, tmax):
    '''The flat kernels against their plain versions, bit for bit.
    Returns the plain (Hit, occlusion).'''
    cp = dense_cast.cast_closest_plain(ro, rd, avoid, coef)
    op = dense_cast.cast_any_plain(ro, rd, avoid, tmax, coef)
    ck = dense_cast.cast_closest(ro, rd, avoid, coef)
    ok = dense_cast.cast_any_flat(ro, rd, avoid, tmax, coef)
    torch.cuda.synchronize()
    _assert_same_hit(ck, cp)
    assert torch.equal(ok, op)
    return cp, op


@pytest.mark.parametrize('nf', [1, 129, 8192])
@pytest.mark.parametrize('n', [1, 257, 1001, 100_003])
def test_flat_kernels_ragged_edges(dev, n, nf):
    '''Ray counts that fill no whole 256-ray block (and one ray), one
    face, a table that fills no whole 128-face chunk, and the limit.'''
    coef = _flat_table(nf, dev, seed=nf)
    _hold_flat(coef, *_rays(n, nf, dev, seed=n))


def test_flat_kernels_avoid_every_face_and_zero_tmax(dev):
    scene = cornell_monkey(device=dev)
    coef = scene.face_coef
    f = coef.shape[0]
    ro, rd, _, tmax = _rays(4 * f + 3, f, dev, seed=2)
    every = torch.arange(ro.x.shape[0], dtype=torch.int32, device=dev) % f
    first, _ = _hold_flat(coef, ro, rd, torch.full_like(every, -1), tmax)
    assert first.hit.float().mean().item() > 0.5
    _hold_flat(coef, ro, rd, every, tmax)
    second, _ = _hold_flat(coef, ro, rd, first.index.clone(), tmax)
    assert not bool((second.hit & (second.index == first.index)).any())
    _, occ = _hold_flat(coef, ro, rd, every, torch.zeros_like(tmax))
    assert not bool(occ.any())


def test_any_flat_early_exit_all_occluded(dev):
    '''Face 0 of a 2,049-face table (17 chunks) lies across every ray, so
    each block of rays is occluded after its first chunk and leaves at
    its vote, with copies still in flight; one block holds a parked ray
    (tmax 0), which keeps that block testing every face.'''
    rng = np.random.RandomState(8)
    nf, n = 2049, 5000
    tris = (rng.randn(nf, 3, 3) * 2.0).astype(np.float32)
    tris[0] = [[-50.0, -50.0, 0.0], [50.0, -50.0, 0.0], [0.0, 80.0, 0.0]]
    coef = pack_faces(precompute_tri_functionals(torch.from_numpy(tris))
                      )[0].to(dev)
    o = np.stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n),
                  np.full(n, -5.0)], 1).astype(np.float32)
    d = np.tile([[0.0, 0.0, 1.0]], (n, 1)) + rng.normal(0, 0.01, (n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    tmax = np.full(n, 100.0, np.float32)
    tmax[300] = 0.0

    def t(a, dt=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                               device=dev)
    ro = V3(t(o[:, 0]), t(o[:, 1]), t(o[:, 2]))
    rd = V3(t(d[:, 0]), t(d[:, 1]), t(d[:, 2]))
    _, occ = _hold_flat(coef, ro, rd, t(np.full(n, -1), torch.int32),
                        t(tmax))
    assert not bool(occ[300]) and int(occ.sum()) == n - 1


def test_explicit_ray_head(dev):
    '''fused_trace on the primary head's camera rays and wanghash2(i, j)
    equals fused_trace_primary bit for bit (64^2: the NDC divisions by a
    power of two are exact in either form), and its plain twin at the
    primary head's gate; one launch a call.'''
    for name in sorted(MEGA):
        make, relative = MEGA[name]
        scene = make(dev)
        res = 64
        pt = sobol_block(3, 32)
        ii, jj = pixel_grid(res, res, device=dev)
        u = torch.remainder(pt.to(dev)[:, None]
                            + pixel_rotation(ii, jj, 32), 1.0)
        x = (ii.to(torch.float32) + u[0]) / res * 2.0 - 1.0
        y = (jj.to(torch.float32) + u[1]) / res * 2.0 - 1.0
        ro, rd = camera_rays(scene.cam_v2w, x, y)
        base = wanghash2(ii, jj).to(torch.int32)
        before = fused.LAUNCHES['path']
        k = fused.fused_trace(scene, ro, rd, pt, base)
        assert fused.LAUNCHES['path'] - before == 1
        prim = fused.fused_trace_primary(scene, pt, res, res)
        p = fused.fused_trace_plain(scene, ro, rd, pt, base)
        torch.cuda.synchronize()
        for c in 'xyz':
            assert torch.equal(getattr(k, c), getattr(prim, c)), name
        _assert_close(k, p, relative)
    with pytest.raises(ValueError, match='base'):
        fused.fused_trace(scene, ro, rd, pt, base.to(torch.int64))


def test_blocked_closest_is_the_shade_hit(dev):
    scene = _blocked_scene(dev)
    ro, rd, avoid, _ = _rays(10_007, scene.face_coef.shape[0], dev, seed=4)
    tables = (scene.face_coef, scene.face_attr, scene.block_bounds,
              scene.node_bounds)
    before = dict(blocked.LAUNCHES)
    hit = blocked.blocked_cast_closest(ro, rd, avoid, *tables)
    torch.cuda.synchronize()
    assert blocked.LAUNCHES['blocked_shade'] - before['blocked_shade'] == 1
    _assert_same_hit(hit, blocked.blocked_cast_shade(ro, rd, avoid,
                                                     *tables)[0])
    _assert_same_hit(hit, blocked.blocked_cast_shade_plain(ro, rd, avoid,
                                                           *tables)[0])


def _blocked_scene(dev):
    scene = cornell_highpoly(nu=48, nv=24, accel='blocked', device=dev)
    assert scene.block_bounds.shape == (5, 8)
    assert scene.node_bounds.shape == (256, 8)
    return scene


def _tie_table(dev):
    '''A 1,024-face blocked table (two blocks, all-zero faces elsewhere)
    for an exact key tie across blocks: face 3 (block 0) and face 515
    (block 1, the same block-local id) are one triangle in the plane
    z = 0, and face 516, beside the rays' path at z = -3, pulls block 1's
    leaves nearer, so the tree's nearest-first walk tests block 1 first.
    64 rays from z = -5 straight up +z hit both copies at one t; the
    contract's winner is face 3.  Returns (coef, attr, block_bounds,
    node_bounds, (ro, rd, avoid)) on `dev`.'''
    f = 2 * 512
    tri = np.zeros((f, 3, 3), np.float32)
    tri[3] = tri[515] = [[-1.0, -1.0, 0.0], [2.0, -1.0, 0.0],
                         [-1.0, 2.0, 0.0]]
    tri[516] = [[9.0, 0.0, -3.0], [10.0, 0.0, -3.0], [9.0, 1.0, -3.0]]
    w2b = precompute_tri_functionals(torch.from_numpy(tri))
    coef, attr = pack_faces(w2b, torch.zeros((18, f)))
    rng = np.random.RandomState(5)
    n = 64
    xy = rng.uniform(-0.5, 0.5, (2, n)).astype(np.float32)

    def t(a, dt=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                               device=dev)
    rays = (V3(t(xy[0]), t(xy[1]), t(np.full(n, -5.0))),
            V3(t(np.zeros(n)), t(np.zeros(n)), t(np.ones(n))),
            t(np.full(n, -1), torch.int32))
    return (coef.to(dev), attr.to(dev), t(compute_block_bounds(tri, f)),
            t(compute_node_bounds(tri, f)), rays)


def _fused_tie_scene(dev):
    '''A 66-face dense scene (72 padded: a tree of four leaf slots, the
    smallest the megakernel walks with box tests) for an exact key tie
    across leaves: faces 3 and 65 are one triangle in the plane z = 0
    (material 0, red; material 1, green), 63 small faces lie far off at
    x ~ -20, and face 64, at z = 3 beside the rays' path, pulls the
    subtree of leaves 2-3 nearer.  fused_face_order puts face 3 in the
    last slot of leaf 1 and face 65 in the first of leaf 2, so a walk
    from z = 5 along -z tests face 65 first.  Returns (scene, (ro, rd)):
    64 such rays, whose contract winner is face 3.'''
    rng = np.random.RandomState(5)
    tri = np.zeros((66, 3, 3), np.float32)
    for i in [i for i in range(64) if i != 3]:
        c = (rng.uniform(-21, -19), rng.uniform(-2, 0.5), rng.uniform(-1, 1))
        tri[i] = np.asarray(c) + rng.uniform(-0.2, 0.2, (3, 3))
    tri[3] = tri[65] = [[-1.0, -1.0, 0.0], [2.0, -1.0, 0.0],
                        [-1.0, 2.0, 0.0]]
    tri[64] = [[9.0, 0.0, 3.0], [10.0, 0.0, 3.0], [9.0, 1.0, 3.0]]
    verts = np.zeros((66 * 3, 8), np.float32)
    verts[:, 0:3] = tri.reshape(-1, 3)
    verts[:, 3:6] = (0.0, 0.0, 1.0)
    mtl = np.full(66, -1, np.int32)
    mtl[3], mtl[65] = 0, 1
    base = [(DEFAULT_MATERIAL[k], None) for k in MATERIAL_PARAMS]
    mats = [[((0.9, 0.1, 0.1), None)] + base[1:],
            [((0.1, 0.9, 0.1), None)] + base[1:]]
    scene = make_scene(verts, mtl, materials=mats, device=dev)
    n = 64
    xy = rng.uniform(-0.5, 0.5, (2, n)).astype(np.float32)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32,
                               device=dev)
    return scene, (V3(t(xy[0]), t(xy[1]), t(np.full(n, 5.0))),
                   V3(t(np.zeros(n)), t(np.zeros(n)), t(-np.ones(n))))


def _camera_rays(scene, res, dev):
    ii, jj = pixel_grid(res, res, device=dev)
    x = (ii.to(torch.float32) + 0.5) / res * 2.0 - 1.0
    y = (jj.to(torch.float32) + 0.5) / res * 2.0 - 1.0
    ro, rd = camera_rays(scene.cam_v2w, x, y)
    n = res * res
    return (V3(*(c.contiguous() for c in (ro.x, ro.y, ro.z))),
            V3(*(c.contiguous() for c in (rd.x, rd.y, rd.z))),
            torch.full((n,), -1, dtype=torch.int32, device=dev),
            torch.full((n,), 5.0, device=dev))


@pytest.mark.parametrize('rays', ['camera_64x64', 'random_1001'])
def test_blocked_kernels_match_plain(dev, rays):
    scene = _blocked_scene(dev)
    if rays == 'camera_64x64':
        ro, rd, avoid, tmax = _camera_rays(scene, 64, dev)
    else:
        ro, rd, avoid, tmax = _rays(1001, scene.face_coef.shape[0], dev)
    args = (scene.face_coef, scene.face_attr, scene.block_bounds,
            scene.node_bounds)
    hk, ak = blocked.blocked_cast_shade(ro, rd, avoid, *args)
    hp, ap = blocked.blocked_cast_shade_plain(ro, rd, avoid, *args)
    tables = (scene.face_coef, scene.block_bounds, scene.node_bounds)
    ok = blocked.blocked_cast_any(ro, rd, avoid, tmax, *tables)
    op = blocked.blocked_cast_any_plain(ro, rd, avoid, tmax, *tables)
    torch.cuda.synchronize()
    assert hp.hit.float().mean().item() > 0.5
    _assert_same_hit(hk, hp)
    assert torch.equal(ak, ap)
    assert torch.equal(ok, op)


def test_blocked_kernels_cross_block_tie(dev):
    '''The exact key tie across blocks goes to the lower block, as in the
    plain version, though the walk meets the higher block first.'''
    coef, attr, bb, nodes, (ro, rd, avoid) = _tie_table(dev)
    hk, ak = blocked.blocked_cast_shade(ro, rd, avoid, coef, attr, bb, nodes)
    hp, ap = blocked.blocked_cast_shade_plain(ro, rd, avoid, coef, attr, bb,
                                              nodes)
    torch.cuda.synchronize()
    assert hk.hit.all() and (hk.index == 3).all()
    _assert_same_hit(hk, hp)
    assert torch.equal(ak, ap)
    # both leaves holding the triangle were tested: two leaves a ray
    shade, _ = blocked.blocked_cast_visits(ro, rd, avoid,
                                           torch.full_like(ro.x, 10.0),
                                           coef, attr, bb, nodes)
    assert (shade[:, 1] >= 2).all()


def test_blocked_visits_and_pair_count(dev):
    '''The traversal counters: a parked occlusion ray (tmax 0) leaves at
    the root, and the closest-hit kernel tests at least the leaves whose
    box a ray enters before its hit (leaf_pairs, the bound's count).'''
    scene = _blocked_scene(dev)
    ro, rd, avoid, tmax = _rays(1001, scene.face_coef.shape[0], dev)
    tmax[:16] = 0.0
    args = (scene.face_coef, scene.face_attr, scene.block_bounds,
            scene.node_bounds)
    shade, occ = blocked.blocked_cast_visits(ro, rd, avoid, tmax, *args)
    hit, _ = blocked.blocked_cast_shade(ro, rd, avoid, *args)
    assert not occ[:16].any()
    assert (shade[:, 0] <= scene.node_bounds.shape[0] // 2).all()
    pairs = blocked.leaf_pairs(ro, rd, scene.node_bounds,
                               int(scene.nfaces),
                               torch.where(hit.hit, hit.t, float('inf')),
                               True)
    assert (pairs <= blocked.LEAF_FACES * shade[:, 1]).all()


def test_blocked_build_or_launch_failure_raises(dev, monkeypatch):
    '''No fallback: a failed nvcc build and a failed launch both raise, and
    a failed launch counts nothing.'''
    scene = _blocked_scene(dev)
    ro, rd, avoid, tmax = _rays(64, scene.face_coef.shape[0], dev)
    shade = (ro, rd, avoid, scene.face_coef, scene.face_attr,
             scene.block_bounds, scene.node_bounds)
    real = cuda_build.build_shared_library

    def broken(stem, main, sources, flags=cuda_build.NVCC_FLAGS):
        return real(stem + '_broken', main, sources,
                    flags + ('--no-such-nvcc-option',))
    monkeypatch.setattr(blocked, 'build_shared_library', broken)
    blocked.build_library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match='nvcc failed'):
            blocked.blocked_cast_shade(*shade)
    finally:
        blocked.build_library.cache_clear()
    monkeypatch.undo()

    class FailingLib:
        @staticmethod
        def ptina_blocked_cast_shade(*_):
            return 700  # cudaErrorIllegalAddress

        ptina_blocked_cast_any = ptina_blocked_cast_shade
    monkeypatch.setattr(blocked, 'build_library', lambda: (FailingLib, ''))
    before = dict(blocked.LAUNCHES)
    with pytest.raises(RuntimeError, match='blocked_shade_kernel'):
        blocked.blocked_cast_shade(*shade)
    with pytest.raises(RuntimeError, match='blocked_any_kernel'):
        blocked.blocked_cast_any(ro, rd, avoid, tmax, scene.face_coef,
                                 scene.block_bounds, scene.node_bounds)
    assert blocked.LAUNCHES == before


def test_render_launches_blocked_kernels(dev):
    '''A blocked scene renders through the wavefront with the blocked
    casts: one launch of each per bounce, and no other cast or
    megakernel launch.'''
    scene = _blocked_scene(dev)
    assert not fused.fused_eligible(scene)
    counts = (dense_cast.LAUNCHES, blocked.LAUNCHES, fused.LAUNCHES)
    before = [dict(c) for c in counts]
    film = render(scene, new_film(64, 64, device=dev), 0, spp=2)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(film).all())
    grew = [{k: c[k] - b[k] for k in c} for c, b in zip(counts, before)]
    assert grew == [{'shade': 0, 'any': 0, 'closest': 0, 'any_flat': 0},
                    {'blocked_shade': 10, 'blocked_any': 10}, {'path': 0}]


@pytest.mark.parametrize('depth', [5, 8])
def test_render_launches_kernels(dev, depth):
    '''The wavefront route launches both tree casts once per bounce, and
    no flat cast; a non-Disney model takes it under fused=True too.'''
    for scene in (cornell_box(device=dev), cornell_monkey(device=dev)):
        before = dict(dense_cast.LAUNCHES), fused.LAUNCHES['path']
        film = new_film(64, 64, device=dev)
        for s in range(2):
            render_sample(scene, film, s, fused=False, max_depth=depth)
        render_sample(scene, film, 2, fused=True, model='lambert',
                      max_depth=depth)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(film).all())
        grew = {k: v - before[0][k] for k, v in dense_cast.LAUNCHES.items()}
        assert grew == {'shade': 3 * depth, 'any': 3 * depth, 'closest': 0,
                        'any_flat': 0}
        assert fused.LAUNCHES['path'] == before[1]


def _texture():
    return (np.linspace(0, 1, 64 * 64, dtype=np.float32)
            .reshape(64, 64, 1) * np.ones((1, 1, 3), np.float32))


def _all_lobes_scene(dev):
    '''Cornell geometry with every Disney lobe switched on somewhere
    (Materials.zero empty), a textured basecolor, and a point light beside
    the area light.'''
    base = cornell_box(textured_image=np.zeros((2, 2, 3), np.float32),
                       device='cpu')
    verts = np.concatenate([base.tri_pos.numpy().reshape(-1, 3)[:34 * 3],
                            base.tri_nrm.numpy().reshape(-1, 3)[:34 * 3],
                            base.tri_uv.numpy().reshape(-1, 2)[:34 * 3]], 1)
    mtl = base.tri_mtl.numpy()[:34].copy()
    mtl[22:] = 3

    def m(c, metal, rough, sub, sheen, coat, trans, tex=-1):
        return [(np.asarray(c, np.float32), tex), (metal, -1), (rough, -1),
                (0.5, -1), (0.3, -1), (sub, -1), (sheen, -1), (0.5, -1),
                (coat, -1), (0.7, -1), (trans, -1), (1.5, -1)]
    mats = [m((0.7, 0.7, 0.6), 0.0, 0.6, 0.5, 0.4, 0.0, 0.0, tex=0),
            m((0.6, 0.1, 0.1), 0.3, 0.3, 0.0, 0.0, 0.8, 0.0),
            m((0.1, 0.5, 0.1), 1.0, 0.25, 0.0, 0.3, 0.5, 0.0),
            m((0.9, 0.9, 0.9), 0.0, 0.1, 0.0, 0.0, 0.0, 0.9)]
    lights = [dict(color=(12, 12, 12), pos=(0.0, 3.98, 0.0), size=0.8,
                   type=2, axes=np.asarray([[1, 0, 0], [0, 0, 1],
                                            [0, -1, 0]], np.float32)),
              dict(color=(10, 8, 6), pos=(0.5, 3.0, 1.0), size=0.3,
                   type=LIGHT_POINT)]
    img = np.random.RandomState(1).rand(8, 8, 3).astype(np.float32)
    scene = make_scene(verts, mtl, materials=mats, images=[img],
                       cam_pers=BENCH_CAMERA, lights=lights,
                       world_fac=(0.2, 0.15, 0.1, 1.0), device=dev)
    assert scene.materials.zero == ()
    return scene


MEGA = {'cornell': (lambda d: cornell_box(device=d), False),
        'cornell_monkey': (lambda d: cornell_monkey(device=d), False),
        'cornell_textured': (lambda d: cornell_box(textured_image=_texture(),
                                                   device=d), True),
        'envlight': (lambda d: envlight_scene(device=d), True),
        'matball': (lambda d: matball(roughness_tex=_texture(), device=d),
                    True),
        'all_lobes': (_all_lobes_scene, True)}


def _assert_close(k, p, relative):
    k = torch.stack([k.x, k.y, k.z])
    p = torch.stack([p.x, p.y, p.z])
    assert bool(torch.isfinite(k).all())
    if relative:
        d = ((k - p).abs() / torch.clamp_min(p.abs(), 0.05)).amax(0)
        assert (d < 2e-2).float().mean().item() > 0.95
        assert abs(k.mean().item() - p.mean().item()) \
            < 1e-2 * max(p.mean().item(), 1e-6)
    else:
        d = (k - p).abs().amax(0)
        assert (d < 1e-3).float().mean().item() > 0.95
        assert abs(k.mean().item() - p.mean().item()) \
            < 2e-3 * max(p.mean().item(), 1e-6)


@pytest.mark.parametrize('name', sorted(MEGA))
def test_megakernel_matches_twin(dev, name):
    make, relative = MEGA[name]
    scene = make(dev)
    assert fused.fused_eligible(scene)
    res = 64
    for sample in (0, 7):
        pt = sobol_block(sample, 32)
        k = fused.fused_trace_primary(scene, pt, res, res)
        p = fused.fused_trace_primary_plain(scene, pt, res, res)
        torch.cuda.synchronize()
        _assert_close(k, p, relative)
    # the explicit-uniform head on the same rays and uniforms
    ii, jj = pixel_grid(res, res, device=dev)
    u = sample_dims(3, ii, jj, 32)
    x = (ii.to(torch.float32) + u[0]) / res * 2.0 - 1.0
    y = (jj.to(torch.float32) + u[1]) / res * 2.0 - 1.0
    ro, rd = camera_rays(scene.cam_v2w, x, y)
    k = fused.fused_trace_uniforms(scene, ro, rd, u)
    p = fused.fused_trace_uniforms_plain(scene, ro, rd, u)
    torch.cuda.synchronize()
    _assert_close(k, p, relative)


@pytest.mark.parametrize('name', sorted(MEGA))
def test_megakernel_depth_8_matches_twin(dev, name):
    '''max_depth 8: a 50-dimension Sobol point in the launch parameters.'''
    make, relative = MEGA[name]
    scene = make(dev)
    pt = sobol_block(4, 2 + 6 * 8)
    k = fused.fused_trace_primary(scene, pt, 64, 64)
    p = fused.fused_trace_primary_plain(scene, pt, 64, 64)
    torch.cuda.synchronize()
    _assert_close(k, p, relative)


def test_megakernel_half_frames(dev):
    scene = matball(roughness_tex=_texture(), device=dev)
    pt = sobol_block(5, 32)
    full = fused.fused_trace_primary(scene, pt, 64, 64)
    top = fused.fused_trace_primary(scene, pt, 32, 64, x0=0, fnx=64, fny=64)
    bot = fused.fused_trace_primary(scene, pt, 32, 64, x0=32, fnx=64, fny=64)
    for c in 'xyz':
        assert torch.equal(getattr(full, c),
                           torch.cat([getattr(top, c), getattr(bot, c)]))


def test_megakernel_ragged_offset_tile(dev):
    '''A tile whose path count is no multiple of the block, at an offset
    inside a larger non-square film: the pixel decode and the ragged
    edge.'''
    scene = cornell_box(device=dev)
    pt = sobol_block(2, 32)
    kw = dict(x0=5, y0=3, fnx=64, fny=48)
    k = fused.fused_trace_primary(scene, pt, 37, 29, **kw)
    p = fused.fused_trace_primary_plain(scene, pt, 37, 29, **kw)
    torch.cuda.synchronize()
    assert k.x.shape == (37 * 29,)
    _assert_close(k, p, relative=False)


def test_render_launches_megakernel(dev):
    '''An eligible scene renders through the megakernel: one launch per
    sample and no cast launches.'''
    scene = cornell_monkey(device=dev)
    before = (fused.LAUNCHES['path'], dict(dense_cast.LAUNCHES))
    film = render(scene, new_film(64, 64, device=dev), 0, spp=3)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(film).all()) and bool((film[0, 3] == 3).all())
    assert fused.LAUNCHES['path'] - before[0] == 3
    assert dict(dense_cast.LAUNCHES) == before[1]


def test_megakernel_raises_for_ineligible_scene(dev):
    scene = cornell_box(device=dev)
    scene.accel = 'blocked'
    with pytest.raises(ValueError, match='eligible'):
        fused.fused_trace_primary(scene, sobol_block(0, 32), 8, 8)


def _stack3(v):
    return torch.stack([v.x, v.y, v.z])


def test_megakernel_cross_leaf_tie(dev):
    '''The exact key tie across the tree's leaves goes to face 3, the
    lower id, as in the twin, though the walk enters face 65's leaf
    first: the paths take face 3's red material.'''
    scene, (ro, rd) = _fused_tie_scene(dev)
    n = ro.x.shape[0]
    u = torch.as_tensor(np.random.RandomState(6).rand(32, n),
                        dtype=torch.float32, device=dev)
    k = fused.fused_trace_uniforms(scene, ro, rd, u)
    lanes = []
    p = path_trace(scene, ro, rd, u, lanes=lanes)
    torch.cuda.synchronize()
    assert (lanes[0]['hit'].index == 3).all()
    assert (k.x > k.y).all()
    _assert_close(k, p, relative=False)


def test_megakernel_visit_counters(dev):
    '''fused_trace_visits: the radiance is the kernel's, a counter is
    written for exactly the casts the twin makes, a hit tests at least
    one leaf, and the leaves a cast tests hold at least the pairs
    blocked.leaf_pairs counts on the twin's rays (closest casts up to
    their hit, clear shadow rays up to tmax).'''
    scene = cornell_monkey(device=dev)
    pt = sobol_block(9, 32)
    before = fused.LAUNCHES['path']
    rad, vis = fused.fused_trace_visits(scene, pt, 64, 64)
    ref = fused.fused_trace_primary(scene, pt, 64, 64)
    lanes = []
    fused.fused_trace_primary_plain(scene, pt, 64, 64, lanes=lanes)
    torch.cuda.synchronize()
    assert fused.LAUNCHES['path'] - before == 2
    assert torch.equal(_stack3(rad), _stack3(ref))
    assert vis.shape == (64 * 64, 5, 2, 2)
    nf, nodes = int(scene.nfaces), scene.fused_nodes
    inf = torch.tensor(float('inf'), device=dev)
    for b, lane in enumerate(lanes):
        closest, shadow = vis[:, b, 0], vis[:, b, 1]
        assert torch.equal(closest[:, 0] >= 0, lane['alive'])
        assert torch.equal(shadow[:, 0] >= 0, lane['shadow'])
        hit = lane['hit']
        made = lane['alive']
        assert (closest[made & hit.hit, 1] >= 1).all()
        pairs = blocked.leaf_pairs(lane['ro'], lane['rd'], nodes, nf,
                                   torch.where(hit.hit, hit.t, inf), True)
        assert (pairs[made] <= blocked.LEAF_FACES * closest[made, 1]).all()
        clear = lane['shadow'] & ~lane['occ']
        pairs = blocked.leaf_pairs(lane['ro_sh'], lane['rd_sh'], nodes, nf,
                                   torch.clamp_max(lane['tmax'], 1e6), False)
        assert (pairs[clear] <= blocked.LEAF_FACES * shadow[clear, 1]).all()


def test_megakernel_raises_without_its_tree(dev):
    '''No fallback to the flat loop or the wavefront: a scene whose tree
    tables are missing, misshapen, of another type or misaligned raises
    before any launch.'''
    scene = cornell_box(device=dev)
    f = scene.face_coef.shape[0]
    misaligned = torch.empty(f * 16 + 1, device=dev)[1:].view(f, 16)
    misaligned.copy_(scene.fused_coef)
    pt = sobol_block(0, 32)
    before = fused.LAUNCHES['path']
    for name, bad in (('fused_nodes', None), ('fused_order', None),
                      ('fused_nodes', scene.fused_nodes[:2]),
                      ('fused_order', scene.fused_order.long()),
                      ('fused_coef', scene.fused_coef.cpu()),
                      ('fused_coef', misaligned)):
        broken = dataclasses.replace(scene, **{name: bad})
        with pytest.raises(ValueError, match=name):
            fused.fused_trace_primary(broken, pt, 8, 8)
    assert fused.LAUNCHES['path'] == before
