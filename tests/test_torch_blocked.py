'''
Parity of the PyTorch port's big-scene route with the JAX reference: the
Morton-ordered block scene build (ptina_tpu_torch.scene / scenes.
cornell_highpoly), the blocked casts' plain versions (the twins of the
CUDA kernels in csrc/blocked_cast.cu) and the hit-only
blocked_cast_closest against the JAX blocked Pallas kernels in interpret
mode and against JAX brute, the table-level closest
cast (kernel #1) against pallas_cast_closest in interpret mode, and a
blocked render against the JAX render of the same scene.  The port's own
box tree (Scene.node_bounds, which the CUDA kernels walk) is checked
against the faces it bounds, and the kernels' culling through its torch
twin (blocked.box_entries): the leaf of brute's winner is never pruned.

Tolerances (the reference's own, or about twice the worst reading):
  * blocked casts (tests/test_blocked.py:87-136): hit, index, the
    material channel and occlusion exact; t rtol 5e-4 atol 1e-5 (the
    block-local key's 2^-12 grid); u at test_blocked.py's rtol 1e-4
    atol 1e-5.  On the cluster scene (39 hits in 96 rays) the readings
    are 3.0e-5 against the JAX blocked kernel and 1.4e-5 against brute,
    at most 0.45 of that limit.  v, which test_blocked.py does not hold,
    is held to atol 2.5e-4 there: the readings are 1.06e-4 against the
    JAX kernel and 1.87e-4 against brute, and the JAX kernel's own v
    lies 8.1e-5 from brute's.  The contract's v = (cv . p) / B cancels
    on small triangles far from the world origin, so the one-ulp
    differences between XLA's and torch's rounding of the coefficients
    and ray features grow there (both sides cast on identical tri_w2b).
    On the 101,888-face scene u and v equal the reference's own
    reconstruction of brute's winner (finish_extraction) exactly and are
    held to rtol 1e-4 atol 1e-5; against brute's Moller-Trumbore u they
    differ by up to 9.8e-4 (a 0.02-unit face of the sphere; the
    reference's blocked cast computes the same), held to atol 2e-3
    (UV_BRUTE) in that test only;
  * table-level casts (tests/test_intersect.py:127-170): hit and index
    exact, t rtol 5e-4, u rtol 1e-3, occlusion exact;
  * render (tests/test_torch_render.py): means within 1%, >= 98% of
    pixels within 1e-3 * (1 + |ref|).
'''

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ptina_tpu import scenes as jscenes
from ptina_tpu.scene import (make_scene as jmake_scene,
                             morton_face_order as jmorton_face_order,
                             precompute_tri_functionals as jfunctionals)
from ptina_tpu.film import new_film as jnew_film, film_to_image as jto_image
from ptina_tpu.engine.path import render as jrender
from ptina_tpu.intersect import brute as jbrute
from ptina_tpu.intersect.blocked import (blocked_cast_shade as jblocked_shade,
                                         blocked_cast_closest as
                                         jblocked_closest,
                                         blocked_cast_any as jblocked_any)
from ptina_tpu.intersect.pallas_cast import (pallas_cast_closest,
                                             pallas_cast_any)
from ptina_tpu.intersect.plucker import (pack_extract, finish_extraction,
                                         ray_features as jray_features)
from ptina_tpu.utils.vec import V3 as JV3
from ptina_tpu_torch import scenes as tscenes
from ptina_tpu_torch.scene import (make_scene, morton_face_order,
                                   scene_from_numpy, BLOCK_FACES, LEAF_FACES)
from ptina_tpu_torch.film import new_film, film_to_image
from ptina_tpu_torch.engine.path import render
from ptina_tpu_torch.intersect import blocked, dense_cast, dispatch
from ptina_tpu_torch.intersect import brute as tbrute
from ptina_tpu_torch.intersect.blocked import box_entries, leaf_pairs
from ptina_tpu_torch.utils.vec import V3

from test_torch_cuda_kernels import _tie_table
from test_torch_scene import jax_scene_arrays

torch.set_num_threads(2)

# tri_w2b is computed with float32 ops in each framework; their rounding
# differs by an ulp (the tolerance of test_torch_scene.py).  Every other
# table, the face order and the block boxes are bit-equal.
W2B_ATOL = 1e-6
EXACT = ('tri_pos', 'tri_nrm', 'tri_uv', 'tri_mtl', 'tri_attrs', 'nfaces',
         'block_bounds')
# u, v tolerances (rtol, atol); the readings are in the module docstring
UV_REF = (1e-4, 1e-5)  # tests/test_blocked.py's
V_CLUSTER = (0.0, 2.5e-4)
UV_BRUTE = (0.0, 2e-3)


def _cluster_verts(nfaces=700, seed=0):
    '''tests/test_blocked.py's scene: random triangle clusters far apart.'''
    rng = np.random.default_rng(seed)
    ncl = 7
    centers = rng.uniform(-20, 20, (ncl, 3)).astype(np.float32)
    v0 = centers[rng.integers(0, ncl, nfaces)] + rng.normal(
        0, 0.8, (nfaces, 3)).astype(np.float32)
    e1 = rng.normal(0, 0.5, (nfaces, 3)).astype(np.float32)
    e2 = rng.normal(0, 0.5, (nfaces, 3)).astype(np.float32)
    tri = np.stack([v0, v0 + e1, v0 + e2], axis=1)
    verts = np.zeros((nfaces * 3, 8), np.float32)
    verts[:, 0:3] = tri.reshape(-1, 3)
    verts[:, 3:6] = (0.0, 0.0, 1.0)
    return verts


def _cpu(pkg):
    '''The port's scene functions default to the card; its tests build on
    the CPU.'''
    return {} if pkg is jscenes else {'device': 'cpu'}


SCENES = {
    'cornell_highpoly': lambda pkg: pkg.cornell_highpoly(**_cpu(pkg)),
    'cornell_highpoly_48x24_blocked': lambda pkg: pkg.cornell_highpoly(
        nu=48, nv=24, accel='blocked', **_cpu(pkg)),
    'cluster_700': lambda pkg: (jmake_scene if pkg is jscenes
                                else make_scene)(_cluster_verts(),
                                                 accel='blocked',
                                                 **_cpu(pkg)),
}

_BUILT = {}


def _scenes(name):
    '''(JAX scene, port scene), each built once per test process.'''
    if name not in _BUILT:
        _BUILT[name] = (SCENES[name](jscenes), SCENES[name](tscenes))
    return _BUILT[name]


def _cast_scenes(name):
    '''(JAX scene, the port's scene from its arrays): the casts compare on
    identical faces (the two builds' tri_w2b differ by an ulp, which the
    contract's u, v amplify on small triangles).'''
    key = name + '/arrays'
    if key not in _BUILT:
        js = _scenes(name)[0]
        _BUILT[key] = (js, scene_from_numpy(jax_scene_arrays(js),
                                            device='cpu'))
    return _BUILT[key]


@pytest.mark.parametrize('name', sorted(SCENES))
def test_block_scene_matches_reference(name):
    '''Morton order, BLOCK_FACES padding and block_bounds as the JAX
    make_scene builds them.'''
    js, ts = _scenes(name)
    f = ts.tri_w2b.shape[0]
    assert f % BLOCK_FACES == 0
    assert ts.block_bounds.shape == (f // BLOCK_FACES, 8)
    for k in EXACT:
        ref = np.asarray(getattr(js, k))
        got = getattr(ts, k).numpy()
        assert ref.dtype == got.dtype and ref.shape == got.shape, k
        np.testing.assert_array_equal(got, ref, err_msg=k)
    np.testing.assert_allclose(ts.tri_w2b.numpy(), np.asarray(js.tri_w2b),
                               rtol=0, atol=W2B_ATOL)
    if name == 'cornell_highpoly':
        assert int(ts.nfaces) == 101782 and f == 101888 and f // 512 == 199
    # scene_from_numpy derives the same boxes from the JAX arrays
    tn = scene_from_numpy(jax_scene_arrays(js), device='cpu')
    assert torch.equal(tn.block_bounds, ts.block_bounds)
    assert torch.equal(tn.node_bounds, ts.node_bounds)


def test_morton_order_matches_reference():
    rng = np.random.default_rng(3)
    for n in (333, 4096):
        tri = rng.normal(0, 5, (n, 3, 3)).astype(np.float32)
        np.testing.assert_array_equal(morton_face_order(tri),
                                      jmorton_face_order(tri))


def _rays(o, d):
    o = np.asarray(o, np.float32)
    d = np.asarray(d, np.float32)
    j = (JV3(*(jnp.asarray(o[:, k]) for k in range(3))),
         JV3(*(jnp.asarray(d[:, k]) for k in range(3))))
    t = (V3(*(torch.from_numpy(o[:, k].copy()) for k in range(3))),
         V3(*(torch.from_numpy(d[:, k].copy()) for k in range(3))))
    return j, t


def _cluster_rays(n=96, seed=1):
    '''tests/test_blocked.py's rays, half of them aimed at a random face's
    first corner so that enough of them hit (its own hit 1 of 96).'''
    rng = np.random.default_rng(seed)
    o = rng.uniform(-30, 30, (n, 3)).astype(np.float32)
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    corners = _cluster_verts()[0::3, 0:3]
    aim = corners[rng.integers(0, corners.shape[0], n // 2)]
    d[:n // 2] = aim + rng.normal(0, 0.2, aim.shape) - o[:n // 2]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _shade(ts, tro, trd, avoid):
    return blocked.blocked_cast_shade(tro, trd, torch.from_numpy(avoid),
                                      ts.face_coef, ts.face_attr,
                                      ts.block_bounds, ts.node_bounds)


def _assert_hits(got, ref, u_tol=UV_REF, v_tol=UV_REF):
    hit = np.asarray(ref.hit)
    np.testing.assert_array_equal(got.hit.numpy(), hit)
    np.testing.assert_array_equal(got.index.numpy(), np.asarray(ref.index))
    np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(ref.t)[hit],
                               rtol=5e-4, atol=1e-5)
    for a, b, (rtol, atol) in ((got.u, ref.u, u_tol),
                               (got.v, ref.v, v_tol)):
        np.testing.assert_allclose(a.numpy()[hit], np.asarray(b)[hit],
                                   rtol=rtol, atol=atol)
    assert (got.t.numpy()[~hit] == 1e6).all()
    return hit


def test_blocked_shade_matches_reference():
    '''Against the JAX blocked kernel (interpret mode) and brute, with a
    quarter of the rays avoiding a random face.'''
    js, ts = _cast_scenes('cluster_700')
    o, d = _cluster_rays()
    (jro, jrd), (tro, trd) = _rays(o, d)
    rng = np.random.RandomState(4)
    avoid = np.where(rng.rand(96) < 0.25, rng.randint(0, 700, 96),
                     -1).astype(np.int32)
    ref, ref_att = jblocked_shade(jro, jrd, js.t5b, js.attrsb,
                                  js.block_bounds, jnp.asarray(avoid),
                                  interpret=True)
    got, att = _shade(ts, tro, trd, avoid)
    hit = _assert_hits(got, ref, v_tol=V_CLUSTER)
    assert 0.2 < hit.mean()
    # the material channel (-1 on this scene) and the other attributes
    np.testing.assert_array_equal(np.rint(att.numpy()[5]),
                                  np.rint(np.asarray(ref_att)[5]))
    np.testing.assert_allclose(att.numpy(), np.asarray(ref_att), rtol=0,
                               atol=1e-4)
    bref = jbrute.cast_closest(jro, jrd, js.tri_w2b, jnp.asarray(avoid))
    _assert_hits(got, bref, v_tol=V_CLUSTER)


def test_blocked_any_matches_reference():
    js, ts = _cast_scenes('cluster_700')
    o, d = _cluster_rays(seed=5)
    (jro, jrd), (tro, trd) = _rays(o, d)
    avoid = np.full(96, -1, np.int32)
    tmax = np.full(96, 25.0, np.float32)
    tmax[:4] = 0.0   # parked shadow rays
    tmax[4:8] = 3e6  # beyond the far clip
    ref = jblocked_any(jro, jrd, js.t5b, js.block_bounds, jnp.asarray(avoid),
                       jnp.asarray(tmax), interpret=True)
    got = blocked.blocked_cast_any(tro, trd, torch.from_numpy(avoid),
                                   torch.from_numpy(tmax), ts.face_coef,
                                   ts.block_bounds, ts.node_bounds)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    bref = jbrute.cast_any(jro, jrd, js.tri_w2b, jnp.asarray(avoid),
                           jnp.asarray(tmax))
    np.testing.assert_array_equal(got.numpy(), np.asarray(bref))
    assert 0.05 < got.numpy().mean() < 1.0 and not got.numpy()[:4].any()


def test_blocked_closest_matches_reference():
    '''blocked_cast_closest, the hit-only view of the shade pass, on the
    5-block cornell_highpoly(nu=48, nv=24, accel='blocked') against the
    JAX one (its blocked kernel in interpret mode), rays from inside the
    box, a quarter avoiding a random face; and equal to the shade pass's
    own hit bit for bit.'''
    js, ts = _cast_scenes('cornell_highpoly_48x24_blocked')
    rng = np.random.RandomState(12)
    n = 96
    o = np.stack([rng.uniform(-1.9, 1.9, n), rng.uniform(0.1, 3.9, n),
                  rng.uniform(-1.9, 1.9, n)], 1)
    d = rng.randn(n, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    (jro, jrd), (tro, trd) = _rays(o, d)
    f = int(ts.nfaces)
    avoid = np.where(rng.rand(n) < 0.25, rng.randint(0, f, n),
                     -1).astype(np.int32)
    ref = jblocked_closest(jro, jrd, js.t5b, js.attrsb, js.block_bounds,
                           jnp.asarray(avoid), interpret=True)
    got = blocked.blocked_cast_closest(tro, trd, torch.from_numpy(avoid),
                                       ts.face_coef, ts.face_attr,
                                       ts.block_bounds, ts.node_bounds)
    hit = _assert_hits(got, ref)
    assert hit.mean() > 0.8  # the box is open at the front
    shade, _ = _shade(ts, tro, trd, avoid)
    for k in ('hit', 't', 'index', 'u', 'v'):
        assert torch.equal(getattr(got, k), getattr(shade, k)), k


def test_blocked_avoid_excludes_self():
    _, ts = _cast_scenes('cluster_700')
    _, (tro, trd) = _rays(*_cluster_rays())
    first, _ = _shade(ts, tro, trd, np.full(96, -1, np.int32))
    second, _ = _shade(ts, tro, trd, first.index.numpy())
    both = (first.hit & second.hit).numpy()
    assert both.any()
    assert (first.index.numpy()[both] != second.index.numpy()[both]).all()
    # the winner shadows a ray with tmax just past it, and nothing else
    # lies before it on the key's t grid
    none = torch.full((96,), -1, dtype=torch.int32)
    occ = blocked.blocked_cast_any(tro, trd, none, first.t * 1.001,
                                   ts.face_coef, ts.block_bounds,
                                   ts.node_bounds)
    assert occ.numpy()[first.hit.numpy()].all()
    occ = blocked.blocked_cast_any(tro, trd, first.index, first.t,
                                   ts.face_coef, ts.block_bounds,
                                   ts.node_bounds)
    assert not occ.numpy().any()


def test_big_scene_casts_match_brute():
    '''256 rays on the 101,888-face scene (199 blocks) against JAX brute,
    among them rays that hit a wall on its block's box plane.'''
    js, ts = _cast_scenes('cornell_highpoly')
    rng = np.random.RandomState(9)
    n = 256
    o = np.stack([rng.uniform(-1.9, 1.9, n), rng.uniform(0.1, 3.9, n),
                  rng.uniform(-1.9, 1.9, n)], 1)
    d = rng.randn(n, 3)
    d[:32] = [0.0, -1.0, 0.0]  # straight down onto the floor plane y = 0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    (jro, jrd), (tro, trd) = _rays(o, d)
    avoid = np.full(n, -1, np.int32)
    ref = jbrute.cast_closest(jro, jrd, js.tri_w2b, jnp.asarray(avoid))
    got, att = _shade(ts, tro, trd, avoid)
    hit = _assert_hits(got, ref, UV_BRUTE, UV_BRUTE)
    assert hit.mean() > 0.9
    # u, v as the reference's blocked cast rebuilds them for this winner
    ext = pack_extract(js.tri_w2b, js.tri_attrs)[:, np.maximum(
        np.asarray(ref.index), 0)]
    q = jray_features(jnp.stack([jro.x, jro.y, jro.z, jnp.ones(n)]),
                      jnp.stack([jrd.x, jrd.y, jrd.z, jnp.zeros(n)]))
    u, v, _ = finish_extraction(ext, q, interp=True, n_attr=6)
    _assert_hits(got, type(ref)(hit=ref.hit, t=ref.t, index=ref.index,
                                u=u[0], v=v[0]))
    # wall hits on a box plane: the floor (y = 0) is its blocks' lower face
    pos_y = o[:, 1] + d[:, 1] * got.t.numpy()
    floor = hit & (np.abs(pos_y) < 1e-4)
    assert floor.sum() >= 8
    lo_y = ts.block_bounds.numpy()[got.index.numpy()[floor] // BLOCK_FACES, 1]
    assert (lo_y == 0.0).all()
    mtl = np.asarray(js.tri_mtl)[np.maximum(np.asarray(ref.index), 0)]
    np.testing.assert_array_equal(np.rint(att.numpy()[5])[hit], mtl[hit])
    tmax = (np.asarray(ref.t) * rng.uniform(0.5, 1.5, n)).astype(np.float32)
    occ = blocked.blocked_cast_any(tro, trd, torch.from_numpy(avoid),
                                   torch.from_numpy(tmax), ts.face_coef,
                                   ts.block_bounds, ts.node_bounds)
    occ_ref = jbrute.cast_any(jro, jrd, js.tri_w2b, jnp.asarray(avoid),
                              jnp.asarray(tmax))
    np.testing.assert_array_equal(occ.numpy(), np.asarray(occ_ref))


@pytest.mark.parametrize('nf', [37, 2100])
def test_table_level_casts_match_pallas(nf):
    '''dispatch.cast_closest / cast_any (the closest and occlusion kernels'
    plain versions on the CPU) against the JAX Pallas kernels in
    interpret mode.'''
    rng = np.random.RandomState(nf)
    tris = (rng.randn(nf, 3, 3) * 2.0).astype(np.float32)
    w2b = np.array(jfunctionals(jnp.asarray(tris)))
    n = 160
    o = rng.randn(n, 3) * 3
    d = rng.randn(n, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    (jro, jrd), (tro, trd) = _rays(o, d)
    avoid = np.where(rng.rand(n) < 0.25, rng.randint(0, nf, n),
                     -1).astype(np.int32)
    tmax = rng.uniform(0.0, 6.0, n).astype(np.float32)
    before = dict(dense_cast.LAUNCHES)
    ref = pallas_cast_closest(jro, jrd, jnp.asarray(w2b), jnp.asarray(avoid),
                              interpret=True)
    got = dispatch.cast_closest(tro, trd, torch.from_numpy(w2b),
                                torch.from_numpy(avoid))
    hit = np.asarray(ref.hit)
    np.testing.assert_array_equal(got.hit.numpy(), hit)
    np.testing.assert_array_equal(got.index.numpy(), np.asarray(ref.index))
    np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(ref.t)[hit],
                               rtol=5e-4)
    np.testing.assert_allclose(got.u.numpy()[hit], np.asarray(ref.u)[hit],
                               rtol=1e-3, atol=1e-4)
    assert 0.2 < hit.mean()
    occ_ref = pallas_cast_any(jro, jrd, jnp.asarray(w2b), jnp.asarray(avoid),
                              jnp.asarray(tmax), interpret=True)
    occ = dispatch.cast_any(tro, trd, torch.from_numpy(w2b),
                            torch.from_numpy(avoid), torch.from_numpy(tmax))
    np.testing.assert_array_equal(occ.numpy(), np.asarray(occ_ref))
    # [N, 3] rays are taken as the reference's _as_v3 takes them
    rows = dispatch.cast_closest(torch.from_numpy(o.astype(np.float32)),
                                 torch.from_numpy(d.astype(np.float32)),
                                 torch.from_numpy(w2b),
                                 torch.from_numpy(avoid))
    assert torch.equal(rows.index, got.index)
    assert dense_cast.LAUNCHES == before  # CPU: plain versions only


def test_blocked_render_matches_reference():
    '''cornell_highpoly(nu=48, nv=24, accel='blocked') (2,230 faces in 5
    blocks) at 32x32 x 2 spp, from the JAX scene's arrays, against the
    JAX render, which on the CPU runs the blocked kernels in interpret
    mode.  Measured: 100% of pixels within tolerance.'''
    js, scene = _cast_scenes('cornell_highpoly_48x24_blocked')
    ref = np.asarray(jto_image(jrender(js, jnew_film(32, 32), 0,
                                       spp=2)))[..., :3]
    assert dispatch._route(scene) == 'blocked'
    before = (dict(dense_cast.LAUNCHES), dict(blocked.LAUNCHES))
    got = film_to_image(render(scene, new_film(32, 32, device='cpu'), 0,
                               spp=2))
    got = got[..., :3].numpy()
    assert (dict(dense_cast.LAUNCHES), dict(blocked.LAUNCHES)) == before
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert abs(got.mean() - ref.mean()) / ref.mean() < 0.01
    close = (np.abs(got - ref) <= 1e-3 * (1.0 + np.abs(ref))).all(-1)
    assert close.mean() >= 0.98, close.mean()


def test_blocked_wrappers_validate_operands():
    _, ts = _cast_scenes('cluster_700')
    _, (tro, trd) = _rays(*_cluster_rays(n=16))
    avoid = torch.full((16,), -1, dtype=torch.int32)
    nodes = ts.node_bounds
    with pytest.raises(ValueError, match='block_bounds'):
        blocked.blocked_cast_shade(tro, trd, avoid, ts.face_coef,
                                   ts.face_attr, ts.block_bounds[:1], nodes)
    with pytest.raises(ValueError, match='block_bounds'):
        blocked.blocked_cast_any(tro, trd, avoid, torch.ones(16),
                                 ts.face_coef, ts.block_bounds.double(),
                                 nodes)
    with pytest.raises(ValueError, match='attr'):
        blocked.blocked_cast_shade(tro, trd, avoid, ts.face_coef,
                                   ts.face_attr[:, :6], ts.block_bounds,
                                   nodes)
    with pytest.raises(ValueError, match='avoid'):
        blocked.blocked_cast_any(tro, trd, avoid.long(), torch.ones(16),
                                 ts.face_coef, ts.block_bounds, nodes)
    # the tree: 2P rows of 8 float32, P = 32 leaf slots for 1,024 faces
    assert nodes.shape == (64, 8)
    with pytest.raises(ValueError, match='node_bounds'):
        blocked.blocked_cast_shade(tro, trd, avoid, ts.face_coef,
                                   ts.face_attr, ts.block_bounds, nodes[:32])
    with pytest.raises(ValueError, match='node_bounds'):
        blocked.blocked_cast_any(tro, trd, avoid, torch.ones(16),
                                 ts.face_coef, ts.block_bounds,
                                 nodes.double())
    with pytest.raises(ValueError, match='node_bounds'):
        blocked.blocked_cast_shade(tro, trd, avoid, ts.face_coef,
                                   ts.face_attr, ts.block_bounds,
                                   nodes.to('meta'))
    with pytest.raises(ValueError, match='CUDA'):
        blocked.blocked_cast_visits(tro, trd, avoid, torch.ones(16),
                                    ts.face_coef, ts.face_attr,
                                    ts.block_bounds, nodes)


# ---------------------------------------------------------------- box tree

def _ragged_scene():
    '''cornell_monkey's dense arrays (984 faces in build order) forced to
    accel='blocked': a ragged last block of 472 faces and a ragged last
    leaf of 24.'''
    if 'ragged_984' not in _BUILT:
        arrays = jax_scene_arrays(jscenes.cornell_monkey())
        arrays['accel'] = 'blocked'
        _BUILT['ragged_984'] = scene_from_numpy(arrays, device='cpu')
    return _BUILT['ragged_984']


# name -> (the port's scene, the tree's depth log2(P))
TREES = {
    'cornell_highpoly': (lambda: _cast_scenes('cornell_highpoly')[1], 12),
    'cornell_highpoly_48x24_blocked': (
        lambda: _scenes('cornell_highpoly_48x24_blocked')[1], 7),
    'ragged_984': (_ragged_scene, 5),
}


@pytest.mark.parametrize('name', sorted(TREES))
def test_node_bounds_tree(name):
    '''node_bounds is the heap-layout tree over 32-face leaves: each leaf
    box is its live faces' box, each inner node the union of its
    children, pure-padding leaves inverted, and the 16 leaves of block b
    make up block_bounds[b].'''
    scene, depth = TREES[name][0](), TREES[name][1]
    nodes = scene.node_bounds.numpy()
    f, nf = scene.face_coef.shape[0], int(scene.nfaces)
    p = nodes.shape[0] // 2
    nleaves = -(-f // LEAF_FACES)
    assert nodes.shape == (2 * p, 8) and nodes.dtype == np.float32
    assert p == 1 << depth and p // 2 < nleaves <= p
    # the kernels' stack covers the deepest tree the route admits
    assert blocked.tree_leaves(blocked.MAX_BLOCKED_FACES) \
        == 1 << blocked.MAX_TREE_DEPTH
    if name == 'cornell_highpoly':
        assert nleaves == 3184
    lo, hi = nodes[:, 0:3], nodes[:, 3:6]
    # leaves: the exact box of their live faces' vertices
    verts = np.zeros((p * LEAF_FACES, 9), np.float32)
    verts[:nf] = scene.tri_pos.numpy()[:nf].reshape(nf, 9)
    live = (np.arange(p * LEAF_FACES) < nf).reshape(p, LEAF_FACES, 1, 1)
    v = verts.reshape(p, LEAF_FACES, 3, 3)
    vlo = np.where(live, v, np.inf).min(axis=(1, 2))
    vhi = np.where(live, v, -np.inf).max(axis=(1, 2))
    full = np.arange(p) * LEAF_FACES < nf
    np.testing.assert_array_equal(lo[p:][full], vlo[full])
    np.testing.assert_array_equal(hi[p:][full], vhi[full])
    assert (lo[p:][~full] > hi[p:][~full]).all()  # padding: inverted
    assert (~full).sum() == p - -(-nf // LEAF_FACES)
    # inner nodes: the union of their children
    k = np.arange(1, p)
    np.testing.assert_array_equal(lo[k], np.minimum(lo[2 * k], lo[2 * k + 1]))
    np.testing.assert_array_equal(hi[k], np.maximum(hi[2 * k], hi[2 * k + 1]))
    assert not nodes[:, 6:8].any()
    # leaf l lies in block l // 16
    per = BLOCK_FACES // LEAF_FACES
    bb = scene.block_bounds.numpy()
    for b in range(bb.shape[0]):
        leaves = nodes[p + per * b:p + per * (b + 1)]
        np.testing.assert_array_equal(leaves[:, 0:3].min(0), bb[b, 0:3])
        np.testing.assert_array_equal(leaves[:, 3:6].max(0), bb[b, 3:6])


def _bits(x):
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize('name', ['cornell_highpoly', 'ragged_984'])
def test_tree_gate_keeps_brute_winner(name):
    '''The kernels' culling, through its torch twin box_entries: for seeded
    random rays and 32 rays straight down onto the floor plane (a wall on
    its leaves' box planes), every node on the path from the root to the
    leaf of brute's winner is entered, at an entry that the floored gate
    lets through against the winner's key, so no visit order can prune
    it; leaf_pairs counts at least that leaf's faces.'''
    scene = TREES[name][0]()
    rng = np.random.RandomState(9)
    n = 256
    o = np.stack([rng.uniform(-1.9, 1.9, n), rng.uniform(0.1, 3.9, n),
                  rng.uniform(-1.9, 1.9, n)], 1)
    d = rng.randn(n, 3)
    d[:32] = [0.0, -1.0, 0.0]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    _, (ro, rd) = _rays(o, d)
    avoid = torch.full((n,), -1, dtype=torch.int32)
    ref = tbrute.cast_closest(ro, rd, scene.tri_w2b, avoid)
    got, _ = _shade(scene, ro, rd, avoid.numpy())
    assert torch.equal(got.index, ref.index)  # brute's winners
    hit = got.hit
    assert hit.float().mean() > 0.9
    nodes = scene.node_bounds
    p = nodes.shape[0] // 2
    entries = box_entries(ro, rd, nodes)  # [N, 2P]
    rows = torch.nonzero(hit)[:, 0]
    k = p + got.index[rows].long() // LEAF_FACES
    key_floor = _bits(got.t[rows])  # the decoded t: the key's floored bits
    while True:
        e = entries[rows, k]
        assert torch.isfinite(e).all()
        assert ((_bits(e) & ~2047) <= key_floor).all()
        if (k == 1).all():
            break
        k = k // 2
    # the floor rays hit the floor, which lies on their leaves' lower face
    pos_y = o[:32, 1] + d[:32, 1] * got.t.numpy()[:32]
    floor = hit.numpy()[:32] & (np.abs(pos_y) < 1e-4)
    assert floor.sum() >= 8
    leaf_lo_y = nodes.numpy()[p + got.index.numpy()[:32][floor]
                              // LEAF_FACES, 1]
    assert (leaf_lo_y == 0.0).all()
    # the bound count: a hit needs at least its winner's leaf
    nf = int(scene.nfaces)
    t_stop = torch.where(hit, got.t, float('inf'))
    pairs = leaf_pairs(ro, rd, nodes, nf, t_stop, True)
    assert (pairs[hit] >= 1).all() and (pairs <= nf).all()
    assert not leaf_pairs(ro, rd, nodes, nf, torch.zeros(n), False).any()


def test_cross_block_tie_goes_to_lower_block():
    '''An exact key tie across blocks (one triangle in blocks 0 and 1, at
    the same block-local id) goes to the lower block, although the tree's
    nearest-first order enters block 1 first.'''
    coef, attr, bb, nodes, (ro, rd, avoid) = _tie_table('cpu')
    entries = box_entries(ro, rd, nodes)
    assert (entries[:, 3] < entries[:, 2]).all()  # block 1's half first
    hit, _ = blocked.blocked_cast_shade(ro, rd, avoid, coef, attr, bb, nodes)
    assert hit.hit.all() and (hit.index == 3).all()
