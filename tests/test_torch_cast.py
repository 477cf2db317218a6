'''
Parity of the PyTorch port's dense casts (ptina_tpu_torch.intersect:
dense_cast's plain versions, the twins of its CUDA kernels, and dispatch)
with the JAX reference's Pallas kernels run in interpret mode
(pallas_cast_shade / pallas_cast_any, as tests/test_intersect.py runs
them), and of the port's brute oracle with the JAX brute oracle.  The
scene-level casts take the table's box tree (scene.dense_tree), which
their plain versions do not read.

Tolerances (the reference's own, test_intersect.py:127-170):
  * hit flag, winner index and occlusion bit: exact;
  * t: rtol 5e-4 (the packed-key t grid is 2^-12 relative, 2^-10 above
    2048 faces; a one-ulp difference in a coefficient dot product can move
    the decoded t by one grid step);
  * u, v: rtol 1e-3, atol 1e-4; interpolated attributes: atol 1e-4.
'''

from types import SimpleNamespace

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ptina_tpu.scene import precompute_tri_functionals as jfunctionals
from ptina_tpu.scenes import cornell_box as jcornell_box
from ptina_tpu.intersect import brute as jbrute
from ptina_tpu.intersect.pallas_cast import pallas_cast_shade, pallas_cast_any
from ptina_tpu.utils.vec import V3 as JV3
from ptina_tpu_torch.utils.vec import V3
from ptina_tpu_torch.intersect import brute as tbrute
from ptina_tpu_torch.intersect import blocked, dense_cast, dispatch
from ptina_tpu_torch.intersect.dense_cast import MAX_DENSE_FACES
from ptina_tpu_torch.intersect.plucker import pack_faces, key_mask_for
from ptina_tpu_torch.scene import dense_tree, scene_from_numpy

from test_torch_scene import jax_scene_arrays

torch.set_num_threads(2)


def _rays(o, d):
    o = np.asarray(o, np.float32)
    d = np.asarray(d, np.float32)
    j = (JV3(*(jnp.asarray(o[:, k]) for k in range(3))),
         JV3(*(jnp.asarray(d[:, k]) for k in range(3))))
    t = (V3(*(torch.from_numpy(o[:, k].copy()) for k in range(3))),
         V3(*(torch.from_numpy(d[:, k].copy()) for k in range(3))))
    return j, t


class Table:
    '''One face table in both packages: JAX tri_w2b / corner attrs and
    the port's per-face kernel tables and box tree built from the same
    numbers (tris: the [F, 3, 3] positions).'''

    def __init__(self, tri_w2b, attrs, tris):
        self.jw2b = jnp.asarray(tri_w2b)
        self.jattrs = jnp.asarray(attrs)
        self.tw2b = torch.from_numpy(np.array(tri_w2b))
        self.coef, self.attr = pack_faces(self.tw2b,
                                          torch.from_numpy(np.array(attrs)))
        self.tree = dense_tree(np.asarray(tris, np.float32),
                               self.coef.shape[0], self.coef)


def _random_table(rng, nf, scale=2.0):
    tris = (rng.randn(nf, 3, 3) * scale).astype(np.float32)
    w2b = np.asarray(jfunctionals(jnp.asarray(tris)))
    attrs = rng.uniform(-1.0, 1.0, (18, nf)).astype(np.float32)
    return Table(w2b, attrs, tris)


def _cornell_table():
    s = jcornell_box()
    return Table(np.asarray(s.tri_w2b), np.asarray(s.tri_attrs),
                 np.asarray(s.tri_pos))


def _random_rays(rng, n, box=False):
    if box:  # inside the cornell box
        o = np.stack([rng.uniform(-1.9, 1.9, n), rng.uniform(0.1, 3.9, n),
                      rng.uniform(-1.9, 1.9, n)], 1)
    else:
        o = rng.randn(n, 3) * 3
    d = rng.randn(n, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _compare_shade(table, o, d, avoid):
    (jro, jrd), (tro, trd) = _rays(o, d)
    ref, ref_att = pallas_cast_shade(jro, jrd, table.jw2b,
                                     jnp.asarray(avoid), table.jattrs,
                                     interpret=True)
    got, got_att = dense_cast.cast_shade(
        tro, trd, torch.from_numpy(avoid), table.coef, table.attr,
        *table.tree)
    hit = np.asarray(ref.hit)
    np.testing.assert_array_equal(got.hit.numpy(), hit)
    np.testing.assert_array_equal(got.index.numpy(), np.asarray(ref.index))
    np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(ref.t)[hit],
                               rtol=5e-4)
    for a, b in ((got.u, ref.u), (got.v, ref.v)):
        np.testing.assert_allclose(a.numpy()[hit], np.asarray(b)[hit],
                                   rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(got_att.numpy(), np.asarray(ref_att),
                               rtol=0, atol=1e-4)
    # misses report the reference's sentinels
    assert (got.t.numpy()[~hit] == 1e6).all()
    assert (got.index.numpy()[~hit] == -1).all()
    assert not got_att.numpy()[:, ~hit].any()
    return hit


def _compare_any(table, o, d, avoid, tmax):
    (jro, jrd), (tro, trd) = _rays(o, d)
    ref = pallas_cast_any(jro, jrd, table.jw2b, jnp.asarray(avoid),
                          jnp.asarray(tmax), interpret=True)
    got = dense_cast.cast_any(tro, trd, torch.from_numpy(avoid),
                              torch.from_numpy(tmax), table.coef,
                              *table.tree)
    flat = dense_cast.cast_any_flat(tro, trd, torch.from_numpy(avoid),
                                    torch.from_numpy(tmax), table.coef)
    assert torch.equal(flat, got)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    return np.asarray(ref)


def _avoid(rng, n, nf):
    return np.where(rng.rand(n) < 0.25, rng.randint(0, nf, n),
                    -1).astype(np.int32)


CASES = {
    # name: (table builder, rays, box origins)
    'random_37': (lambda rng: _random_table(rng, 37), 160, False),
    'cornell': (lambda rng: _cornell_table(), 1024, True),
    'random_2100': (lambda rng: _random_table(rng, 2100), 256, False),
}


@pytest.mark.parametrize('case', sorted(CASES))
def test_shade_plain_matches_pallas_interpret(case):
    build, n, box = CASES[case]
    rng = np.random.RandomState(7)
    table = build(rng)
    nf = table.coef.shape[0]
    o, d = _random_rays(rng, n, box)
    hit = _compare_shade(table, o, d, _avoid(rng, n, nf))
    assert 0.2 < hit.mean()
    if case == 'random_2100':
        assert key_mask_for(nf) == 4095  # the widened key


@pytest.mark.parametrize('case', sorted(CASES))
def test_any_plain_matches_pallas_interpret(case):
    build, n, box = CASES[case]
    rng = np.random.RandomState(8)
    table = build(rng)
    o, d = _random_rays(rng, n, box)
    tmax = rng.uniform(0.0, 6.0, n).astype(np.float32)
    tmax[:8] = 0.0     # parked shadow rays
    tmax[8:16] = 3e6   # beyond the far clip
    occ = _compare_any(table, o, d, _avoid(rng, n, table.coef.shape[0]),
                       tmax)
    assert 0.05 < occ.mean() < 1.0
    assert not occ[:8].any()


def _one_triangle(z=0.0):
    tri = np.asarray([[[-1, -1, z], [1, -1, z], [0, 1, z]]], np.float32)
    return tri, np.asarray(jfunctionals(jnp.asarray(tri)))


def test_far_clip_hit_is_miss():
    '''A hit at t >= INF misses and never occludes, also for tmax > INF.'''
    tris = np.asarray([[[-4e6, -4e6, 2e6], [4e6, -4e6, 2e6],
                        [0.0, 4e6, 2e6]]], np.float32)
    table = Table(np.asarray(jfunctionals(jnp.asarray(tris))),
                  np.ones((18, 1), np.float32), tris)
    o = np.zeros((8, 3))
    d = np.tile([[0.0, 0.0, 1.0]], (8, 1))
    avoid = np.full(8, -1, np.int32)
    hit = _compare_shade(table, o, d, avoid)
    assert not hit.any()
    tmax = np.full(8, 3e6, np.float32)
    assert not _compare_any(table, o, d, avoid, tmax).any()


def test_avoid_excludes_face():
    table = Table(_one_triangle()[1], np.ones((18, 1), np.float32),
                  _one_triangle()[0])
    o = np.asarray([[0.0, 0.0, -2.0]] * 2)
    d = np.asarray([[0.0, 0.0, 1.0]] * 2)
    hit = _compare_shade(table, o, d, np.asarray([-1, 0], np.int32))
    assert hit.tolist() == [True, False]
    occ = _compare_any(table, o, d, np.asarray([-1, 0], np.int32),
                       np.full(2, 5.0, np.float32))
    assert occ.tolist() == [True, False]


def test_zero_padding_faces_never_hit():
    w2b = np.zeros((4, 3, 4), np.float32)
    tris = np.zeros((4, 3, 3), np.float32)
    tris[:1], w2b[:1] = _one_triangle()
    table = Table(w2b, np.arange(72, dtype=np.float32).reshape(18, 4), tris)
    o = np.asarray([[0.0, 0.0, -2.0], [0.0, 0.0, 2.0], [5.0, 5.0, -2.0]])
    d = np.asarray([[0.0, 0.0, 1.0], [0.0, 0.0, -1.0], [0.0, 0.0, 1.0]])
    hit = _compare_shade(table, o, d, np.full(3, -1, np.int32))
    assert hit.tolist() == [True, True, False]
    occ = _compare_any(table, o, d, np.full(3, -1, np.int32),
                       np.full(3, 5.0, np.float32))
    assert occ.tolist() == [True, True, False]


def test_parked_shadow_ray_never_occludes():
    '''The integrator parks dead lanes at origin 0, +z, tmax 0: even with
    a face straight ahead they must not occlude.'''
    tri, w2b = _one_triangle(z=1.0)
    table = Table(w2b, np.ones((18, 1), np.float32), tri)
    o = np.zeros((2, 3))
    d = np.tile([[0.0, 0.0, 1.0]], (2, 1))
    occ = _compare_any(table, o, d, np.full(2, -1, np.int32),
                       np.asarray([0.0, 2.0], np.float32))
    assert occ.tolist() == [False, True]


def test_brute_oracle_matches_reference():
    rng = np.random.RandomState(11)
    table = _random_table(rng, 37)
    n = 256
    o, d = _random_rays(rng, n)
    avoid = _avoid(rng, n, 37)
    tmax = rng.uniform(0.0, 6.0, n).astype(np.float32)
    (jro, jrd), (tro, trd) = _rays(o, d)
    ref = jbrute.cast_closest(jro, jrd, table.jw2b, jnp.asarray(avoid))
    got = tbrute.cast_closest(tro, trd, table.tw2b, torch.from_numpy(avoid))
    np.testing.assert_array_equal(got.index.numpy(), np.asarray(ref.index))
    # both oracles are [N, 4] @ [4, 3F] matmuls: rounding-level agreement
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), rtol=1e-5)
    hit = np.asarray(ref.hit)
    for a, b in ((got.u, ref.u), (got.v, ref.v)):
        np.testing.assert_allclose(a.numpy()[hit], np.asarray(b)[hit],
                                   rtol=1e-5, atol=1e-6)
    occ_ref = jbrute.cast_any(jro, jrd, table.jw2b, jnp.asarray(avoid),
                              jnp.asarray(tmax))
    occ = tbrute.cast_any(tro, trd, table.tw2b, torch.from_numpy(avoid),
                          torch.from_numpy(tmax))
    np.testing.assert_array_equal(occ.numpy(), np.asarray(occ_ref))


def test_dispatch_shading_attributes():
    '''cast_shaded post-processes the shade cast exactly as the
    reference's dense route (dispatch.py:119-126): unit normal, uv, and
    mtlid = round(attr 5), -1 on a miss.'''
    js = jcornell_box()
    scene = scene_from_numpy(jax_scene_arrays(js), device='cpu')
    rng = np.random.RandomState(12)
    o, d = _random_rays(rng, 512, box=True)
    avoid = np.full(512, -1, np.int32)
    (jro, jrd), (tro, trd) = _rays(o, d)
    ref, att = pallas_cast_shade(jro, jrd, js.tri_w2b, jnp.asarray(avoid),
                                 js.tri_attrs, interpret=True)
    att = np.asarray(att)
    hit = np.asarray(ref.hit)
    got, normal, s, t, mtl = dispatch.cast_shaded(scene, tro, trd,
                                                  torch.from_numpy(avoid))
    np.testing.assert_array_equal(got.index.numpy(), np.asarray(ref.index))
    nrm = att[:3] / np.maximum(np.linalg.norm(att[:3], axis=0), 1e-12)
    got_n = np.stack([normal.x.numpy(), normal.y.numpy(), normal.z.numpy()])
    np.testing.assert_allclose(got_n, nrm, rtol=0, atol=1e-5)
    np.testing.assert_allclose(s.numpy(), att[3], atol=1e-4)
    np.testing.assert_allclose(t.numpy(), att[4], atol=1e-4)
    want = np.where(hit, np.round(att[5]).astype(np.int32), -1)
    np.testing.assert_array_equal(mtl.numpy(), want)
    assert mtl.dtype == torch.int32 and (want[~hit] == -1).all()
    tmax = torch.full((512,), 3.0)
    occ = dispatch.cast_shadow(scene, tro, trd, torch.from_numpy(avoid),
                               tmax)
    occ_ref = pallas_cast_any(jro, jrd, js.tri_w2b, jnp.asarray(avoid),
                              jnp.full(512, 3.0), interpret=True)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(occ_ref))


def test_cpu_casts_launch_no_kernel():
    before = dict(dense_cast.LAUNCHES)
    table = _cornell_table()
    _, (tro, trd) = _rays(*_random_rays(np.random.RandomState(1), 64, True))
    avoid = torch.full((64,), -1, dtype=torch.int32)
    dense_cast.cast_shade(tro, trd, avoid, table.coef, table.attr,
                          *table.tree)
    dense_cast.cast_any(tro, trd, avoid, torch.ones(64), table.coef,
                        *table.tree)
    dense_cast.cast_any_flat(tro, trd, avoid, torch.ones(64), table.coef)
    dense_cast.cast_closest(tro, trd, avoid, table.coef)
    assert dense_cast.LAUNCHES == before


def test_wrappers_validate_operands():
    table = _cornell_table()
    _, (tro, trd) = _rays(*_random_rays(np.random.RandomState(1), 16, True))
    avoid = torch.full((16,), -1, dtype=torch.int32)
    with pytest.raises(ValueError, match='avoid'):
        dense_cast.cast_shade(tro, trd, avoid.long(), table.coef, table.attr,
                              *table.tree)
    with pytest.raises(ValueError, match='coef'):
        dense_cast.cast_shade(tro, trd, avoid, table.coef.double(),
                              table.attr, *table.tree)
    with pytest.raises(ValueError, match='attr'):
        dense_cast.cast_shade(tro, trd, avoid, table.coef, table.attr[:, :6],
                              *table.tree)
    with pytest.raises(ValueError, match='ray rows'):
        dense_cast.cast_any(tro, trd, avoid, torch.ones(15), table.coef,
                            *table.tree)
    with pytest.raises(ValueError, match='ray rows'):
        dense_cast.cast_any_flat(tro, trd, avoid, torch.ones(15), table.coef)


def test_dispatch_refuses_blocked_route():
    '''Scenes route by the reference's rule: accel='blocked' and big
    'auto' scenes to the blocked casts, small 'auto' and 'dense' scenes
    to the dense ones; 'dense' above MAX_DENSE_FACES to brute, as the
    reference's XLA route.'''
    scene = scene_from_numpy(jax_scene_arrays(jcornell_box()), device='cpu')
    assert dispatch._route(scene) == 'dense'
    scene.accel = 'dense'
    assert dispatch._route(scene) == 'dense'
    _, (tro, trd) = _rays(*_random_rays(np.random.RandomState(1), 64, True))
    avoid = torch.full((64,), -1, dtype=torch.int32)
    dense_hit, *dense_rest = dispatch.cast_shaded(scene, tro, trd, avoid)
    scene.accel = 'blocked'
    assert dispatch._route(scene) == 'blocked'
    before = dict(blocked.LAUNCHES)
    hit, *rest = dispatch.cast_shaded(scene, tro, trd, avoid)
    # one block of 40 faces: the block-local key grid is the dense one
    assert torch.equal(hit.index, dense_hit.index)
    assert torch.equal(hit.t, dense_hit.t)
    assert torch.equal(rest[-1], dense_rest[-1])
    occ = dispatch.cast_shadow(scene, tro, trd, avoid, torch.full((64,), 2.0))
    scene.accel = 'auto'
    assert torch.equal(occ, dispatch.cast_shadow(scene, tro, trd, avoid,
                                                 torch.full((64,), 2.0)))
    assert blocked.LAUNCHES == before  # CPU: plain versions only
    big = SimpleNamespace(accel='auto',
                          face_coef=torch.zeros(MAX_DENSE_FACES + 1, 16))
    assert dispatch._route(big) == 'blocked'
    big.accel = 'dense'
    assert dispatch._route(big) == 'brute'
