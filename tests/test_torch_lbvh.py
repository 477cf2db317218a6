'''
The port's linear BVH (ptina_tpu_torch.intersect.lbvh) against the JAX
package's (ptina_tpu.intersect.lbvh), on the CPU:

  * morton3d and every array of lbvh_build equal to JAX's exactly, on
    random soups, on a soup with many equal Morton codes (duplicated
    faces: the index-augmented split) and on two faces; the build
    invariants of tests/test_lbvh.py:22-44;
  * lbvh_traverse on JAX's own tree (carried with lbvh_from_numpy)
    against JAX's traversal: the same face on >= 99% of rays and t within
    1e-4 relative where they agree, the reference's tolerance for a t
    computed in another order (the two sum the face functionals in their
    own order, and t = -a0 / b0 magnifies a rounding on grazing rays);
    and on the port's tree against brute as tests/test_lbvh.py:46-76
    holds it (the same index on > 97% of rays, t
    within 1e-4), `avoid` included;
  * ray_aabb equal to JAX's.
'''

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ptina_tpu.intersect import lbvh as jlbvh
from ptina_tpu.scene import precompute_tri_functionals as jfunctionals
from ptina_tpu_torch.intersect.brute import cast_closest
from ptina_tpu_torch.intersect.lbvh import (LBVH, STACK_DEPTH, lbvh_build,
                                            lbvh_from_numpy, lbvh_traverse,
                                            morton3d, ray_aabb)
from ptina_tpu_torch.scene import precompute_tri_functionals
from ptina_tpu_torch.utils.vec import V3

torch.set_num_threads(2)

FIELDS = ('leaf', 'child', 'bmin', 'bmax', 'leaf_bmin', 'leaf_bmax')


def _random_tris(rng, nf):
    base = rng.rand(nf, 1, 3).astype(np.float32) * 8 - 4
    return base + rng.rand(nf, 3, 3).astype(np.float32) * 0.7


def _soups():
    rng = np.random.RandomState(0)
    dup = _random_tris(rng, 300)
    dup[40:140] = dup[40]  # 100 equal Morton codes
    return {'random_37': _random_tris(rng, 37),
            'random_1000': _random_tris(rng, 1000),
            'equal_codes': dup, 'two_faces': _random_tris(rng, 2)}


def _rays(rng, tris, nr):
    '''Rays from random origins toward random faces' centroids (most hit),
    and a quarter in random directions.'''
    ro = (rng.randn(nr, 3) * 6).astype(np.float32)
    aim = tris[rng.randint(0, len(tris), nr)].mean(1) - ro
    rnd = rng.randn(nr, 3).astype(np.float32)
    rd = np.where(np.arange(nr)[:, None] % 4 == 0, rnd, aim)
    rd = (rd / np.linalg.norm(rd, axis=1, keepdims=True)).astype(np.float32)
    return torch.from_numpy(ro), torch.from_numpy(rd)


def test_morton_matches_jax():
    rng = np.random.RandomState(1)
    p = np.concatenate([rng.rand(500, 3), [[0, 0, 0], [1, 1, 1],
                                           [0.5, 0.5, 0.5], [-1, 2, 0.999]]])
    p = p.astype(np.float32)
    got = morton3d(torch.from_numpy(p))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jlbvh.morton3d(jnp.asarray(p))))
    m = got[-4:-1].tolist()
    assert m[0] == 0 and m[1] > m[2] > m[0]


@pytest.mark.parametrize('name', ['random_37', 'random_1000', 'equal_codes',
                                  'two_faces'])
def test_build_matches_jax(name):
    tris = _soups()[name]
    ref = jlbvh.lbvh_build(jnp.asarray(tris))
    got = lbvh_build(torch.from_numpy(tris))
    assert isinstance(got, LBVH)
    for f in FIELDS:
        a, b = np.asarray(getattr(ref, f)), getattr(got, f).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), f


def test_build_invariants():
    n = 37
    bvh = lbvh_build(torch.from_numpy(_soups()['random_37']))
    assert sorted(bvh.leaf.tolist()) == list(range(n))
    refs = bvh.child.numpy().ravel()
    assert sorted(refs.tolist()) == sorted(
        list(range(n)) + [n + k for k in range(1, n - 1)])
    child = bvh.child.numpy()
    bmin, bmax = bvh.bmin.numpy(), bvh.bmax.numpy()
    lmin, lmax = bvh.leaf_bmin.numpy(), bvh.leaf_bmax.numpy()
    for i in range(n - 1):
        for c in child[i]:
            cmin = lmin[c] if c < n else bmin[c - n]
            cmax = lmax[c] if c < n else bmax[c - n]
            assert (bmin[i] <= cmin).all() and (bmax[i] >= cmax).all()
    with pytest.raises(ValueError):
        lbvh_build(torch.zeros(1, 3, 3))


@pytest.mark.parametrize('name', ['random_1000', 'equal_codes'])
def test_traverse_matches_jax_on_its_tree(name):
    tris = _soups()[name]
    rng = np.random.RandomState(3)
    jtree = jlbvh.lbvh_build(jnp.asarray(tris))
    tree = lbvh_from_numpy({f: np.asarray(getattr(jtree, f))
                            for f in FIELDS}, device='cpu')
    ro, rd = _rays(rng, tris, 512)
    avoid = torch.full((512,), -1, dtype=torch.int32)
    m = precompute_tri_functionals(torch.from_numpy(tris))
    ref = jlbvh.lbvh_traverse(jtree, jfunctionals(jnp.asarray(tris)),
                              jnp.asarray(ro.numpy()),
                              jnp.asarray(rd.numpy()),
                              jnp.asarray(avoid.numpy()))
    got = lbvh_traverse(tree, m, ro, rd, avoid)
    same = got.index.numpy() == np.asarray(ref.index)
    assert same.mean() >= 0.99, same.mean()
    hits = same & np.asarray(ref.hit)
    assert hits.mean() > 0.5
    np.testing.assert_allclose(got.t.numpy()[hits], np.asarray(ref.t)[hits],
                               rtol=1e-4)


def test_traverse_matches_brute_with_avoid():
    rng = np.random.RandomState(1)
    tris = _random_tris(rng, 64)
    t = torch.from_numpy(tris)
    m = precompute_tri_functionals(t)
    bvh = lbvh_build(t)
    nr = 256
    ro, rd = _rays(rng, tris, nr)
    none = torch.full((nr,), -1, dtype=torch.int32)
    for avoid in (none, None):
        if avoid is None:  # avoid each ray's first hit
            avoid = hb.index
        hb = cast_closest(V3(*ro.T), V3(*rd.T), m, avoid)
        ht = lbvh_traverse(bvh, m, ro, rd, avoid)
        same = hb.index == ht.index
        assert same.float().mean().item() > 0.97
        hits = hb.hit & same
        assert hits.float().mean().item() > (0.3 if avoid is none else 0)
        assert torch.allclose(hb.t[hits], ht.t[hits], rtol=1e-4, atol=1e-4)
        assert not ((ht.index == avoid) & ht.hit).any()


def test_stack_depth_and_ray_aabb_match_jax():
    assert STACK_DEPTH == jlbvh.STACK_DEPTH == 32
    rng = np.random.RandomState(4)
    ro = rng.randn(64, 3).astype(np.float32) * 3
    lo = rng.randn(64, 3).astype(np.float32)
    hi = lo + rng.rand(64, 3).astype(np.float32) * 2
    # rays toward a point of their box or near it; the first eight with
    # a zero x direction
    rd = lo + rng.rand(64, 3).astype(np.float32) * 3 - ro
    rd[:8, 0] = 0.0
    tmax = rng.rand(64).astype(np.float32) * 10
    ref = jlbvh.ray_aabb(*(jnp.asarray(a) for a in (ro, rd, lo, hi, tmax)))
    got = ray_aabb(*(torch.from_numpy(a) for a in (ro, rd, lo, hi, tmax)))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got[0].any() and not got[0].all()
