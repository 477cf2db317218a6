'''
The module leftovers of the PyTorch port against the JAX reference, on
the CPU:

  * utils.mathutils' sixteen [..., 3] helpers (unlerp, smoothstep, dot,
    dot_or_zero, norm, normalize, cross, vavg, safe_div, tanframe,
    tanspace, spherical, unspherical, dir2tex, reflect, refract) on the
    same numpy inputs, at tests/test_torch_shading.py's tolerance (rtol
    1e-5, atol 1e-6);
  * utils.vec.v3 and materials.microfacet.sample_gtr2_vnor, the same;
  * sampling.uniform_grid: float32 uniforms in [0, 1) of the asked shape
    from an explicit torch.Generator, the same for the same seed (the
    reference draws from a JAX key: the values differ by design).
'''

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptina_tpu.materials import microfacet as jmicrofacet
from ptina_tpu.utils import mathutils as jm
from ptina_tpu.utils import vec as jvec
from ptina_tpu_torch.materials import microfacet
from ptina_tpu_torch.sampling import uniform_grid
from ptina_tpu_torch.utils import mathutils as tm
from ptina_tpu_torch.utils import vec

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6
N = 257


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    a = rng.randn(N, 3).astype(np.float32)
    b = rng.randn(N, 3).astype(np.float32)
    b[:3] = 0.0  # zero vectors: the guarded paths
    a[3] = [0.0, 0.0, 1.0]  # the normal along the frame's axis
    s = rng.rand(N).astype(np.float32)
    t = (rng.rand(N) * 2 - 0.5).astype(np.float32)
    return a, b, s, t


def _unit(x):
    return (x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True),
                           1e-12)).astype(np.float32)


def _cases():
    '''name -> a call of a mathutils module (the port's or the
    reference's) on (a, b, s, t).'''
    return {
        'unlerp': lambda f, a, b, s, t: f.unlerp(t, s, s + 1.0 + t * t),
        'smoothstep': lambda f, a, b, s, t: f.smoothstep(t, 0.1, 0.9),
        'dot': lambda f, a, b, s, t: f.dot(a, b),
        'dot_or_zero': lambda f, a, b, s, t: f.dot_or_zero(a, b),
        'norm': lambda f, a, b, s, t: f.norm(b),
        'normalize': lambda f, a, b, s, t: f.normalize(b),
        'cross': lambda f, a, b, s, t: f.cross(a, b),
        'vavg': lambda f, a, b, s, t: f.vavg(a),
        'safe_div': lambda f, a, b, s, t: f.safe_div(t, b[..., 0]),
        'tanframe': lambda f, a, b, s, t: f.tanframe(f.normalize(a)),
        'tanspace': lambda f, a, b, s, t: f.tanspace(f.normalize(a)),
        'spherical': lambda f, a, b, s, t: f.spherical(s * 2 - 1, t),
        'unspherical': lambda f, a, b, s, t: f.unspherical(f.normalize(a)),
        'dir2tex': lambda f, a, b, s, t: f.dir2tex(a),
        'reflect': lambda f, a, b, s, t: f.reflect(a, f.normalize(b)),
        'refract': lambda f, a, b, s, t: f.refract(
            f.normalize(a), f.normalize(b), 1.0 / 1.45),
        'refract_per_lane': lambda f, a, b, s, t: f.refract(
            f.normalize(a), f.normalize(a + b), 0.5 + s),
    }


def _flat(x):
    if isinstance(x, (tuple, list)):
        return [np.asarray(y) for z in x for y in _flat(z)]
    return [np.asarray(x)]


@pytest.mark.parametrize('name', list(_cases()))
def test_mathutils_matches_reference(name):
    a, b, s, t = _inputs()
    call = _cases()[name]
    got = call(tm, *(torch.from_numpy(x) for x in (a, b, s, t)))
    ref = call(jm, *(jnp.asarray(x) for x in (a, b, s, t)))
    got, ref = _flat(got), _flat(ref)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == r.dtype
        np.testing.assert_allclose(g, r, rtol=RTOL, atol=ATOL)


def test_v3_matches_reference():
    a, _, s, _ = _inputs(1)
    got = vec.v3(torch.from_numpy(a[:, 0]), 0.5, s)
    ref = jvec.v3(a[:, 0], 0.5, s)
    for g, r in ((got.x, ref.x), (got.y, ref.y), (got.z, ref.z)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(r))
    assert got.y.ndim == 0 and got.z.shape == (N,)


def test_sample_gtr2_vnor_matches_reference():
    a, b, s, t = _inputs(2)
    ve = _unit(np.abs(a) + np.float32([0, 0, 0.1]))  # the upper hemisphere
    ve[:4] = [[0, 0, 1]] * 4  # straight up: the degenerate tangent
    u, v = s, np.abs(t) % 1.0
    alpha = (0.05 + 0.9 * np.abs(_unit(b)[:, 0])).astype(np.float32)
    got = microfacet.sample_gtr2_vnor(*(torch.from_numpy(x)
                                        for x in (ve, u, v, alpha)))
    ref = jmicrofacet.sample_gtr2_vnor(*(jnp.asarray(x)
                                         for x in (ve, u, v, alpha)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)
    assert np.isfinite(got.numpy()).all()


def test_uniform_grid_from_a_generator():
    draw = [uniform_grid(torch.Generator().manual_seed(3), (4, 1000),
                         device='cpu') for _ in range(2)]
    assert draw[0].dtype == torch.float32 and draw[0].shape == (4, 1000)
    assert torch.equal(draw[0], draw[1])
    assert float(draw[0].min()) >= 0.0 and float(draw[0].max()) < 1.0
    other = uniform_grid(torch.Generator().manual_seed(4), (4, 1000),
                         device='cpu')
    assert not torch.equal(draw[0], other)
