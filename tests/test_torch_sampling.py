'''
Bit-exact parity of the PyTorch port's sampling (ptina_tpu_torch.sampling)
with the JAX reference: wang hashes, the embedded Sobol direction grid,
Sobol points, the per-pixel Cranley-Patterson rotation and the rotated
per-pixel uniforms of one sample.
'''

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ptina_tpu import sampling as jsampling
from ptina_tpu.sampling import sobol as jsobol
from ptina_tpu.engine.path import pixel_grid as jpixel_grid
from ptina_tpu_torch import sampling as tsampling
from ptina_tpu_torch.sampling import sobol as tsobol
from ptina_tpu_torch.engine.path import pixel_grid, PATH_DIMS

torch.set_num_threads(2)


def _u32(rng, n):
    return rng.randint(0, 2 ** 32, size=n, dtype=np.uint64).astype(np.uint32)


def test_embedded_grid_equals_reference_table():
    '''The port's constant [98, 31] grid is the reference's Joe-Kuo grid
    (2 + 6 max_depth dimensions up to max_depth 16).'''
    assert tsobol.MAX_DIMS == 98
    ref = jsobol._vgrid_np(tsobol.MAX_DIMS)
    got = tsobol.sobol_vgrid(tsobol.MAX_DIMS).numpy()
    assert got.dtype == np.int32 and got.shape == (98, 31)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(tsobol.sobol_vgrid(8).numpy(),
                                  jsobol._vgrid_np(8))


def test_grid_rejects_more_dims_than_embedded():
    '''Above the embedded grid the port raises, naming its cap (the
    reference has none: ROADMAP queue 3).'''
    for fn in (tsobol.sobol_vgrid, lambda d: tsobol.sobol_point(0, d),
               lambda d: tsobol.sobol_block(0, d)):
        with pytest.raises(ValueError, match='MAX_DIMS = 98'):
            fn(tsobol.MAX_DIMS + 1)


@pytest.mark.parametrize('arity', [1, 2, 3])
def test_wanghash_bit_exact(arity):
    rng = np.random.RandomState(arity)
    args = [_u32(rng, 4096) for _ in range(arity)]
    args[0][:4] = [0, 1, 2 ** 32 - 1, 2 ** 31]
    jfn = {1: jsampling.wanghash, 2: jsampling.wanghash2,
           3: jsampling.wanghash3}[arity]
    tfn = {1: tsampling.wanghash, 2: tsampling.wanghash2,
           3: tsampling.wanghash3}[arity]
    ref = np.asarray(jfn(*[jnp.asarray(a) for a in args]))
    got = tfn(*[torch.from_numpy(a.astype(np.int64)) for a in args])
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))


def test_pixel_rotation_bit_exact():
    '''A 16x16 pixel block at an offset, all 32 path dimensions.'''
    ii, jj = pixel_grid(16, 16, 48, 16, device='cpu')
    jii, jjj = jpixel_grid(16, 16, 48, 16)
    np.testing.assert_array_equal(ii.numpy(), np.asarray(jii))
    np.testing.assert_array_equal(jj.numpy(), np.asarray(jjj))
    ref = np.asarray(jsobol.pixel_rotation(jii, jjj, PATH_DIMS))
    got = tsobol.pixel_rotation(ii, jj, PATH_DIMS)
    assert got.dtype == torch.float32 and got.shape == (PATH_DIMS, 256)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize('sample_index', [0, 1, 37])
def test_sobol_points_bit_exact(sample_index):
    vg = jsobol.sobol_vgrid(PATH_DIMS)
    idx = np.asarray([sample_index, sample_index + tsobol.SKIP, 1000003])
    ref = np.asarray(jsobol.sobol(jnp.asarray(idx), vg))
    got = tsobol.sobol(torch.from_numpy(idx), tsobol.sobol_vgrid(PATH_DIMS))
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(
        tsobol.sobol_block(sample_index, PATH_DIMS).numpy(),
        np.asarray(jsobol.sobol_block(sample_index, PATH_DIMS)))


@pytest.mark.parametrize('sample_index', [0, 1, 37])
def test_sample_dims_bit_exact(sample_index):
    '''The per-pixel uniforms of one sample over a 16x16 block, with the
    rotation computed inside and passed in.'''
    ii, jj = pixel_grid(16, 16, device='cpu')
    jii, jjj = jpixel_grid(16, 16)
    ref = np.asarray(jsobol.sample_dims(sample_index, jii, jjj, PATH_DIMS))
    got = tsobol.sample_dims(sample_index, ii, jj, PATH_DIMS)
    np.testing.assert_array_equal(got.numpy(), ref)
    rot = tsobol.pixel_rotation(ii, jj, PATH_DIMS)
    got2 = tsobol.sample_dims(sample_index, ii, jj, PATH_DIMS, rot=rot)
    np.testing.assert_array_equal(got2.numpy(), ref)
    assert (got >= 0).all() and (got < 1).all()


@pytest.mark.parametrize('ndims', [PATH_DIMS, 14])
def test_sobol_point_equals_sobol(ndims):
    '''The host numpy point (sobol_point, which sobol_block and the
    megakernel's launch parameters carry) equals the torch sobol() of the
    same index bit for bit, and the JAX point too.'''
    vg = tsobol.sobol_vgrid(ndims)
    for sample_index in (0, 1, 2, 63, 64, 1000, 2 ** 20 + 5, 2 ** 31 - 100):
        got = tsobol.sobol_point(sample_index, ndims)
        assert got.dtype == np.float32 and got.shape == (ndims,)
        ref = tsobol.sobol(sample_index + tsobol.SKIP, vg).numpy()
        np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        tsobol.sobol_point(37, ndims),
        np.asarray(jsobol.sobol_block(37, ndims)))
    with pytest.raises(ValueError):
        tsobol.sobol_point(0, tsobol.MAX_DIMS + 1)


@pytest.mark.parametrize('ndims', [38, 50, 98])
def test_deep_paths_bit_exact(ndims):
    '''Depths 6, 8 and 16: the direction grid, the host point and the
    per-pixel uniforms of a 16x16 block equal the JAX package's bit for
    bit.'''
    np.testing.assert_array_equal(tsobol.sobol_vgrid(ndims).numpy(),
                                  jsobol._vgrid_np(ndims))
    for sample_index in (0, 37):
        np.testing.assert_array_equal(
            tsobol.sobol_point(sample_index, ndims),
            np.asarray(jsobol.sobol_block(sample_index, ndims)))
    ii, jj = pixel_grid(16, 16, device='cpu')
    jii, jjj = jpixel_grid(16, 16)
    np.testing.assert_array_equal(
        tsobol.sample_dims(5, ii, jj, ndims).numpy(),
        np.asarray(jsobol.sample_dims(5, jii, jjj, ndims)))
