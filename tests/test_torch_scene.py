'''
Parity of the PyTorch port's scene build (ptina_tpu_torch.scene /
scenes) with the JAX reference, field by field.

`jax_scene_arrays` is the shared bridge of the port's tests: it flattens
a JAX Scene into the numpy dict that ptina_tpu_torch.scene.scene_from_numpy
takes, so both packages render one scene from the same numbers.
`scene_to_numpy` flattens the port's Scene into the same dict.
'''

import numpy as np
import pytest
import torch

from ptina_tpu import scenes as jscenes
from ptina_tpu.intersect.plucker import pack_extract
from ptina_tpu_torch import scenes as tscenes
from ptina_tpu_torch.scene import (scene_from_numpy, make_scene,
                                   morton_face_order, compute_block_bounds,
                                   MAX_DENSE_FACES, BLOCK_FACES, MAX_BLOCKS)
from ptina_tpu_torch.intersect.dispatch import route

torch.set_num_threads(2)

ATOL = 1e-6


def jax_scene_arrays(s):
    '''JAX Scene -> the numpy dict of scene_from_numpy.'''
    h = np.asarray
    return dict(
        tri_pos=h(s.tri_pos), tri_nrm=h(s.tri_nrm), tri_uv=h(s.tri_uv),
        tri_mtl=h(s.tri_mtl), tri_w2b=h(s.tri_w2b), tri_attrs=h(s.tri_attrs),
        nfaces=h(s.nfaces),
        mat_fac=h(s.materials.fac), mat_tex=h(s.materials.tex),
        mat_zero=s.materials.zero, mat_textured=s.materials.textured,
        light_color=h(s.lights.color), light_pos=h(s.lights.pos),
        light_axes=h(s.lights.axes), light_size=h(s.lights.size),
        light_type=h(s.lights.type), light_count=h(s.lights.count),
        light_kinds=s.lights.kinds,
        tex_data=h(s.textures.data), tex_nx=h(s.textures.nx),
        tex_ny=h(s.textures.ny),
        world_fac=h(s.world_fac), world_tex=h(s.world_tex),
        cam_v2w=h(s.cam_v2w), cam_w2v=h(s.cam_w2v), accel=s.accel)


def scene_to_numpy(s):
    '''The port's Scene -> the numpy dict of scene_from_numpy.'''
    def h(x):
        return x.detach().cpu().numpy()
    return dict(
        tri_pos=h(s.tri_pos), tri_nrm=h(s.tri_nrm), tri_uv=h(s.tri_uv),
        tri_mtl=h(s.tri_mtl), tri_w2b=h(s.tri_w2b), tri_attrs=h(s.tri_attrs),
        nfaces=h(s.nfaces),
        mat_fac=h(s.materials.fac), mat_tex=h(s.materials.tex),
        mat_zero=s.materials.zero, mat_textured=s.materials.textured,
        light_color=h(s.lights.color), light_pos=h(s.lights.pos),
        light_axes=h(s.lights.axes), light_size=h(s.lights.size),
        light_type=h(s.lights.type), light_count=h(s.lights.count),
        light_kinds=s.lights.kinds,
        tex_data=h(s.textures.data), tex_nx=h(s.textures.nx),
        tex_ny=h(s.textures.ny),
        world_fac=h(s.world_fac), world_tex=h(s.world_tex),
        cam_v2w=h(s.cam_v2w), cam_w2v=h(s.cam_w2v), accel=s.accel)


def assert_same_arrays(ref, got, atol=ATOL):
    assert set(ref) == set(got)
    for k, a in ref.items():
        b = got[k]
        if isinstance(a, np.ndarray):
            assert a.shape == np.shape(b), k
            assert a.dtype == np.asarray(b).dtype, k
            np.testing.assert_allclose(np.asarray(b, np.float64),
                                       a.astype(np.float64), rtol=0,
                                       atol=atol, err_msg=k)
        else:
            assert tuple(a) == tuple(b) if isinstance(a, tuple) else a == b, k


_TEX = (np.arange(4 * 6 * 3).reshape(4, 6, 3) % 7 / 7.0).astype(np.float32)

# name -> (scene function, keyword arguments)
SCENES = {
    'cornell_box': ('cornell_box', dict()),
    'cornell_monkey': ('cornell_monkey', dict()),
    'cornell_box_textured': ('cornell_box', dict(textured_image=_TEX)),
    'envlight_scene': ('envlight_scene', dict()),
    'matball': ('matball', dict()),
    'matball_textured': ('matball', dict(roughness_tex=_TEX)),
}


def _build(pkg, name):
    fn, kw = SCENES[name]
    if pkg is tscenes:
        kw = dict(kw, device='cpu')
    return getattr(pkg, fn)(**kw)


@pytest.mark.parametrize('name', sorted(SCENES))
def test_make_scene_matches_reference(name):
    '''Every tensor the port builds on its own equals the JAX Scene's.'''
    ref = jax_scene_arrays(_build(jscenes, name))
    assert_same_arrays(ref, scene_to_numpy(_build(tscenes, name)))


@pytest.mark.parametrize('name', sorted(SCENES))
def test_scene_from_numpy_round_trips(name):
    ref = jax_scene_arrays(_build(jscenes, name))
    scene = scene_from_numpy(ref, device='cpu')
    assert_same_arrays(ref, scene_to_numpy(scene), atol=0.0)
    # static structure survives as plain Python attributes
    assert scene.materials.zero == tuple(ref['mat_zero'])
    assert scene.lights.kinds == tuple(ref['light_kinds'])
    assert scene.world_tex_id == int(ref['world_tex'])


@pytest.mark.parametrize('name', ['cornell_box', 'cornell_monkey'])
def test_face_tables_match_reference_coefficients(name):
    '''The per-face kernel table carries the reference's extraction
    coefficients (pack_extract: cu, cv, m0.xyz) plus m0.w, and the
    attribute table is tri_attrs transposed.'''
    js = _build(jscenes, name)
    ts = _build(tscenes, name)
    coef = np.asarray(pack_extract(js.tri_w2b)).T  # [F, 15]
    got = ts.face_coef.numpy()
    np.testing.assert_allclose(got[:, :15], coef, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(got[:, 15], np.asarray(js.tri_w2b)[:, 0, 3])
    np.testing.assert_array_equal(ts.face_attr.numpy(),
                                  np.asarray(js.tri_attrs).T)


def test_padding_faces_are_zero():
    s = tscenes.cornell_box(device='cpu')
    assert s.tri_w2b.shape[0] == 40 and int(s.nfaces) == 34
    assert not s.face_coef[34:].any()
    assert (s.tri_mtl[34:] == -1).all()


def test_dense_limit_and_blocked_raise():
    '''Above MAX_DENSE_FACES, and under accel='blocked', scenes build for
    the blocked route: Morton-ordered, padded to whole BLOCK_FACES blocks,
    with block_bounds.  accel='dense' above MAX_DENSE_FACES takes the
    reference's brute route: build order, padded to pad_faces_to only, no
    dense tree.  Scenes beyond the blocked cast's MAX_BLOCKS raise.'''
    rng = np.random.RandomState(2)
    nf = MAX_DENSE_FACES + 1
    verts = np.zeros((3 * nf, 8), np.float32)
    verts[:, :3] = rng.randn(3 * nf, 3)
    scene = make_scene(verts, device='cpu')
    assert scene.tri_w2b.shape[0] == 17 * BLOCK_FACES
    assert scene.block_bounds.shape == (17, 8)
    tri = verts[:, :3].reshape(nf, 3, 3)
    order = morton_face_order(tri)
    np.testing.assert_array_equal(scene.tri_pos[:nf].numpy(), tri[order])
    np.testing.assert_array_equal(scene.block_bounds.numpy(),
                                  compute_block_bounds(tri[order], nf))
    small = make_scene(verts[:30], accel='blocked', device='cpu')
    assert small.tri_w2b.shape[0] == BLOCK_FACES and int(small.nfaces) == 10
    assert (small.block_bounds[0, :3] <= small.block_bounds[0, 3:6]).all()
    dense = make_scene(verts, accel='dense', device='cpu')
    assert dense.tri_w2b.shape[0] == nf + 7 and dense.fused_coef.shape[0] == 0
    np.testing.assert_array_equal(dense.tri_pos[:nf].numpy(), tri)
    assert route(dense.tri_w2b.shape[0], 'dense') == 'brute'
    huge = np.broadcast_to(np.zeros(8, np.float32),
                           (3 * (BLOCK_FACES * MAX_BLOCKS + 1), 8))
    with pytest.raises(ValueError, match='blocks'):
        make_scene(huge, device='cpu')


def test_scene_tensors_stay_on_requested_device():
    s = tscenes.cornell_box(device='cpu')
    assert s.device.type == 'cpu'
    assert s.materials.fac.device.type == 'cpu'
    assert s.lights.count.dtype == torch.int32
