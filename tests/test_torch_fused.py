'''
The port's path megakernel entries (ptina_tpu_torch.engine.fused) against
the JAX package, on the CPU, where each entry runs its plain twin (the
CUDA kernel itself is held against the twin on the card:
tests/test_torch_cuda_kernels.py).

Port vs JAX, the same scene arrays and the same Sobol point:
  * fused_trace_primary on cornell_box and the textured cornell at 16x16
    against JAX fused_trace_primary(interpret=True) — the TPU kernel
    itself in interpret mode, as tests/test_fused.py runs it;
  * fused_trace_uniforms on cornell at 16x16 against JAX
    fused_trace_uniforms(interpret=True) on the same rays and uniforms;
  * fused_trace (the explicit-ray head: given rays, the Sobol point and
    a per-ray hash) on cornell and the textured cornell at 16x16 against
    JAX fused_trace(interpret=True) on the same rays, point and
    wanghash2(i, j); and, within the port, fused_trace fed
    fused_trace_primary's own camera rays and wanghash2(i, j) equal to
    fused_trace_primary bit for bit;
  * envlight_scene at 16x16 and matball(roughness_tex=...) at 12x12,
    depth 2, against JAX path_trace on identical uniforms: interpret mode
    costs ~24 s per call on their 35 face chunks, path_trace ~4 s (the
    way tests/test_fused.py:201-233 holds its > 2048-face case).
Tolerances are tests/test_fused.py's: cornell >= 95% of paths within 1e-3
absolute and image means within 2e-3 relative (:54-55); textured,
envlight and matball >= 95% of paths within 2e-2 relative to
max(|ref|, 0.05) and means within 1e-2 (:157-160).  The paths that differ
do so by design: the JAX kernel converts its hash with two roundings
(_u32f) where the port rounds once, and the JAX path_trace casts with
brute (exact t) where the port uses the packed-key contract.
'''

import types

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ptina_tpu import scenes as jscenes
from ptina_tpu.camera import camera_rays as jcamera_rays
from ptina_tpu.engine.fused import (
    fused_trace as jfused_trace,
    fused_trace_primary as jfused_primary,
    fused_trace_uniforms as jfused_uniforms)
from ptina_tpu.engine.path import path_trace as jpath_trace
from ptina_tpu.sampling import wanghash2 as jwanghash2
from ptina_tpu.sampling.sobol import sample_dims as jsample_dims
from ptina_tpu_torch import scenes as tscenes
from ptina_tpu_torch.engine import fused
from ptina_tpu_torch.camera import camera_rays
from ptina_tpu_torch.engine.path import render, render_sample, pixel_grid
from ptina_tpu_torch.film import new_film
from ptina_tpu_torch.intersect import dense_cast
from ptina_tpu_torch.sampling import wanghash2
from ptina_tpu_torch.sampling.sobol import sobol_block, pixel_rotation
from ptina_tpu_torch.scene import scene_from_numpy
from ptina_tpu_torch.utils.vec import V3

from test_torch_scene import jax_scene_arrays

torch.set_num_threads(2)

PATH_DIMS = 32


def _bench_texture():
    return (np.linspace(0, 1, 64 * 64, dtype=np.float32)
            .reshape(64, 64, 1) * np.ones((1, 1, 3), np.float32))


JSCENES = {
    'cornell': lambda: jscenes.cornell_box(),
    'cornell_textured': lambda: jscenes.cornell_box(
        textured_image=_bench_texture()),
    'envlight': lambda: jscenes.envlight_scene(),
    'matball': lambda: jscenes.matball(roughness_tex=_bench_texture()),
}


def _pair(name):
    js = JSCENES[name]()
    return js, scene_from_numpy(jax_scene_arrays(js), device='cpu')


def _np3(v):
    return np.stack([np.asarray(v.x), np.asarray(v.y), np.asarray(v.z)])


def _assert_close(got, ref, textured):
    assert got.shape == ref.shape and np.isfinite(got).all()
    if textured:
        d = np.abs(got - ref) / np.maximum(np.abs(ref), 0.05)
        assert (d.max(axis=0) < 2e-2).mean() > 0.95, \
            f'{(d.max(axis=0) >= 2e-2).mean():.3f} paths differ'
        assert abs(got.mean() - ref.mean()) < 1e-2 * max(ref.mean(), 1e-6)
    else:
        d = np.abs(got - ref).max(axis=0)
        assert (d < 1e-3).mean() > 0.95, f'{(d >= 1e-3).mean():.3f} differ'
        assert abs(got.mean() - ref.mean()) < 2e-3 * max(ref.mean(), 1e-6)


def _jax_primary_inputs(js, res, dims):
    '''The JAX side's camera rays and uniforms of sample 0.'''
    ii, jj = jnp.meshgrid(jnp.arange(res), jnp.arange(res), indexing='ij')
    ii, jj = ii.reshape(-1), jj.reshape(-1)
    u = jsample_dims(0, ii, jj, dims)
    x = (ii.astype(jnp.float32) + u[0]) / res * 2.0 - 1.0
    y = (jj.astype(jnp.float32) + u[1]) / res * 2.0 - 1.0
    ro, rd = jcamera_rays(js.cam_v2w, x, y)
    return ro, rd, u


def _to_port(ro, rd, u):
    def t(a):
        return torch.from_numpy(np.array(a))
    return (V3(t(ro.x), t(ro.y), t(ro.z)), V3(t(rd.x), t(rd.y), t(rd.z)),
            t(u))


@pytest.mark.parametrize('name', ['cornell', 'cornell_textured'])
def test_primary_matches_jax_kernel(name):
    js, ts = _pair(name)
    res = 16
    pt = sobol_block(0, PATH_DIMS)
    ref = _np3(jfused_primary(js, jnp.asarray(pt.numpy()), res, res,
                              interpret=True))
    before = dict(fused.LAUNCHES)
    got = _np3(fused.fused_trace_primary(ts, pt, res, res))
    assert fused.LAUNCHES == before  # CPU: the plain twin, no kernel
    _assert_close(got, ref, textured=name != 'cornell')


def test_uniforms_matches_jax_kernel():
    js, ts = _pair('cornell')
    ro, rd, u = _jax_primary_inputs(js, 16, PATH_DIMS)
    ref = _np3(jfused_uniforms(js, ro, rd, u, interpret=True))
    got = _np3(fused.fused_trace_uniforms(ts, *_to_port(ro, rd, u)))
    _assert_close(got, ref, textured=False)


@pytest.mark.parametrize('name', ['cornell', 'cornell_textured'])
def test_explicit_ray_head_matches_jax_kernel(name):
    '''fused_trace on the JAX side's camera rays of sample 0, with its
    Sobol point and the pixels' wanghash2 bit patterns as `base`.'''
    js, ts = _pair(name)
    res = 16
    pt = sobol_block(0, PATH_DIMS)
    ro, rd, _ = _jax_primary_inputs(js, res, PATH_DIMS)
    ii, jj = jnp.meshgrid(jnp.arange(res), jnp.arange(res), indexing='ij')
    jbase = jwanghash2(ii.reshape(-1), jj.reshape(-1))
    ref = _np3(jfused_trace(js, ro, rd, jnp.asarray(pt.numpy()), jbase,
                            interpret=True))
    base = torch.from_numpy(np.asarray(jbase).astype(np.uint32)
                            .view(np.int32))
    tro, trd, _ = _to_port(ro, rd, np.zeros(1, np.float32))
    before = dict(fused.LAUNCHES)
    got = _np3(fused.fused_trace(ts, tro, trd, pt, base))
    assert fused.LAUNCHES == before  # CPU: the plain twin, no kernel
    _assert_close(got, ref, textured=name != 'cornell')


@pytest.mark.parametrize('name', ['cornell', 'cornell_textured'])
def test_explicit_ray_head_equals_primary(name):
    '''fused_trace fed fused_trace_primary's own camera rays (lens
    jitter from rows 0-1) and wanghash2(i, j) makes the same uniforms and
    so the same radiance, bit for bit.'''
    _, ts = _pair(name)
    res = 16
    pt = sobol_block(6, PATH_DIMS)
    ii, jj = pixel_grid(res, res, device='cpu')
    u = torch.remainder(pt[:, None] + pixel_rotation(ii, jj, PATH_DIMS),
                        1.0)
    x = (ii.to(torch.float32) + u[0]) / res * 2.0 - 1.0
    y = (jj.to(torch.float32) + u[1]) / res * 2.0 - 1.0
    ro, rd = camera_rays(ts.cam_v2w, x, y)
    base = wanghash2(ii, jj).to(torch.int32)
    got = fused.fused_trace(ts, ro, rd, pt, base)
    ref = fused.fused_trace_primary(ts, pt, res, res)
    for k in 'xyz':
        assert torch.equal(getattr(got, k), getattr(ref, k))
    assert bool(torch.isfinite(got.x).all()) and got.x.any()


@pytest.mark.parametrize('name,res', [('envlight', 16), ('matball', 12)])
def test_above_2048_faces_matches_jax(name, res):
    '''2,216 faces: the widened face-id field of the packed key
    (key_mask_for) and 35 face chunks in the reference.'''
    js, ts = _pair(name)
    assert ts.face_coef.shape[0] > 2048
    dims = 2 + 6 * 2
    ro, rd, u = _jax_primary_inputs(js, res, dims)
    ref = _np3(jpath_trace(js, ro, rd, u))
    pt = sobol_block(0, dims)
    # the twin's uniforms are the JAX path_trace's, bit for bit
    ii, jj = pixel_grid(res, res, device='cpu')
    np.testing.assert_array_equal(
        torch.remainder(pt[:, None] + pixel_rotation(ii, jj, dims),
                        1.0).numpy(), np.asarray(u))
    got = _np3(fused.fused_trace_primary(ts, pt, res, res))
    _assert_close(got, ref, textured=True)


def test_half_frames_compose():
    '''Two half-frame tiles (x0 = 0 and x0 = res / 2 of a res x res film)
    equal the full frame exactly.'''
    ts = tscenes.cornell_box(device='cpu')
    res = 16
    pt = sobol_block(5, PATH_DIMS)
    full = _np3(fused.fused_trace_primary(ts, pt, res, res))
    top = _np3(fused.fused_trace_primary(ts, pt, res // 2, res, x0=0,
                                         fnx=res, fny=res))
    bot = _np3(fused.fused_trace_primary(ts, pt, res // 2, res, x0=res // 2,
                                         fnx=res, fny=res))
    np.testing.assert_array_equal(full, np.concatenate([top, bot], axis=1))


def _as_if_on_cuda(scene, **fields):
    '''A stand-in carrying exactly the fields fused_eligible reads, with
    the device set to CUDA, so its scene rules are testable here.'''
    stub = types.SimpleNamespace(
        device=torch.device('cuda'), accel=scene.accel,
        face_coef=scene.face_coef, textures=scene.textures,
        world_textured=scene.world_textured)
    stub.__dict__.update(fields)
    return stub


def test_fused_eligible_rules():
    cornell = tscenes.cornell_box(device='cpu')
    envlight = tscenes.envlight_scene(device='cpu')
    assert not fused.fused_eligible(cornell)  # on the CPU: never
    assert fused.fused_eligible(_as_if_on_cuda(cornell))
    assert fused.fused_eligible(_as_if_on_cuda(envlight))
    assert not fused.fused_eligible(_as_if_on_cuda(cornell, accel='blocked'))
    too_many = torch.empty((fused.MAX_FUSED_FACES + 8, 16), device='meta')
    assert not fused.fused_eligible(_as_if_on_cuda(cornell,
                                                   face_coef=too_many))
    # world_tex pointing at an atlas that is not loaded
    assert not fused.fused_eligible(_as_if_on_cuda(cornell,
                                                   world_textured=True))


@pytest.mark.parametrize('name', ['cornell', 'cornell_textured'])
def test_render_sample_fused_equals_wavefront_on_cpu(name):
    '''fused=True runs the plain twin on the CPU, which equals the
    wavefront bit for bit; the automatic route takes the wavefront here.
    No kernel launches.'''
    _, ts = _pair(name)
    before = (dict(fused.LAUNCHES), dict(dense_cast.LAUNCHES))
    f_fused = render_sample(ts, new_film(16, 16, device='cpu'), 3, fused=True)
    f_wave = render_sample(ts, new_film(16, 16, device='cpu'), 3, fused=False)
    f_auto = render(ts, new_film(16, 16, device='cpu'), 3, spp=1)
    assert torch.equal(f_fused, f_wave) and torch.equal(f_auto, f_wave)
    assert (dict(fused.LAUNCHES), dict(dense_cast.LAUNCHES)) == before


def test_megakernel_is_disney_only(monkeypatch):
    '''As in the reference (path.py:211-230), a model other than Disney
    renders the wavefront whatever `fused` says: fused=True equals
    fused=False bit for bit and launches no megakernel; the automatic
    route does the same.'''
    ts = tscenes.cornell_box(device='cpu')
    taken = []
    real = fused.fused_trace_primary
    monkeypatch.setattr(fused, 'fused_trace_primary',
                        lambda *a, **k: taken.append(1) or real(*a, **k))
    films = [render_sample(ts, new_film(8, 8, device='cpu'), 0, fused=f,
                           model='lambert') for f in (True, False, None)]
    render_sample(ts, new_film(8, 8, device='cpu'), 0, fused=True)
    assert taken == [1]  # the Disney call only
    assert bool(torch.isfinite(films[0]).all())
    assert torch.equal(films[0], films[1]) and torch.equal(films[2], films[1])
    assert fused.LAUNCHES['path'] == 0


@pytest.mark.parametrize('name', ['cornell', 'envlight'])
def test_depth_8_twin_equals_wavefront(name):
    '''max_depth 8 (a 50-dimension Sobol point) through fused=True, whose
    CPU twin runs the megakernel's uniforms, equals the wavefront bit for
    bit, as at depth 5.'''
    _, ts = _pair(name)
    res = 12 if name == 'envlight' else 16
    f_fused = render_sample(ts, new_film(res, res, device='cpu'), 4,
                            fused=True, max_depth=8)
    f_wave = render_sample(ts, new_film(res, res, device='cpu'), 4,
                           fused=False, max_depth=8)
    assert torch.equal(f_fused, f_wave)
    assert bool(torch.isfinite(f_fused).all()) and f_fused[0, :3].any()
