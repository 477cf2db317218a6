'''
The PyTorch port's wavefront render (ptina_tpu_torch.engine.path) as a
whole: against the JAX reference's render of the same scene arrays, and
alone against the stored golden image.

Port vs JAX (32x32, 2 spp, identical deterministic uniforms): on the CPU
the reference casts with brute, the port with the dense-cast contract,
and the two differ on a few rays by design (the contract's t is the
packed key's, on a 2^-12 grid, and it accepts grazing |b0| < 1e-6 hits
that brute rejects; intersect/plucker.py).  Tolerances: image means
within 1%, and at least 98% of pixels within 1e-3 * (1 + |ref|).

The same comparison at max_depth 8 (50 Sobol dimensions, above the 32
the port first embedded) on cornell_box at 16x16.

Golden: tests/test_parity.py's tolerances (mean 1.5%, patch 5%) at 64 spp.
cornell_monkey's golden (96 spp) runs on the GPU in chip_smoke.py: the
CPU plain cast is too slow for it here.
'''

import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ptina_tpu import scenes as jscenes
from ptina_tpu.film import new_film as jnew_film, film_to_image as jto_image
from ptina_tpu.engine.path import (render as jrender,
                                   render_sample as jrender_sample,
                                   power_heuristic as jpower_heuristic)
from ptina_tpu_torch import scenes as tscenes
from ptina_tpu_torch.scene import scene_from_numpy, make_scene
from ptina_tpu_torch.film import new_film, film_to_image
from ptina_tpu_torch.engine.path import (render, render_sample,
                                         power_heuristic, MAX_DEPTH,
                                         PATH_DIMS)
from ptina_tpu_torch.engine.fused import fused_trace_primary_plain
from ptina_tpu_torch.sampling.sobol import sobol_block
from ptina_tpu_torch.intersect import dense_cast
from ptina_tpu_torch.io.encoding import decode_numpy_array

from test_torch_scene import jax_scene_arrays

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), 'golden')


def _port_image(scene, res, spp):
    film = render(scene, new_film(res, res, device='cpu'), 0, spp=spp)
    return film_to_image(film)[..., :3].numpy()


@pytest.mark.parametrize('name', ['cornell_box', 'cornell_monkey'])
def test_render_matches_reference(name):
    js = getattr(jscenes, name)()
    ref = np.asarray(jto_image(jrender(js, jnew_film(32, 32), 0,
                                       spp=2)))[..., :3]
    before = dict(dense_cast.LAUNCHES)
    got = _port_image(scene_from_numpy(jax_scene_arrays(js), device='cpu'),
                      32, 2)
    assert dense_cast.LAUNCHES == before  # CPU: plain casts, no kernel
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert abs(got.mean() - ref.mean()) / ref.mean() < 0.01
    close = (np.abs(got - ref) <= 1e-3 * (1.0 + np.abs(ref))).all(-1)
    assert close.mean() >= 0.98, close.mean()


def test_render_depth_8_matches_reference():
    '''max_depth 8 through the port's wavefront against the JAX
    wavefront's render_sample, two samples, at the tolerances above.'''
    js = jscenes.cornell_box()
    ts = scene_from_numpy(jax_scene_arrays(js), device='cpu')
    jfilm, tfilm = jnew_film(16, 16), new_film(16, 16, device='cpu')
    for s in (0, 1):
        jfilm = jrender_sample(js, jfilm, s, fused=False, max_depth=8)
        tfilm = render_sample(ts, tfilm, s, fused=False, max_depth=8)
    ref = np.asarray(jto_image(jfilm))[..., :3]
    got = film_to_image(tfilm)[..., :3].numpy()
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert abs(got.mean() - ref.mean()) / ref.mean() < 0.01
    close = (np.abs(got - ref) <= 1e-3 * (1.0 + np.abs(ref))).all(-1)
    assert close.mean() >= 0.98, close.mean()


def _blur(img, k=2):
    h, w, c = img.shape
    return img.reshape(h // (2 * k), 2 * k, w // (2 * k), 2 * k, c) \
              .mean(axis=(1, 3))


def test_cornell_matches_golden():
    with open(os.path.join(GOLDEN, 'cornell_64x64_512spp.txt')) as fh:
        gold = decode_numpy_array(fh.read())
    img = _port_image(tscenes.cornell_box(device='cpu'), 64, 64)
    assert abs(img.mean() - gold.mean()) / gold.mean() < 0.015
    pa, pb = _blur(img), _blur(gold)
    assert (np.abs(pa - pb) / (pb + 0.05)).mean() < 0.05


def test_power_heuristic_matches_reference():
    a = np.asarray([0.0, 1e-9, 0.5, 1.0, 10.0, 1e7], np.float32)
    b = np.asarray([1.0, 1.0, 0.5, 3.0, 0.1, 1.0], np.float32)
    ref = np.asarray(jpower_heuristic(jnp.asarray(a), jnp.asarray(b)))
    got = power_heuristic(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6)


def test_env_only_furnace():
    '''Rays that hit nothing return exactly the environment color.'''
    verts = np.zeros((3, 8), np.float32)
    verts[:, :3] = [[100, 100, 100], [101, 100, 100], [100, 101, 100]]
    verts[:, 5] = 1.0
    scene = make_scene(verts, lights=[], default_light=False,
                       world_fac=(0.7, 0.6, 0.5, 1.0), device='cpu')
    img = _port_image(scene, 16, 1)
    np.testing.assert_allclose(img, np.broadcast_to([0.7, 0.6, 0.5],
                                                    img.shape), atol=1e-5)


def test_render_is_deterministic_and_progressive():
    scene = tscenes.cornell_box(device='cpu')
    f1 = render(scene, new_film(16, 16, device='cpu'), 0, spp=2)
    f2 = render(scene, new_film(16, 16, device='cpu'), 0, spp=2)
    assert torch.equal(f1, f2)
    # two calls of one sample each accumulate the same film as one call
    f3 = render(scene, new_film(16, 16, device='cpu'), 0, spp=1)
    f3 = render(scene, f3, 1, spp=1)
    assert torch.equal(f1, f3)
    assert (f1[0, 3] == 2).all() and not f1[1:].any()


def test_path_trace_counts_lanes_per_bounce():
    '''path_trace's lanes: per bounce, the paths alive at its closest cast
    and the paths that cast a shadow ray (the casts the megakernel makes,
    chip_smoke.py's bound count) with those casts' rays and results,
    without changing the radiance.'''
    scene = tscenes.cornell_box(device='cpu')
    pt = sobol_block(9, PATH_DIMS)
    lanes = []
    got = fused_trace_primary_plain(scene, pt, 16, 16, lanes=lanes)
    ref = fused_trace_primary_plain(scene, pt, 16, 16)
    assert all(torch.equal(getattr(got, c), getattr(ref, c)) for c in 'xyz')
    alive = [int(lane['alive'].sum()) for lane in lanes]
    shadow = [int(lane['shadow'].sum()) for lane in lanes]
    assert len(lanes) == MAX_DEPTH and alive[0] == 256
    assert all(a >= b for a, b in zip(alive, alive[1:]))
    assert all(0 < s <= a for a, s in zip(alive, shadow))
    # the casts' rays and results: a shadow ray leaves its path's hit
    for lane in lanes:
        assert not (lane['shadow'] & ~lane['hit'].hit).any()
        assert (lane['rd'].x.shape[0], lane['tmax'].shape[0]) == (256, 256)
        assert not (lane['occ'] & (lane['tmax'] == 0.0)).any()
