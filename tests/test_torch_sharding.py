'''
The port's tiled, batched and film-band renders and its data-parallel
gradient step (ptina_tpu_torch.engine.path, ptina_tpu_torch.parallel)
against the JAX package and against its own one-device render, on the
CPU, on cornell_box carried from the JAX package
(test_torch_scene.jax_scene_arrays):

  * render_sample on the two 8x8 tiles of a 16x8 film (x0 = 0, 8,
    full_res = (16, 8)) against JAX render_sample's tiles on the
    wavefront, through both of the port's routes, under
    tests/test_torch_render.py's tolerances (image means within 1%, >= 98%
    of pixels within 1e-3 * (1 + |ref|)); the port's megakernel tile
    against JAX fused_trace_primary(interpret=True) at the same offsets,
    under tests/test_fused.py's (>= 95% of paths within 1e-3, means
    within 2e-3); each tile equal bit for bit to the same rows of the
    port's whole frame;
  * render with spb 1, 3 and 8 bit-equal;
  * render_sharded over 8 x cpu equal to render bit for bit on both
    routes, and to JAX render_sharded over its 8 virtual devices
    (tests/test_sharding.py:19-25) under the render tolerances above, with
    equal sample counts.  Not allclose(atol=1e-5), which JAX's own test
    asks of its sharded render against its one-device render: the port's
    CPU casts keep the contract's t on the 2^-12 key grid where JAX's use
    brute's exact t (tests/test_torch_render.py), which moves 13% of this
    film's values by up to 6e-3; the port's bands equal its own one-device
    render bit for bit instead;
  * no collective of torch.distributed runs during render_sharded;
  * train_step_sharded's gradient equal to the one-device gradient of the
    same loss at tests/test_sharding.py:52-79's tolerances (rtol 1e-3,
    atol 1e-6 max|g|), and to ptina_tpu.diff.material_grad at
    tests/test_torch_grad_parity.py's (every entry within rtol 0.05, atol
    1e-4 max|g_jax|; loss within 1%); two steps descend;
  * init_distributed() without configuration is a no-op; a mesh of CUDA
    devices never renders on the CPU.

JAX's sharded gradient step is not compiled here (tests/test_sharding.py
compiles it; ~120 s on XLA:CPU): the port's is held to its one-device
gradient and to JAX's material_grad, which that test holds JAX's to.
'''

import numpy as np
import pytest
import torch
import torch.distributed as dist
import jax
import jax.numpy as jnp

from ptina_tpu import scenes as jscenes
from ptina_tpu import diff as jdiff
from ptina_tpu.engine.fused import fused_trace_primary as jfused_primary
from ptina_tpu.engine.path import render_sample as jrender_sample
from ptina_tpu.film import new_film as jnew_film, film_to_image as jto_image
from ptina_tpu.parallel import (make_mesh as jmake_mesh,
                                render_sharded as jrender_sharded)
from ptina_tpu.sampling.sobol import sobol_block as jsobol_block
from ptina_tpu_torch.engine.path import render, render_sample
from ptina_tpu_torch.film import film_to_image, new_film
from ptina_tpu_torch.parallel import (init_distributed, is_distributed,
                                      make_mesh, render_sharded,
                                      train_step_sharded)
from ptina_tpu_torch.parallel.distributed import _COLLECTIVES
from ptina_tpu_torch.scene import scene_from_numpy, with_tensor

from test_torch_scene import jax_scene_arrays

torch.set_num_threads(2)

NX, NY = 16, 8
CPU8 = ('cpu',) * 8


@pytest.fixture(scope='module')
def cornell():
    js = jscenes.cornell_box()
    return js, scene_from_numpy(jax_scene_arrays(js), device='cpu')


def _hold_render(got, ref):
    '''tests/test_torch_render.py's tolerances.'''
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert abs(got.mean() - ref.mean()) / ref.mean() < 0.01
    close = (np.abs(got - ref) <= 1e-3 * (1.0 + np.abs(ref))).all(-1)
    assert close.mean() >= 0.98, close.mean()


@pytest.mark.parametrize('fused', [False, True], ids=['wavefront',
                                                      'megakernel'])
def test_tiles_match_jax_and_the_whole_frame(cornell, fused):
    js, ts = cornell
    whole = render_sample(ts, new_film(NX, NY, device='cpu'), 0, fused=fused)
    for x0 in (0, 8):
        tile = render_sample(ts, new_film(8, NY, device='cpu'), 0, x0=x0,
                             full_res=(NX, NY), fused=fused)
        assert torch.equal(tile, whole[:, :, x0:x0 + 8])
        ref = jrender_sample(js, jnew_film(8, NY), 0, x0=x0,
                             full_res=(NX, NY), fused=False)
        _hold_render(film_to_image(tile)[..., :3].numpy(),
                     np.asarray(jto_image(ref))[..., :3])


def test_megakernel_tile_matches_jax_kernel(cornell):
    '''The tile at x0 = 8 of the 16x8 frame through the port's megakernel
    route against JAX's kernel in interpret mode with the same offsets.'''
    js, ts = cornell
    tile = render_sample(ts, new_film(8, NY, device='cpu'), 0, x0=8,
                         full_res=(NX, NY), fused=True)
    got = tile[0, :3].reshape(3, -1).numpy()
    r = jfused_primary(js, jsobol_block(0, 32), 8, NY, x0=8, y0=0, fnx=NX,
                       fny=NY, interpret=True)
    ref = np.stack([np.asarray(c) for c in (r.x, r.y, r.z)])
    agree = (np.abs(got - ref) <= 1e-3).all(0).mean()
    assert agree >= 0.95, agree
    assert abs(got.mean() - ref.mean()) <= 2e-3 * abs(ref.mean())


def test_render_is_the_same_bits_for_every_spb(cornell):
    _, ts = cornell
    films = [render(ts, new_film(8, 8, device='cpu'), 3, spp=8, spb=spb)
             for spb in (1, 3, 8, None)]
    assert all(torch.equal(films[0], f) for f in films[1:])
    assert (films[0][0, 3] == 8).all()
    with pytest.raises(ValueError):
        render(ts, new_film(8, 8, device='cpu'), 0, spp=2, spb=0)


@pytest.mark.parametrize('fused', [None, False, True],
                         ids=['auto', 'wavefront', 'megakernel'])
def test_render_sharded_equals_render(cornell, fused):
    _, ts = cornell
    film = new_film(NX, NY, device='cpu')
    if fused is None:
        ref = render(ts, new_film(NX, NY, device='cpu'), 0, spp=2)
    else:
        ref = new_film(NX, NY, device='cpu')
        for s in range(2):
            render_sample(ts, ref, s, fused=fused)
    out = render_sharded(ts, film, 0, make_mesh(CPU8), spp=2, fused=fused)
    assert out is film and torch.equal(film, ref)


def test_render_sharded_matches_jax_sharded(cornell):
    js, ts = cornell
    if len(jax.devices()) < 8:
        pytest.skip('needs 8 virtual devices (see conftest XLA_FLAGS)')
    ref = jrender_sharded(js, jnew_film(NX, NY), 0,
                          jmake_mesh(jax.devices()[:8]), spp=1)
    got = render_sharded(ts, new_film(NX, NY, device='cpu'), 0,
                         make_mesh(CPU8))
    assert torch.equal(got[:, 3], torch.from_numpy(np.array(ref)[:, 3]))
    _hold_render(film_to_image(got)[..., :3].numpy(),
                 np.asarray(jto_image(ref))[..., :3])


def test_render_sharded_is_collective_free(cornell, monkeypatch):
    '''Every collective of torch.distributed raises during the render.'''
    _, ts = cornell

    def refuse(*args, **kwargs):
        raise AssertionError('a collective ran while rendering')
    for name in _COLLECTIVES:
        if hasattr(dist, name):
            monkeypatch.setattr(dist, name, refuse)
    film = render_sharded(ts, new_film(NX, NY, device='cpu'), 0,
                          make_mesh(CPU8), spp=1)
    assert (film[0, 3] == 1).all()


def test_mesh_rules(cornell):
    _, ts = cornell
    assert make_mesh(['cpu', 'cpu']) == (torch.device('cpu'),) * 2
    with pytest.raises(ValueError):  # 16 rows into 3 bands
        render_sharded(ts, new_film(NX, NY, device='cpu'), 0,
                       make_mesh(('cpu',) * 3))
    with pytest.raises(ValueError):
        make_mesh([])


def test_cuda_mesh_never_renders_on_the_cpu(cornell):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    _, ts = cornell
    with pytest.raises(RuntimeError):
        make_mesh()  # no CUDA device to default to
    with pytest.raises((RuntimeError, AssertionError)):
        render_sharded(ts, new_film(NX, NY, device='cpu'), 0,
                       make_mesh(['cuda'] * 2))


def _target():
    return np.random.RandomState(5).uniform(0.0, 1.0, (NX, NY, 3)) \
        .astype(np.float32)


def test_sharded_gradient_equals_one_device_and_jax(cornell):
    js, ts = cornell
    target = _target()
    lr = 0.1
    fac0 = ts.materials.fac.clone()
    film0 = new_film(NX, NY, device='cpu')
    stepped, loss = train_step_sharded(ts, film0, target, 0,
                                       make_mesh(CPU8), lr=lr)
    assert torch.equal(ts.materials.fac, fac0) and not film0.any()
    g_sharded = ((fac0 - stepped.materials.fac) / lr).numpy()

    fac = fac0.clone().requires_grad_(True)
    film = render_sample(with_tensor(ts, ('materials', 'fac'), fac),
                         new_film(NX, NY, device='cpu'), 0, fused=False)
    full = torch.mean((film_to_image(film)[..., :3]
                       - torch.from_numpy(target)) ** 2)
    g_one, = torch.autograd.grad(full, fac)
    g_one = g_one.numpy()
    assert np.abs(g_one).max() > 0
    assert np.allclose(g_sharded, g_one, rtol=1e-3,
                       atol=1e-6 * max(np.abs(g_one).max(), 1e-9))
    assert abs(loss.item() - full.item()) <= 1e-5 * full.item()

    jloss, gj = jdiff.material_grad(js, jnp.asarray(target))
    gj = np.asarray(gj)
    assert abs(loss.item() - float(jloss)) <= 0.01 * float(jloss)
    atol = 1e-4 * max(np.abs(gj).max(), 1e-6)
    close = np.isclose(g_sharded, gj, rtol=0.05, atol=atol)
    assert close.all(), (close.mean(), np.abs(g_sharded - gj).max(), atol)


def test_train_step_sharded_descends(cornell):
    _, ts = cornell
    target = np.zeros((NX, NY, 3), np.float32)
    film0 = new_film(NX, NY, device='cpu')
    mesh = make_mesh(CPU8)
    s1, l1 = train_step_sharded(ts, film0, target, 0, mesh, lr=0.1)
    s2, l2 = train_step_sharded(s1, film0, target, 0, mesh, lr=0.1)
    assert np.isfinite(l1.item()) and np.isfinite(l2.item())
    assert l2.item() <= l1.item() + 1e-3


def test_init_distributed_single_process_noop(monkeypatch):
    for name in ('WORLD_SIZE', 'RANK', 'MASTER_ADDR', 'MASTER_PORT'):
        monkeypatch.delenv(name, raising=False)
    assert init_distributed() is False
    assert is_distributed() is False and not dist.is_initialized()
    monkeypatch.setenv('WORLD_SIZE', '1')
    assert init_distributed() is False and not dist.is_initialized()
