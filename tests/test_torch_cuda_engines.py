'''
The other engines and the worker on the card.  Marked `cuda`: each test
skips where torch.cuda.is_available() is false (the CPU-only test run).
On a machine with the card:

    python -m pytest tests/test_torch_cuda_engines.py -q -m cuda --noconftest

  * preview and brute launch the scene-level closest cast (one a sample,
    one a bounce) and never the occlusion cast; preview's albedo and
    normal passes through the CUDA casts equal those through the plain
    casts (within 1e-4 on >= 99.99% of pixels) on the dense and the
    blocked route; brute's mean is within 8% of the path render's;
  * an MLT step launches path_kernel's explicit-uniform head once and no
    cast, and makes no host-device synchronisation (sync debug mode
    'error' raises on one); its replay equals path_trace's on the same
    proposals;
  * the explicit-uniform head refuses strided, misplaced or misshapen
    operands before any launch;
  * a material id without a material row takes the defaults in the
    megakernel as in its twin (the worker's cornell shell with no
    materials loaded);
  * the worker renders on the card by default; its 'path', 'brute' and
    'mlt' engines and render_preview launch what their routes launch,
    its path image equals engine.path.render's bit for bit, and
    save_state / load_state resume a path and an MLT render bit for bit;
  * cornell_highpoly built with accel='dense' (101,782 faces, above the
    dense casts' limit) renders through the plain brute casts, with no
    launch, within 1e-3 (1 + |ref|) of the blocked route on >= 95% of
    pixels and its mean within 1%;
  * each of the reference benchmark's eight configurations
    (ptina_tpu_torch.bench.CONFIGS, at their own sizes: MLT with 2^17
    chains on 512^2, the 305,942-face capacity scene at 256^2 after its
    oracle, the textured scenes, the preview-then-render line) runs
    through run_config, which raises unless the timed window's launches
    are its route's, and gives a finite, positive rate.
'''

import math

import numpy as np
import pytest
import torch

from ptina_tpu_torch import worker
from ptina_tpu_torch.bench import CONFIGS, bench_texture, card_line, run_config
from ptina_tpu_torch.camera import camera_rays
from ptina_tpu_torch.engine import fused, mlt
from ptina_tpu_torch.engine.brute import render_brute
from ptina_tpu_torch.engine.mlt import mlt_init, mlt_step, render_mlt
from ptina_tpu_torch.engine.path import path_trace, render
from ptina_tpu_torch.engine.preview import render_preview
from ptina_tpu_torch.film import (PASS_ALBEDO, PASS_NORMAL, film_to_image,
                                  new_film)
from ptina_tpu_torch.intersect import blocked, dense_cast, dispatch
from ptina_tpu_torch.sampling.sobol import sobol_block
from ptina_tpu_torch.scene import make_scene
from ptina_tpu_torch.scenes import (cornell_box, cornell_highpoly,
                                    cornell_monkey, matball, _cornell_boxes,
                                    _cornell_shell, _materials,
                                    _mesh_to_vertices)
from ptina_tpu_torch.utils.vec import V3

import torch_assets
from torch_assets import grew, launches

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (CUDA kernels have no CPU mode)')
    return torch.device('cuda')


def test_preview_and_brute_launch_closest_casts_only(dev):
    scene = cornell_monkey(device=dev)
    before = launches()
    film = render_preview(scene, new_film(32, 32, device=dev), 0, spp=2)
    torch.cuda.synchronize()
    assert grew(before) == {'shade': 2}
    assert bool(torch.isfinite(film).all()) and not bool(film[0].any())
    before = launches()
    film = render_brute(scene, new_film(32, 32, device=dev), 0, spp=3,
                        max_depth=4)
    torch.cuda.synchronize()
    assert grew(before) == {'shade': 12}
    assert bool(torch.isfinite(film).all()) and bool((film[0, 3] == 3).all())


def _chains(dev, n=4096, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return mlt_init(n, generator=gen, device=dev)


def test_mlt_step_one_launch_no_sync(dev):
    scene = cornell_monkey(device=dev)
    state = _chains(dev)
    film = new_film(32, 32, device=dev)
    state, film = mlt_step(scene, state, film)  # warm up
    torch.cuda.synchronize()
    before = launches()
    torch.cuda.set_sync_debug_mode('error')
    try:
        state, film = mlt_step(scene, state, film)
    finally:
        torch.cuda.set_sync_debug_mode('default')
    torch.cuda.synchronize()
    assert grew(before) == {'path': 1}
    assert int(state.step) == 2 and bool(torch.isfinite(film).all())
    # the replay through the kernel and through path_trace, same proposals
    x, _, _ = mlt._propose(state, mlt.LSP, mlt.SIGMA)
    ro, rd = camera_rays(scene.cam_v2w, x[0] * 2.0 - 1.0, x[1] * 2.0 - 1.0)
    k = fused.fused_trace_uniforms(scene, ro, rd, x)
    p = path_trace(scene, ro, rd, x)
    for a, b in ((k.x, p.x), (k.y, p.y), (k.z, p.z)):
        assert (a == b).float().mean().item() >= 0.9999


def test_uniforms_head_refuses_bad_operands(dev):
    scene = cornell_box(device=dev)
    n = 256
    x = torch.rand(32, 2 * n, device=dev)
    ro, rd = camera_rays(scene.cam_v2w, x[0, :n] * 2 - 1, x[1, :n] * 2 - 1)
    before = fused.LAUNCHES['path']
    for bad in (x[:, ::2],                      # strided
                x[:, :n].cpu(),                 # on the host
                x[:31, :n].contiguous(),        # not 2 + 6 depth rows
                x[:, :n + 1].contiguous()):     # not N columns
        with pytest.raises(ValueError, match='uniforms'):
            fused.fused_trace_uniforms(scene, ro, rd, bad)
    ro2, _ = camera_rays(scene.cam_v2w, x[0] * 2 - 1, x[1] * 2 - 1)
    strided = V3(ro2.x[::2], ro2.y[::2], ro2.z[::2])
    with pytest.raises(ValueError, match='rays'):
        fused.fused_trace_uniforms(scene, strided, rd, x[:, :n].contiguous())
    assert fused.LAUNCHES['path'] == before
    out = fused.fused_trace_uniforms(scene, ro, rd, x[:, :n].contiguous())
    assert out.x.shape == (n,)


def test_material_id_without_row_takes_defaults(dev):
    shell, mtl = _cornell_shell()
    scene = make_scene(_mesh_to_vertices(shell), np.asarray(mtl, np.int32),
                       device=dev)
    assert scene.materials.fac.shape[0] == 1 and max(mtl) >= 1
    pt = sobol_block(0, 32)
    k = fused.fused_trace_primary(scene, pt, 32, 32)
    p = fused.fused_trace_primary_plain(scene, pt, 32, 32)
    torch.cuda.synchronize()
    for a, b in ((k.x, p.x), (k.y, p.y), (k.z, p.z)):
        assert bool(torch.isfinite(a).all())
        assert ((a - b).abs() < 1e-3).float().mean().item() >= 0.95


def test_worker_renders_on_the_card_by_default(dev):
    worker.init()
    worker.set_size(16, 16)
    shell, mtl = _cornell_shell()
    worker.load_model(_mesh_to_vertices(shell), np.asarray(mtl, np.int32))
    before = launches()
    worker.render()
    worker.synchronize()
    assert worker._S.film.is_cuda and worker._S.scene.device.type == 'cuda'
    assert grew(before) == {'path': 1}
    assert np.isfinite(worker.get_image()).all()


def _share_within(got, ref, tol):
    return ((got - ref).abs() <= tol).all(-1).float().mean().item()


@pytest.mark.parametrize('name', ['matball', 'cornell_highpoly'])
def test_preview_matches_the_plain_casts(dev, name, monkeypatch):
    if name == 'matball':
        scene, key = matball(roughness_tex=bench_texture(), device=dev), \
            'shade'
    else:
        scene, key = cornell_highpoly(nu=48, nv=24, accel='blocked',
                                      device=dev), 'blocked_shade'
    before = launches()
    film = render_preview(scene, new_film(64, 64, device=dev), 0, spp=1)
    torch.cuda.synchronize()
    assert grew(before) == {key: 1}
    monkeypatch.setattr(dense_cast, 'cast_shade', dense_cast.cast_shade_plain)
    monkeypatch.setattr(blocked, 'blocked_cast_shade',
                        blocked.blocked_cast_shade_plain)
    plain = render_preview(scene, new_film(64, 64, device=dev), 0, spp=1)
    assert not bool(film[0].any())
    for p in (PASS_ALBEDO, PASS_NORMAL):
        img = film_to_image(film, p)
        assert bool(torch.isfinite(img).all())
        assert bool((film[p, 3] == 1).all())
        assert _share_within(img, film_to_image(plain, p), 1e-4) >= 0.9999


def test_brute_is_near_the_path_render(dev):
    scene = cornell_box(device=dev)
    before = launches()
    film = render_brute(scene, new_film(64, 64, device=dev), 0, spp=32)
    torch.cuda.synchronize()
    assert grew(before) == {'shade': 5 * 32}
    assert bool((film[0, 3] == 32).all())
    path = render(scene, new_film(64, 64, device=dev), 0, spp=32)
    a = film_to_image(film)[..., :3]
    b = film_to_image(path)[..., :3]
    assert bool(torch.isfinite(a).all())
    mean, path_mean = a.mean().item(), b.mean().item()
    assert abs(mean - path_mean) / max(mean, path_mean) < 0.08


def test_kelemen_brightness(dev):
    scene = cornell_box(device=dev)
    truth = film_to_image(render(scene, new_film(64, 64, device=dev), 0,
                                 spp=256))[..., :3]
    gen = torch.Generator(device=dev).manual_seed(7)
    _, film = render_mlt(scene, mlt_init(2 ** 16, generator=gen, device=dev),
                         new_film(64, 64, device=dev), steps=128)
    img = film_to_image(film)[..., :3]
    assert bool(torch.isfinite(img).all())
    err = abs(img.mean().item() - truth.mean().item()) / truth.mean().item()
    assert err < 0.05, err


def _worker_scene(res):
    '''scenes.cornell_box built through the worker's calls.'''
    shell, mtl = _cornell_shell()
    tall, short = _cornell_boxes()
    torch_assets.load_worker(
        worker, _mesh_to_vertices(np.concatenate([shell, tall, short])),
        np.asarray(mtl + [0] * 24, np.int32), _materials(), res=res)


def test_worker_engines_on_the_card(dev):
    worker.init()
    _worker_scene(64)
    for engine, n, want in (('path', 4, {'path': 4}),
                            ('brute', 2, {'shade': 10}),
                            ('mlt', 2, {'path': 2})):
        worker.set_engine(engine)
        worker.clear()
        before = launches()
        for _ in range(n):
            worker.render()
        torch.cuda.synchronize()
        assert grew(before) == want, engine
        img = worker.get_image()
        assert img.shape == (64, 64, 4) and np.isfinite(img).all()
        if engine == 'path':
            ref = film_to_image(render(cornell_box(device=dev),
                                       new_film(64, 64, device=dev), 0,
                                       spp=n)).cpu().numpy()
            np.testing.assert_array_equal(img, ref)
    before = launches()
    worker.render_preview()
    torch.cuda.synchronize()
    assert grew(before) == {'shade': 1}
    assert np.isfinite(worker.get_image(PASS_ALBEDO)).all()


@pytest.mark.parametrize('engine', ['path', 'mlt'])
def test_worker_resumes_bit_for_bit(dev, engine, tmp_path):
    '''Two renders, save_state, a third; a fresh worker loads the file
    and renders the third: the same image (and MLT chains).'''
    ckpt = str(tmp_path / 'worker.ckpt')
    worker.init(engine=engine)
    _worker_scene(64)
    worker.render()
    worker.render()
    worker.save_state(ckpt)
    worker.render()
    want, chains = worker.get_image(), worker._S.mlt_state
    worker.init()
    _worker_scene(64)
    assert worker.load_state(ckpt)
    worker.render()
    np.testing.assert_array_equal(worker.get_image(), want)
    if engine == 'mlt':
        got = worker._S.mlt_state
        for a, b in ((got.x, chains.x), (got.l.x, chains.l.x),
                     (got.l.y, chains.l.y), (got.l.z, chains.l.z),
                     (got.b_sum, chains.b_sum), (got.b_cnt, chains.b_cnt),
                     (got.step, chains.step)):
            assert torch.equal(a, b)


def test_dense_highpoly_takes_the_brute_route(dev):
    '''The blocked casts' t lies on the 2^-12 key grid and brute's is
    exact, so on facets this small a few paths branch apart.'''
    scene = cornell_highpoly(device=dev, accel='dense')
    assert dispatch.route(scene.tri_w2b.shape[0], 'dense') == 'brute'
    before = launches()
    film = render(scene, new_film(64, 64, device=dev), 0, spp=1)
    torch.cuda.synchronize()
    assert grew(before) == {}
    before = launches()
    ref = render(cornell_highpoly(device=dev), new_film(64, 64, device=dev),
                 0, spp=1)
    torch.cuda.synchronize()
    assert grew(before) == {'blocked_shade': 5, 'blocked_any': 5}
    img, want = film_to_image(film)[..., :3], film_to_image(ref)[..., :3]
    assert bool(torch.isfinite(img).all())
    close = ((img - want).abs() <= 1e-3 * (1.0 + want.abs())).all(-1)
    assert close.float().mean().item() >= 0.95
    assert abs(img.mean().item() - want.mean().item()) \
        < 0.01 * want.mean().item()


@pytest.mark.parametrize('cfg', CONFIGS, ids=[c.metric for c in CONFIGS])
def test_reference_benchmark_configuration(dev, cfg):
    '''Each line of python -m ptina_tpu_torch.bench at its own size:
    run_config raises unless the timed window's launches are the route's
    (check_launches); the line is finite, positive and names its card.'''
    card = card_line()
    line = run_config(cfg, card)
    assert (line['metric'], line['route']) == (cfg.metric, cfg.route)
    assert line['device'] == card and line['samples'] >= 1
    assert math.isfinite(line['value']) and line['value'] > 0
    assert math.isfinite(line['seconds']) and line['seconds'] > 0
