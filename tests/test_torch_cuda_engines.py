'''
The other engines and the worker on the card.  Marked `cuda`: each test
skips where torch.cuda.is_available() is false (the CPU-only test run).
On a machine with the card:

    python -m pytest tests/test_torch_cuda_engines.py -q -m cuda --noconftest

  * preview and brute launch the scene-level closest cast (one a sample,
    one a bounce) and never the occlusion cast;
  * an MLT step launches path_kernel's explicit-uniform head once and no
    cast, and makes no host-device synchronisation (sync debug mode
    'error' raises on one); its replay equals path_trace's on the same
    proposals;
  * the explicit-uniform head refuses strided, misplaced or misshapen
    operands before any launch;
  * a material id without a material row takes the defaults in the
    megakernel as in its twin (the worker's cornell shell with no
    materials loaded);
  * the worker renders on the card by default.
'''

import numpy as np
import pytest
import torch

from ptina_tpu_torch import worker
from ptina_tpu_torch.camera import camera_rays
from ptina_tpu_torch.engine import fused, mlt
from ptina_tpu_torch.engine.brute import render_brute
from ptina_tpu_torch.engine.mlt import mlt_init, mlt_step
from ptina_tpu_torch.engine.path import path_trace
from ptina_tpu_torch.engine.preview import render_preview
from ptina_tpu_torch.film import new_film
from ptina_tpu_torch.intersect import dense_cast
from ptina_tpu_torch.sampling.sobol import sobol_block
from ptina_tpu_torch.scene import make_scene
from ptina_tpu_torch.scenes import (cornell_box, cornell_monkey,
                                    _cornell_shell, _mesh_to_vertices)
from ptina_tpu_torch.utils.vec import V3

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (CUDA kernels have no CPU mode)')
    return torch.device('cuda')


def _launches():
    return {**dense_cast.LAUNCHES, **fused.LAUNCHES}


def _grew(before):
    return {k: v - before[k] for k, v in _launches().items() if v != before[k]}


def test_preview_and_brute_launch_closest_casts_only(dev):
    scene = cornell_monkey(device=dev)
    before = _launches()
    film = render_preview(scene, new_film(32, 32, device=dev), 0, spp=2)
    torch.cuda.synchronize()
    assert _grew(before) == {'shade': 2}
    assert bool(torch.isfinite(film).all()) and not bool(film[0].any())
    before = _launches()
    film = render_brute(scene, new_film(32, 32, device=dev), 0, spp=3,
                        max_depth=4)
    torch.cuda.synchronize()
    assert _grew(before) == {'shade': 12}
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
    before = _launches()
    torch.cuda.set_sync_debug_mode('error')
    try:
        state, film = mlt_step(scene, state, film)
    finally:
        torch.cuda.set_sync_debug_mode('default')
    torch.cuda.synchronize()
    assert _grew(before) == {'path': 1}
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
    before = _launches()
    worker.render()
    worker.synchronize()
    assert worker._S.film.is_cuda and worker._S.scene.device.type == 'cuda'
    assert _grew(before) == {'path': 1}
    assert np.isfinite(worker.get_image()).all()
