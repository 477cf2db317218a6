'''
The gradients on the card (ptina_tpu_torch.diff, engine/fused.
fused_trace_diff).  Marked `cuda`: each test skips where
torch.cuda.is_available() is false (the CPU-only test run).  On a machine
with the card:

    python -m pytest tests/test_torch_cuda_grad.py -q -m cuda --noconftest

At 64x64, 1 spp:
  * the pair (path_kernel's explicit-uniform head forward, a path_trace
    recompute backward on the CUDA casts) against autograd through the
    wavefront: losses within 2e-3 relative, gradients allclose(rtol=0.05,
    atol=1e-4 * max|g|) (tests/test_grad.py:161-165's tolerances);
  * the launches of each route: the pair 1 path + 5 shade + 5 any, the
    wavefront 5 shade + 5 any, a blocked-route scene 5 blocked_shade + 5
    blocked_any, each with the material fetch's 5 material_rows
    backwards;
  * fused_trace_diff raises for a CUDA scene that is not fused_eligible,
    and render_image_diff's automatic route takes the wavefront for it;
  * the texture gradient is finite and only its fetched channel is
    nonzero; the card's gradient agrees with the CPU's on the same scene;
  * the kernels' hits carry no graph when rd requires grad;
  * each gradient against a central difference of its loss (5% of
    max(|fd|, a floor), tests/test_grad.py's check): cornell_monkey's
    white-wall basecolor red, the light color (cornell) and the world
    factor (envlight) in the image mean, matball's highest-gradient
    texel of the 64x64 ramp, and a blocked-route cornell_highpoly's
    white-wall basecolor red;
  * inverse_render_step's first step is fac - lr * g bit for bit, and
    four steps toward the wall at half its basecolor lower the loss.
'''

import numpy as np
import pytest
import torch

from ptina_tpu_torch import diff
from ptina_tpu_torch.bench import bench_texture
from ptina_tpu_torch.camera import camera_rays
from ptina_tpu_torch.engine import fused, path as tpath
from ptina_tpu_torch.engine.fused import fused_trace_diff
from ptina_tpu_torch.engine.path import pixel_grid, PATH_DIMS
from ptina_tpu_torch.sampling.sobol import sample_dims
from ptina_tpu_torch.scene import with_tensor
from ptina_tpu_torch.scenes import (cornell_box, cornell_highpoly,
                                    cornell_monkey, envlight_scene, matball)
from ptina_tpu_torch.utils.vec import V3

from torch_assets import grew, launches

pytestmark = pytest.mark.cuda

RES = 64
DEPTH = 5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (CUDA kernels have no CPU mode)')
    return torch.device('cuda')


def _target(dev, seed=0):
    return torch.tensor(np.random.RandomState(seed).uniform(
        0.0, 1.0, (RES, RES, 3)).astype(np.float32), device=dev)


@pytest.mark.parametrize('make', [cornell_box, cornell_monkey],
                         ids=['cornell_box', 'cornell_monkey'])
def test_pair_gradients_match_the_wavefront(dev, make):
    scene = make(device=dev)
    target = _target(dev)
    before = launches()
    lf, gf = diff.material_grad(scene, target)
    torch.cuda.synchronize()
    assert grew(before) == {'path': 1, 'shade': DEPTH, 'any': DEPTH,
                            'material_rows': DEPTH}
    before = launches()
    lw, gw = diff._loss_and_grad(scene, target, ('materials', 'fac'),
                                 trace_diff=False)
    torch.cuda.synchronize()
    assert grew(before) == {'shade': DEPTH, 'any': DEPTH,
                            'material_rows': DEPTH}
    assert abs(lf.item() - lw.item()) < 2e-3 * max(lw.item(), 1e-6)
    assert torch.isfinite(gf).all() and gw.abs().max() > 0
    assert torch.allclose(gf, gw, rtol=0.05,
                          atol=1e-4 * max(gw.abs().max().item(), 1e-6))


def test_ineligible_scene_raises_in_the_pair_and_takes_the_wavefront(dev):
    scene = cornell_box(device=dev, accel='blocked')
    assert not fused.fused_eligible(scene)
    ii, jj = pixel_grid(RES, RES, device=dev)
    u = sample_dims(0, ii, jj, PATH_DIMS)
    ro, rd = camera_rays(scene.cam_v2w, ii.float() / RES * 2 - 1,
                         jj.float() / RES * 2 - 1)
    before = launches()
    with pytest.raises(ValueError, match='fused_eligible'):
        fused_trace_diff(scene, ro, rd, u)
    assert grew(before) == {}
    loss, g = diff.material_grad(scene, _target(dev))
    torch.cuda.synchronize()
    assert grew(before) == {'blocked_shade': DEPTH, 'blocked_any': DEPTH,
                            'material_rows': DEPTH}
    assert torch.isfinite(g).all() and g.abs().max() > 0


def test_texture_gradient_is_finite_and_local(dev):
    scene = matball(roughness_tex=np.full((8, 8, 3), 0.5, np.float32),
                    device=dev)
    loss, g = diff.texture_grad(scene, torch.zeros(RES, RES, 3, device=dev))
    assert loss.item() > 0 and torch.isfinite(g).all()
    assert g[0, :, :, 1:].abs().sum().item() == 0
    ch0 = g[0, :, :, 0].abs()
    assert 0 < (ch0 > 1e-3 * ch0.max()).float().mean().item() < 1


def test_card_gradient_agrees_with_the_cpu(dev):
    target = np.random.RandomState(5).uniform(0.0, 1.0, (16, 16, 3)) \
        .astype(np.float32)
    lc, gc = diff._loss_and_grad(cornell_box(device=dev), target,
                                 ('materials', 'fac'), trace_diff=False)
    lh, gh = diff.material_grad(cornell_box(device='cpu'), target)
    gc = gc.cpu()
    assert abs(lc.item() - lh.item()) < 1e-2 * lh.item()
    assert torch.allclose(gc, gh, rtol=0.05, atol=1e-4 * gh.abs().max())


def test_kernel_hits_are_detached(dev):
    scene = cornell_monkey(device=dev)
    ii, jj = pixel_grid(RES, RES, device=dev)
    ro, rd = camera_rays(scene.cam_v2w, (ii.float() + 0.5) / RES * 2 - 1,
                         (jj.float() + 0.5) / RES * 2 - 1)
    rd = V3(*(r.detach().requires_grad_(True) for r in (rd.x, rd.y, rd.z)))
    avoid = torch.full((RES * RES,), -1, dtype=torch.int32, device=dev)
    hit, hitpos, normal, _, material = tpath._cast_and_shade(scene, ro, rd,
                                                             avoid)
    assert bool(hit.hit.any())
    for t in (hit.t, hit.u, hit.v, normal.x, normal.y, normal.z):
        assert t.grad_fn is None and not t.requires_grad
    assert hitpos.x.grad_fn is not None
    fac = scene.materials.fac.detach().requires_grad_(True)
    sc = with_tensor(scene, ('materials', 'fac'), fac)
    _, _, _, _, material = tpath._cast_and_shade(sc, ro, rd, avoid)
    assert material['roughness'].requires_grad


# (scene, tensor, entry or None for the highest-gradient texel, eps,
# floor, the loss: MSE against black, or the image mean)
FD_CASES = {
    'cornell_monkey_basecolor': (
        lambda d: cornell_monkey(device=d), ('materials', 'fac'), (0, 0, 0),
        1e-2, 1e-3, 'mse'),
    'cornell_light_color': (
        lambda d: cornell_box(device=d), ('lights', 'color'), (0, 0), 1e-1,
        1e-5, 'mean'),
    'envlight_world_factor': (
        lambda d: envlight_scene(device=d), ('world_fac',), (0,), 1e-2, 1e-4,
        'mean'),
    'matball_texel': (
        lambda d: matball(roughness_tex=bench_texture(), device=d),
        ('textures', 'data'), None, 1e-2, 1e-4, 'mse'),
    'highpoly_basecolor': (
        lambda d: cornell_highpoly(nu=48, nv=24, accel='blocked', device=d),
        ('materials', 'fac'), (0, 0, 0), 1e-2, 1e-3, 'mse')}


def _get(obj, where):
    for name in where:
        obj = getattr(obj, name)
    return obj


def _fd_loss(img, kind):
    return img.mean() if kind == 'mean' else torch.mean(img ** 2)


@pytest.mark.parametrize('name', sorted(FD_CASES))
def test_gradient_matches_a_central_difference(dev, name):
    make, where, idx, eps, floor, kind = FD_CASES[name]
    scene = make(dev)
    leaf = _get(scene, where).detach().requires_grad_(True)
    img = diff.render_image_diff(with_tensor(scene, where, leaf), RES, RES)
    g, = torch.autograd.grad(_fd_loss(img, kind), leaf)
    assert bool(torch.isfinite(g).all())
    if idx is None:
        ch0 = g[0, :, :, 0].abs()
        idx = (0, *np.unravel_index(int(ch0.argmax()), tuple(ch0.shape)), 0)
    vals = []
    with torch.no_grad():
        for e in (eps, -eps):
            t = _get(scene, where).clone()
            t[idx] += e
            img = diff.render_image_diff(with_tensor(scene, where, t), RES,
                                         RES)
            vals.append(_fd_loss(img.double(), kind).item())
    fd = (vals[0] - vals[1]) / (2 * eps)
    assert abs(g[idx].item() - fd) < 0.05 * max(abs(fd), floor), \
        (g[idx].item(), fd)


def test_inverse_render_steps_lower_the_loss(dev):
    scene = cornell_box(device=dev)
    fac = scene.materials.fac.clone()
    fac[0, 0, :3] *= 0.5
    with torch.no_grad():
        target = diff.render_image_diff(
            with_tensor(scene, ('materials', 'fac'), fac), RES, RES)
    _, g = diff.material_grad(scene, target)
    losses, sc = [], scene
    for _ in range(4):
        nxt, loss = diff.inverse_render_step(sc, target, lr=1.0)
        if not losses:
            assert torch.equal(nxt.materials.fac,
                               scene.materials.fac - 1.0 * g)
        losses.append(loss.item())
        sc = nxt
    assert losses[-1] < losses[0], losses
