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
    blocked_any;
  * fused_trace_diff raises for a CUDA scene that is not fused_eligible,
    and render_image_diff's automatic route takes the wavefront for it;
  * the texture gradient is finite and only its fetched channel is
    nonzero; the card's gradient agrees with the CPU's on the same scene;
  * the kernels' hits carry no graph when rd requires grad.
'''

import numpy as np
import pytest
import torch

from ptina_tpu_torch import diff
from ptina_tpu_torch.camera import camera_rays
from ptina_tpu_torch.engine import fused, path as tpath
from ptina_tpu_torch.engine.fused import fused_trace_diff
from ptina_tpu_torch.engine.path import pixel_grid, PATH_DIMS
from ptina_tpu_torch.intersect import blocked, dense_cast
from ptina_tpu_torch.sampling.sobol import sample_dims
from ptina_tpu_torch.scene import with_tensor
from ptina_tpu_torch.scenes import cornell_box, cornell_monkey, matball
from ptina_tpu_torch.utils.vec import V3

pytestmark = pytest.mark.cuda

RES = 64
DEPTH = 5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (CUDA kernels have no CPU mode)')
    return torch.device('cuda')


def _launches():
    return {**dense_cast.LAUNCHES, **fused.LAUNCHES, **blocked.LAUNCHES}


def _grew(before):
    return {k: v - before[k] for k, v in _launches().items() if v != before[k]}


def _target(dev, seed=0):
    return torch.tensor(np.random.RandomState(seed).uniform(
        0.0, 1.0, (RES, RES, 3)).astype(np.float32), device=dev)


@pytest.mark.parametrize('make', [cornell_box, cornell_monkey],
                         ids=['cornell_box', 'cornell_monkey'])
def test_pair_gradients_match_the_wavefront(dev, make):
    scene = make(device=dev)
    target = _target(dev)
    before = _launches()
    lf, gf = diff.material_grad(scene, target)
    torch.cuda.synchronize()
    assert _grew(before) == {'path': 1, 'shade': DEPTH, 'any': DEPTH}
    before = _launches()
    lw, gw = diff._loss_and_grad(scene, target, ('materials', 'fac'),
                                 trace_diff=False)
    torch.cuda.synchronize()
    assert _grew(before) == {'shade': DEPTH, 'any': DEPTH}
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
    before = _launches()
    with pytest.raises(ValueError, match='fused_eligible'):
        fused_trace_diff(scene, ro, rd, u)
    assert _grew(before) == {}
    loss, g = diff.material_grad(scene, _target(dev))
    torch.cuda.synchronize()
    assert _grew(before) == {'blocked_shade': DEPTH, 'blocked_any': DEPTH}
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
