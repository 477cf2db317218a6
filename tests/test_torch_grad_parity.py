'''
ptina_tpu_torch.diff against ptina_tpu.diff on the same scenes (carried
from the JAX package with test_torch_scene.jax_scene_arrays) and the same
target images, made from a seed with numpy, at 8x8 and 1 spp:

  * material_grad: loss within 1% (image_loss's value: material_grad's
    loss is image_loss), gradients allclose(rtol=0.05, atol=1e-4 *
    max|g_jax|) on every entry;
  * inverse_render_step: the loss as above, and the stepped factors
    within 0.05 * lr * (|g_jax| + 1e-4 max|g_jax|) of JAX's; the port's
    step is fac - lr * g bit for bit;
  * texture_grad on the textured cornell (a basecolor texture: channels
    0-2 carry gradient, channel 3 none), as material_grad.

On the CPU the port casts with the key-grid contract where JAX casts
with brute (tests/test_torch_render.py); every entry of these cases
agrees at the tolerance above all the same.

The blocked route, which the JAX package's CPU tests do not
differentiate: the port's gradient on a small cornell_highpoly against its
own central difference at 5%.
'''

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptina_tpu import scenes as jscenes
from ptina_tpu import diff as jdiff

from ptina_tpu_torch import diff
from ptina_tpu_torch import scenes as tscenes
from ptina_tpu_torch.engine.fused import fused_eligible
from ptina_tpu_torch.intersect.dispatch import route
from ptina_tpu_torch.scene import scene_from_numpy, with_tensor

from test_torch_scene import jax_scene_arrays

torch.set_num_threads(2)

RES = 8
LR = 0.1


def _target(seed):
    return np.random.RandomState(seed).uniform(0.0, 1.0, (RES, RES, 3)) \
        .astype(np.float32)


def _hold_to_jax(loss, g, jloss, gj):
    assert abs(float(loss) - float(jloss)) <= 0.01 * abs(float(jloss))
    g, gj = np.asarray(g), np.asarray(gj)
    assert g.shape == gj.shape and np.isfinite(g).all()
    atol = 1e-4 * max(np.abs(gj).max(), 1e-6)
    close = np.isclose(g, gj, rtol=0.05, atol=atol)
    assert close.all(), (close.mean(), np.abs(g - gj).max(), atol)


@pytest.fixture(scope='module')
def cornell():
    '''cornell_box in both packages, a target, and JAX's material_grad and
    inverse_render_step toward it.'''
    js = jscenes.cornell_box()
    target = _target(1)
    jt = jnp.asarray(target)
    jloss, jg = jdiff.material_grad(js, jt)
    jstep, jstep_loss = jdiff.inverse_render_step(js, jt, lr=LR)
    return dict(scene=scene_from_numpy(jax_scene_arrays(js), device='cpu'),
                target=target, loss=float(jloss), g=np.asarray(jg),
                fac=np.asarray(jstep.materials.fac),
                step_loss=float(jstep_loss))


def test_material_grad_matches_jax(cornell):
    loss, g = diff.material_grad(cornell['scene'], cornell['target'])
    _hold_to_jax(loss, g.numpy(), cornell['loss'], cornell['g'])


def test_image_loss_matches_jax(cornell):
    '''image_loss is material_grad's loss, in both packages.'''
    loss = diff.image_loss(cornell['scene'], cornell['target'])
    assert loss.requires_grad is False and loss.shape == ()
    assert abs(loss.item() - cornell['loss']) <= 0.01 * cornell['loss']
    assert loss.item() == diff.material_grad(cornell['scene'],
                                             cornell['target'])[0].item()


def test_inverse_render_step_matches_jax(cornell):
    scene = cornell['scene']
    fac0 = scene.materials.fac.clone()
    stepped, loss = diff.inverse_render_step(scene, cornell['target'], lr=LR)
    _, g = diff.material_grad(scene, cornell['target'])
    # the scene passed in is unchanged; the step is fac - lr g exactly
    assert torch.equal(scene.materials.fac, fac0)
    assert torch.equal(stepped.materials.fac, fac0 - LR * g)
    assert abs(loss.item() - cornell['step_loss']) \
        <= 0.01 * cornell['step_loss']
    gj = cornell['g']
    tol = 0.05 * LR * (np.abs(gj) + 1e-4 * np.abs(gj).max()) + 1e-7
    assert (np.abs(stepped.materials.fac.numpy() - cornell['fac'])
            <= tol).all()
    # one step toward the target lowers its loss
    assert diff.image_loss(stepped, cornell['target']).item() < loss.item()


def test_texture_grad_matches_jax_on_a_basecolor_texture():
    tex = np.random.RandomState(2).uniform(0.2, 0.9, (6, 5, 3)) \
        .astype(np.float32)
    js = jscenes.cornell_box(textured_image=tex)
    target = _target(3)
    jloss, jg = jdiff.texture_grad(js, jnp.asarray(target))
    scene = scene_from_numpy(jax_scene_arrays(js), device='cpu')
    loss, g = diff.texture_grad(scene, target)
    _hold_to_jax(loss, g.numpy(), jloss, jg)
    g = g.numpy()
    used = np.abs(g[0, :6, :5, :3])
    assert (used > 0).any() and np.abs(g[..., 3]).sum() == 0


def test_blocked_route_gradient_matches_fd():
    '''cornell_highpoly at a small tessellation on the blocked route: the
    auto route takes the wavefront (the scene is not fused_eligible); the
    white wall's basecolor red against a central difference.'''
    scene = tscenes.cornell_highpoly(nu=48, nv=24, accel='blocked',
                                     device='cpu')
    assert route(scene.face_coef.shape[0], scene.accel) == 'blocked'
    assert not fused_eligible(scene)
    target = _target(4)
    loss, g = diff.material_grad(scene, target)
    assert np.isfinite(g.numpy()).all() and loss.item() > 0
    idx, eps = (0, 0, 0), 1e-2
    vals = []
    for e in (eps, -eps):
        fac = scene.materials.fac.clone()
        fac[idx] += e
        vals.append(diff.image_loss(with_tensor(scene, ('materials', 'fac'),
                                                fac), target).item())
    fd = (vals[0] - vals[1]) / (2 * eps)
    assert abs(g[idx].item() - fd) < 0.05 * max(abs(fd), 1e-4), \
        (g[idx].item(), fd)
