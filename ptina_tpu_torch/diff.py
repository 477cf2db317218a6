'''
Differentiable rendering: pixel gradients with respect to material
factors, textures and any other floating scene tensor, by autograd
through the shading path (the casts are detached: engine/path.py).

Reference: ptina_tpu/diff.py.  Plain functions over torch.autograd.grad;
the scene passed in is never changed (a differentiated tensor is swapped
in with scene.with_tensor).  A render takes the reference's routes: on a
fused_eligible scene (a dense-route scene on the card) the pair of
engine/fused.fused_trace_diff, the megakernel's explicit-uniform head
forward and a path_trace recompute backward; on any other scene, and on
the CPU, autograd runs through the wavefront (render_sample(fused=False)).

Typical use: inverse-rendering a material (inverse_render_step) or a
texture map (inverse_texture_step) to match a target image.
'''

import torch

from ptina_tpu_torch.camera import camera_rays
from ptina_tpu_torch.engine.path import render_sample, pixel_grid, PATH_DIMS
from ptina_tpu_torch.film import new_film, film_to_image, film_add
from ptina_tpu_torch.sampling.sobol import sample_dims
from ptina_tpu_torch.scene import with_tensor
from ptina_tpu_torch.utils import trace

__all__ = ['render_image_diff', 'image_loss', 'material_grad',
           'texture_grad', 'inverse_render_step', 'inverse_texture_step']


def _sample_diff_fused(scene, film, sample_index, trace_diff):
    '''One differentiable sample through trace_diff(scene, ro, rd, u):
    the camera rays and the [PATH_DIMS, N] uniforms render_sample's
    wavefront makes for this sample, then one add into pass 0.'''
    _, _, nx, ny = film.shape
    ii, jj = pixel_grid(nx, ny, device=film.device)
    u = sample_dims(sample_index, ii, jj, PATH_DIMS)
    x = (ii.to(torch.float32) + u[0]) / nx * 2.0 - 1.0
    y = (jj.to(torch.float32) + u[1]) / ny * 2.0 - 1.0
    ro, rd = camera_rays(scene.cam_v2w, x, y)
    rad = trace_diff(scene, ro, rd, u)
    return film_add(film, 0, rad.x, rad.y, rad.z, torch.ones_like(rad.x))


def render_image_diff(scene, nx, ny, sample_index=0, spp=1,
                      _trace_diff=None):
    '''Differentiable render: the [nx, ny, 3] mean-radiance image of `spp`
    samples from sample_index, on the scene's device, carrying autograd's
    graph to every scene tensor that requires grad.
    _trace_diff: None = the pair (fused_trace_diff) on a fused_eligible
    scene, else the wavefront; False = the wavefront; a callable = the
    per-sample differentiable trace (trace_diff(scene, ro, rd, u) -> V3).'''
    from ptina_tpu_torch.engine.fused import fused_eligible, fused_trace_diff
    with trace.span('grad.forward'):
        film = new_film(nx, ny, device=scene.device)
        trace_diff = _trace_diff
        if trace_diff is None and fused_eligible(scene):
            trace_diff = fused_trace_diff
        for s in range(spp):
            if trace_diff is None or trace_diff is False:
                film = render_sample(scene, film, sample_index + s,
                                     fused=False)
            else:
                film = _sample_diff_fused(scene, film, sample_index + s,
                                          trace_diff)
        return film_to_image(film)[..., :3]


def _mse(img, target):
    target = torch.as_tensor(target, dtype=img.dtype, device=img.device)
    return torch.mean((img - target) ** 2)


def image_loss(scene, target, sample_index=0, spp=1):
    '''MSE of render_image_diff against a target image [nx, ny, 3] (a
    tensor or an array; moved to the scene's device).'''
    return _mse(render_image_diff(scene, target.shape[0], target.shape[1],
                                  sample_index, spp), target)


def _loss_and_grad(scene, target, path, sample_index=0, spp=1,
                   trace_diff=None):
    '''(image_loss, d image_loss / d the scene tensor at path), that tensor
    swapped for a detached leaf; trace_diff is render_image_diff's
    _trace_diff (the route).'''
    with torch.enable_grad():
        leaf = getattr(getattr(scene, path[0]), path[1]).detach() \
            .requires_grad_(True)
        loss = _mse(render_image_diff(with_tensor(scene, path, leaf),
                                      target.shape[0], target.shape[1],
                                      sample_index, spp, trace_diff), target)
        with trace.span('grad.backward'):
            g, = torch.autograd.grad(loss, leaf)
    return loss.detach(), g


def material_grad(scene, target, sample_index=0, spp=1):
    '''(loss, d loss / d materials.fac [M+1, 12, 4]).'''
    return _loss_and_grad(scene, target, ('materials', 'fac'), sample_index,
                          spp)


def texture_grad(scene, target, sample_index=0, spp=1):
    '''(loss, d loss / d textures.data [T, H, W, 4]).'''
    return _loss_and_grad(scene, target, ('textures', 'data'), sample_index,
                          spp)


def inverse_render_step(scene, target, sample_index=0, spp=1, lr=0.1):
    '''One SGD step on the material factors toward the target image.
    Returns (scene', loss): scene' holds fac - lr * g.'''
    with trace.span('grad.step'):
        loss, g = material_grad(scene, target, sample_index, spp)
        return with_tensor(scene, ('materials', 'fac'),
                           scene.materials.fac - lr * g), loss


def inverse_texture_step(scene, target, sample_index=0, spp=1, lr=0.1):
    '''One SGD step on the texture atlas toward the target image.
    Returns (scene', loss): scene' holds textures.data - lr * g.'''
    with trace.span('grad.step'):
        loss, g = texture_grad(scene, target, sample_index, spp)
        return with_tensor(scene, ('textures', 'data'),
                           scene.textures.data - lr * g), loss
