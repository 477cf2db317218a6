'''
Albedo and normal AOV engine, for fast previews and denoiser auxiliaries.

Reference: ptina_tpu/engine/preview.py (reference PreviewEngine,
ptina/engine/preview.py:22-41).  One primary ray per pixel, cast through
the scene's route (intersect/dispatch.cast_shaded: one dense shade_kernel
or blocked_shade_kernel launch a sample on the card, the plain cast on
the CPU, brute for accel='dense' above MAX_DENSE_FACES); the hit's
basecolor goes into film pass PASS_ALBEDO and its shading normal into
PASS_NORMAL, 0 on a miss.  No shadow cast, no bounce.
'''

import torch

from ptina_tpu_torch.utils.vec import vwhere
from ptina_tpu_torch.camera import camera_rays
from ptina_tpu_torch.engine.path import pixel_grid
from ptina_tpu_torch.intersect.dispatch import cast_shaded
from ptina_tpu_torch.mtllib import fetch_material
from ptina_tpu_torch.sampling.sobol import pixel_rotation, sample_dims
from ptina_tpu_torch.film import film_add, PASS_ALBEDO, PASS_NORMAL

__all__ = ['render_preview_sample', 'render_preview']


def render_preview_sample(scene, film, sample_index, x0=0, y0=0,
                          full_res=None, rot=None):
    '''One AOV sample of the (nx, ny) film tile at offset (x0, y0) of a
    full_res = (fnx, fny) film (default: the tile is the film), in place;
    returns the film.  rot: optional precomputed pixel_rotation of the
    tile's pixels over 2 dimensions (render_preview passes it).'''
    _, _, nx, ny = film.shape
    fnx, fny = full_res if full_res is not None else (nx, ny)
    ii, jj = pixel_grid(nx, ny, x0, y0, device=film.device)
    u = sample_dims(sample_index, ii, jj, 2, rot=rot)
    x = (ii.to(torch.float32) + u[0]) / fnx * 2.0 - 1.0
    y = (jj.to(torch.float32) + u[1]) / fny * 2.0 - 1.0
    ro, rd = camera_rays(scene.cam_v2w, x, y)

    avoid = torch.full(ro.x.shape, -1, dtype=torch.int32, device=film.device)
    hit, normal, tex_s, tex_t, mtlid = cast_shaded(scene, ro, rd, avoid)
    material = fetch_material(scene, mtlid, tex_s, tex_t)

    albedo = vwhere(hit.hit, material['basecolor'], 0.0)
    normal = vwhere(hit.hit, normal, 0.0)
    one = torch.ones_like(albedo.x)
    film_add(film, PASS_ALBEDO, albedo.x, albedo.y, albedo.z, one)
    return film_add(film, PASS_NORMAL, normal.x, normal.y, normal.z, one)


def render_preview(scene, film, start_sample, spp=1):
    '''`spp` AOV samples from `start_sample` into the film, in place;
    returns it.  The pixel rotation is sample-invariant and made once.'''
    _, _, nx, ny = film.shape
    ii, jj = pixel_grid(nx, ny, device=film.device)
    rot = pixel_rotation(ii, jj, 2)
    for s in range(spp):
        film = render_preview_sample(scene, film, int(start_sample) + s,
                                     rot=rot)
    return film
