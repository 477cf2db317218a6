'''
Brute-force path integrator: no next-event estimation and no MIS; light
is collected only where a bounce ray happens to hit an emitter or escapes
to the environment.  Slow to converge but unbiased and simple: the
ground-truth cross-check of the MIS integrator (its role in the
reference too, ptina/engine/brute.py:1-3).

Reference: ptina_tpu/engine/brute.py.  The wavefront form of
engine/path.py: the whole [N]-ray batch advances bounce by bounce with
alive masks, one closest cast with attributes a bounce
(path._cast_and_shade; on the card one shade_kernel, or
blocked_shade_kernel, launch a bounce) and no shadow cast; the Disney
BSDF is sampled (materials/disney.disney_sample).  Dead lanes are parked
on the degenerate ray at the origin pointing +z, as path_trace parks
them: their radiance is final and their casts are masked out, so the
result is the reference's.
'''

import torch

from ptina_tpu_torch.utils.vec import V3, vnormalize, vwhere
from ptina_tpu_torch.camera import camera_rays
from ptina_tpu_torch.engine.path import (_any3, _cast_and_shade, pixel_grid,
                                         MAX_DEPTH)
from ptina_tpu_torch.lights import lights_hit, world_at
from ptina_tpu_torch.materials.disney import disney_sample
from ptina_tpu_torch.sampling.sobol import pixel_rotation, sample_dims
from ptina_tpu_torch.film import film_add

__all__ = ['brute_trace', 'render_brute_sample', 'render_brute']


def brute_trace(scene, ro, rd, uniforms):
    '''Trace [N] rays to completion.  ro, rd: V3 rows; uniforms
    [2 + 6 depth, N] (the row count sets the bounce cap, as in
    path_trace; a bounce reads its rows 3-5).  Returns radiance V3.'''
    depth = (uniforms.shape[0] - 2) // 6
    zero = torch.zeros_like(ro.x)
    one = torch.ones_like(ro.x)
    throughput = V3(one, one, one)
    result = V3(zero, zero, zero)
    avoid = torch.full(ro.x.shape, -1, dtype=torch.int32, device=ro.x.device)
    alive = torch.ones_like(ro.x, dtype=torch.bool)
    for b in range(depth):
        u = uniforms[2 + 6 * b:8 + 6 * b]
        rd = vnormalize(rd)
        hit, hitpos, normal, sign, material = _cast_and_shade(scene, ro, rd,
                                                              avoid)
        lit = lights_hit(scene.lights, ro, rd)
        lit_vis = lit['hit'] & (~hit.hit | (lit['dis'] < hit.t))
        result = result + vwhere(alive & lit_vis, throughput * lit['color'],
                                 0.0)
        miss = ~hit.hit
        result = result + vwhere(alive & miss,
                                 throughput * world_at(scene, rd), 0.0)
        live = alive & ~miss

        outdir, _, color = disney_sample(material, normal, sign, -rd, u[3],
                                         u[4], u[5],
                                         zero=scene.materials.zero)
        throughput = vwhere(live, throughput * color, throughput)
        ro = vwhere(live, hitpos, 0.0)
        rd = vwhere(live, outdir, V3.full_like(hitpos, (0.0, 0.0, 1.0)))
        avoid = torch.where(live, hit.index, avoid)
        alive = live & _any3(throughput) \
            & ((rd.x != 0.0) | (rd.y != 0.0) | (rd.z != 0.0))
    return result


def render_brute_sample(scene, film, sample_index, max_depth=MAX_DEPTH,
                        rot=None):
    '''Accumulate one brute-force sample over the whole film into pass 0,
    in place; returns the film.  rot: optional precomputed pixel_rotation
    over 2 + 6 max_depth dimensions (render_brute passes it).'''
    _, _, nx, ny = film.shape
    ii, jj = pixel_grid(nx, ny, device=film.device)
    u = sample_dims(sample_index, ii, jj, 2 + 6 * max_depth, rot=rot)
    x = (ii.to(torch.float32) + u[0]) / nx * 2.0 - 1.0
    y = (jj.to(torch.float32) + u[1]) / ny * 2.0 - 1.0
    ro, rd = camera_rays(scene.cam_v2w, x, y)
    rad = brute_trace(scene, ro, rd, u)
    return film_add(film, 0, rad.x, rad.y, rad.z, torch.ones_like(rad.x))


def render_brute(scene, film, start_sample, spp=1, max_depth=MAX_DEPTH):
    '''`spp` brute-force samples from `start_sample` into the film, in
    place; returns it.  The pixel rotation is made once a call.'''
    _, _, nx, ny = film.shape
    ii, jj = pixel_grid(nx, ny, device=film.device)
    rot = pixel_rotation(ii, jj, 2 + 6 * max_depth)
    for s in range(spp):
        film = render_brute_sample(scene, film, int(start_sample) + s,
                                   max_depth, rot)
    return film
