'''
The plain reference's path integrator: a frozen copy of the wavefront in
ptina_tpu_torch/engine/path.py (path_trace and its bounce), with the
plain casts of intersect/casts.py, and the camera rays and rotated Sobol
uniforms of render_sample's wavefront branch, for any set of pixels.

The control: with `round_to` set (a lower-precision dtype), every float
that a bounce hands to the next (the ray, the throughput, the radiance,
the BSDF pdf) and each sample's radiance are rounded through that dtype,
as a path state stored at that precision would be.
'''

import torch

from perfbench.plainref.mathutils import EPS, INF, clamp
from perfbench.plainref.vec import (V3, vdot, vdot_or_zero, vnormalize,
                                    vwhere, vavg3)
from perfbench.plainref.camera import camera_rays
from perfbench.plainref.intersect.casts import cast_shadow, cast_shaded
from perfbench.plainref.lights import lights_hit, lights_sample, world_at
from perfbench.plainref.mtllib import fetch_material
from perfbench.plainref.materials.simple import bsdf_eval, bsdf_sample
from perfbench.plainref.sampling.sobol import sample_dims

MAX_DEPTH = 5
PATH_DIMS = 2 + 6 * MAX_DEPTH  # = 32


def _rounded(x, dtype):
    if dtype is None:
        return x
    if isinstance(x, V3):
        return V3(*(_rounded(c, dtype) for c in (x.x, x.y, x.z)))
    if x.dtype != torch.float32:
        return x
    return x.to(dtype).to(torch.float32)


def power_heuristic(a, b):
    '''Squared power heuristic.'''
    a = clamp(a, EPS, INF) ** 2
    b = clamp(b, EPS, INF) ** 2
    return a / (a + b)


def _cast_and_shade(scene, ro, rd, avoid):
    '''Closest cast with fused attributes -> hit point, two-sided normal,
    material.  The hit, normal and texcoord are detached (module
    docstring).'''
    with torch.no_grad():
        hit, normal, tex_s, tex_t, mtlid = cast_shaded(scene, ro, rd, avoid)
    hitpos = ro + rd * hit.t
    sign = -vdot(rd, normal)
    normal = vwhere(sign < 0, -normal, normal)
    material = fetch_material(scene, mtlid, tex_s, tex_t)
    return hit, hitpos, normal, sign, material


def _any3(v):
    return (v.x > 0.0) | (v.y > 0.0) | (v.z > 0.0)


def _bounce(scene, carry, u, model='disney', lanes=None):
    '''One wavefront bounce.  carry: (ro, rd, throughput, result,
    last_brdf_pdf, avoid, alive); u: this bounce's [6, N] uniforms;
    lanes: path_trace's.'''
    ro, rd, throughput, result, last_brdf_pdf, avoid, alive = carry
    rd = vnormalize(rd)
    hit, hitpos, normal, sign, material = _cast_and_shade(scene, ro, rd,
                                                          avoid)

    # direct light hit with MIS
    lit = lights_hit(scene.lights, ro, rd)
    lit_vis = lit['hit'] & (~hit.hit | (lit['dis'] < hit.t))
    mis = power_heuristic(last_brdf_pdf, lit['pdf'])
    result = result + vwhere(alive & lit_vis,
                             throughput * lit['color'] * mis, 0.0)

    # environment on a miss, then the lane dies
    miss = ~hit.hit
    result = result + vwhere(alive & miss, throughput * world_at(scene, rd),
                             0.0)
    live = alive & ~miss

    # next-event estimation.  Lanes without a surface hit get a PARKED
    # shadow ray (origin 0, +z, tmax 0): their NEE is masked out anyway,
    # and the parked ray never occludes.
    li = lights_sample(scene.lights, hitpos, u[0], u[1], u[2])
    ro_sh = vwhere(hit.hit, hitpos, 0.0)
    rd_sh = vwhere(hit.hit, li['dir'], V3.full_like(hitpos, (0, 0, 1)))
    tmax_sh = torch.where(hit.hit, li['dis'], 0.0)
    with torch.no_grad():
        occ = cast_shadow(scene, ro_sh, rd_sh, hit.index, tmax_sh)
    brdf_clr = bsdf_eval(model, material, normal, sign, -rd, li['dir'],
                         zero=scene.materials.zero)
    brdf_pdf = vavg3(brdf_clr)
    mis2 = power_heuristic(li['pdf'], brdf_pdf)
    nee = li['color'] * brdf_clr * (mis2 * vdot_or_zero(normal, li['dir']))
    nee_ok = live & ~occ & _any3(li['color'])
    if lanes is not None:
        lanes.append(dict(alive=alive, ro=ro, rd=rd, avoid=avoid, hit=hit,
                          shadow=live & _any3(li['color']), ro_sh=ro_sh,
                          rd_sh=rd_sh, tmax=tmax_sh, occ=occ))
    result = result + vwhere(nee_ok, throughput * nee, 0.0)

    # BSDF bounce.  Dead lanes are PARKED on the degenerate ray at the
    # origin pointing +z (their radiance is final).
    outdir, pdf, color = bsdf_sample(model, material, normal, sign, -rd,
                                     u[3], u[4], u[5],
                                     zero=scene.materials.zero)
    throughput = vwhere(live, throughput * color, throughput)
    park = V3.full_like(hitpos, (0.0, 0.0, 1.0))
    ro = vwhere(live, hitpos, 0.0)
    rd = vwhere(live, outdir, park)
    avoid = torch.where(live, hit.index, avoid)
    last_brdf_pdf = torch.where(live, pdf, last_brdf_pdf)
    alive = live & _any3(throughput) \
        & ((rd.x != 0.0) | (rd.y != 0.0) | (rd.z != 0.0))
    return (ro, rd, throughput, result, last_brdf_pdf, avoid, alive)


def path_trace(scene, ro, rd, uniforms, model='disney', lanes=None,
               round_to=None):
    '''Trace [N] rays to completion.  uniforms: [2 + 6 * depth, N]; the
    bounce count is carried by its row count.  Returns radiance V3.
    lanes: an optional list; each bounce appends a dict of its casts:
    'alive' [N] bool, the paths that make its closest cast, with that
    cast's rays 'ro', 'rd' (normalised), 'avoid' and its Hit 'hit';
    'shadow' [N] bool, the paths that cast a shadow ray, with its rays
    'ro_sh', 'rd_sh', 'tmax' and the occlusion bits 'occ' (every lane's:
    the rest are parked).  The masks are the casts the megakernel makes
    for the same paths.

    last_brdf_pdf starts at INF, not 0 as in ptina: before the first
    bounce there is no competing light-sampling strategy, so a directly
    visible emitter is collected at full weight.'''
    depth = (uniforms.shape[0] - 2) // 6
    zero = torch.zeros_like(ro.x)
    one = torch.ones_like(ro.x)
    carry = (ro, rd, V3(one, one, one), V3(zero, zero, zero),
             torch.full_like(ro.x, INF),
             torch.full(ro.x.shape, -1, dtype=torch.int32,
                        device=ro.x.device),
             torch.ones_like(ro.x, dtype=torch.bool))
    for b in range(depth):
        carry = _bounce(scene, carry, uniforms[2 + 6 * b:8 + 6 * b], model,
                        lanes)
        carry = tuple(_rounded(c, round_to) for c in carry)
    return _rounded(carry[3], round_to)


def pixel_grid(nx, ny, x0=0, y0=0, device='cuda'):
    '''Flattened global pixel ids [N] of an (nx, ny) film tile at offset
    (x0, y0), 'ij' order (x major).'''
    ii, jj = torch.meshgrid(
        x0 + torch.arange(nx, dtype=torch.int32, device=device),
        y0 + torch.arange(ny, dtype=torch.int32, device=device),
        indexing='ij')
    return ii.reshape(-1), jj.reshape(-1)


def sample_radiance(scene, ii, jj, fnx, fny, sample_index, round_to=None,
                    lanes=None):
    '''render_sample's wavefront branch for the pixels (ii, jj) ([N]
    int32 each) of an (fnx, fny) film: one sample's radiance, V3 of [N].'''
    u = sample_dims(sample_index, ii, jj, PATH_DIMS)
    x = (ii.to(torch.float32) + u[0]) / fnx * 2.0 - 1.0
    y = (jj.to(torch.float32) + u[1]) / fny * 2.0 - 1.0
    ro, rd = camera_rays(scene.cam_v2w, x, y)
    return path_trace(scene, ro, rd, u, lanes=lanes, round_to=round_to)
