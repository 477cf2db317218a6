'''
Unidirectional path integrator with multiple importance sampling: its
wavefront form, and the per-sample route between it and the megakernel.

Reference: ptina_tpu/engine/path.py (reference ptina/engine/path.py:17-93).
The whole [N]-ray batch advances bounce by bounce with alive masks.  Per
bounce: closest cast with shading attributes -> direct light hit (MIS
against the previous BSDF pdf) -> environment on a miss -> next-event
estimation (light sample + shadow cast + BSDF eval + MIS) -> BSDF bounce.
Every bounce runs on every lane (a Python loop over a fixed depth, like
the reference's scan), so each bounce launches exactly one closest cast
and one shadow cast.

Random-number contract: each path consumes a fixed [2 + 6 * depth, N]
uniform block: 2 lens dims, then per bounce 3 for the light sample and 3
for the BSDF sample.  No RNG is drawn: the uniforms are rotated Sobol.

render_sample routes as the reference does (ptina_tpu/engine/path.py:
211-230): the path megakernel (engine/fused.py, one launch per sample)
evaluates the Disney BSDF only, so every other model renders the
wavefront whatever `fused` says.  For the Disney model fused=None takes
the megakernel on a fused_eligible scene (a dense-route scene on a CUDA
device) and the wavefront otherwise; fused=True takes the megakernel (on
the CPU its plain twin, which equals the wavefront bit for bit);
fused=False the wavefront.  The wavefront's casts route by the scene
(intersect/dispatch.py: the dense casts walk the scene's box tree, the
blocked two-level casts take big or accel='blocked' scenes).  max_depth
is at most 16 on both routes (sampling/sobol.MAX_DIMS).

Gradients: the wavefront is plain torch, so autograd differentiates a
render in every scene tensor that requires grad (diff.py).  The casts are
detached, as the reference's stop_gradient detaches them: gradients flow
through shading at fixed hit points (hitpos = ro + rd * t stays
differentiable in ro and rd), never through the discrete intersection, so
the CPU's plain casts and the card's kernels give one estimator.
'''

import torch

from ptina_tpu_torch.utils.mathutils import EPS, INF, clamp
from ptina_tpu_torch.utils.vec import (V3, vdot, vdot_or_zero, vnormalize,
                                       vwhere, vavg3)
from ptina_tpu_torch.camera import camera_rays
from ptina_tpu_torch.intersect.dispatch import cast_shadow, cast_shaded
from ptina_tpu_torch.lights import (lights_hit, lights_sample, world_at,
                                    world_counts)
from ptina_tpu_torch.mtllib import fetch_material, material_rows
from ptina_tpu_torch.materials.disney import disney_derive
from ptina_tpu_torch.materials.simple import bsdf_eval, bsdf_sample
from ptina_tpu_torch.sampling.sobol import (sample_dims, pixel_rotation,
                                           sobol_block)
from ptina_tpu_torch.film import film_add
from ptina_tpu_torch.utils import trace

__all__ = ['MAX_DEPTH', 'PATH_DIMS', 'SPB', 'power_heuristic', 'path_trace',
           'pixel_grid', 'render_sample', 'render']

MAX_DEPTH = 5
PATH_DIMS = 2 + 6 * MAX_DEPTH  # = 32


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


def _shade_hit(scene, s):
    '''A bounce's shading from its closest hit to its shadow ray (segment
    A): the derived material, the hit point and two-sided normal, the
    direct light hit with MIS, the environment on a miss and the light
    sample with its shadow ray.  s: the carry's ro, rd (normalised),
    throughput, result, last_brdf_pdf and alive; the closest cast's hit
    and t, its normal; material_rows' params; world, the environment's
    radiance along rd (world_at, fetched before the segment); u, the
    light sample's 3 uniform rows.  Of the scene it reads the tensors
    under _shade_hit.reads alone.  Returns what cast_shadow and
    _shade_bsdf read, rd, throughput and last_brdf_pdf passed on
    unchanged.'''
    rd, hit, u = s['rd'], s['hit'], s['u']
    material = disney_derive(s['params'])
    hitpos = s['ro'] + rd * s['t']
    sign = -vdot(rd, s['normal'])
    normal = vwhere(sign < 0, -s['normal'], s['normal'])

    # direct light hit with MIS
    lit = lights_hit(scene.lights, s['ro'], rd)
    lit_vis = lit['hit'] & (~hit | (lit['dis'] < s['t']))
    mis = power_heuristic(s['last_brdf_pdf'], lit['pdf'])
    result = s['result'] + vwhere(s['alive'] & lit_vis,
                                  s['throughput'] * lit['color'] * mis, 0.0)

    # environment on a miss, then the lane dies
    miss = ~hit
    result = result + vwhere(s['alive'] & miss,
                             s['throughput'] * s['world'], 0.0)
    live = s['alive'] & ~miss

    # next-event estimation.  Lanes without a surface hit get a PARKED
    # shadow ray (origin 0, +z, tmax 0): their NEE is masked out anyway,
    # and the parked ray never occludes.
    li = lights_sample(scene.lights, hitpos, u[0], u[1], u[2])
    ro_sh = vwhere(hit, hitpos, 0.0)
    rd_sh = vwhere(hit, li['dir'], V3.full_like(hitpos, (0, 0, 1)))
    tmax_sh = torch.where(hit, li['dis'], 0.0)
    return dict(material=material, hitpos=hitpos, normal=normal, sign=sign,
                result=result, live=live, li=li, ro_sh=ro_sh, rd_sh=rd_sh,
                tmax_sh=tmax_sh, rd=rd, throughput=s['throughput'],
                last_brdf_pdf=s['last_brdf_pdf'])


_shade_hit.reads = ('lights',)


def _shade_bsdf(scene, s, model, last):
    '''A bounce's shading after its shadow cast (segment B): the BSDF's
    evaluation for next-event estimation, its sample and the carry's
    update.  s: _shade_hit's material, hitpos, normal, sign, result, live,
    li, rd, throughput and last_brdf_pdf; the shadow cast's occ; the
    closest hit's index; the carry's avoid; u, the BSDF sample's 3
    uniform rows.  Reads no scene tensor.  Returns the next carry as a
    dict, its rd normalised for the next bounce's cast unless `last`.'''
    material, normal, sign, rd = s['material'], s['normal'], s['sign'], \
        s['rd']
    li, live, throughput, u = s['li'], s['live'], s['throughput'], s['u']
    zero = scene.materials.zero
    brdf_clr = bsdf_eval(model, material, normal, sign, -rd, li['dir'],
                         zero=zero)
    brdf_pdf = vavg3(brdf_clr)
    mis2 = power_heuristic(li['pdf'], brdf_pdf)
    nee = li['color'] * brdf_clr * (mis2 * vdot_or_zero(normal, li['dir']))
    nee_ok = live & ~s['occ'] & _any3(li['color'])
    result = s['result'] + vwhere(nee_ok, throughput * nee, 0.0)

    # BSDF bounce.  Dead lanes are PARKED on the degenerate ray at the
    # origin pointing +z (their radiance is final).
    outdir, pdf, color = bsdf_sample(model, material, normal, sign, -rd,
                                     u[0], u[1], u[2], zero=zero)
    throughput = vwhere(live, throughput * color, throughput)
    park = V3.full_like(s['hitpos'], (0.0, 0.0, 1.0))
    ro = vwhere(live, s['hitpos'], 0.0)
    rd = vwhere(live, outdir, park)
    avoid = torch.where(live, s['index'], s['avoid'])
    last_brdf_pdf = torch.where(live, pdf, s['last_brdf_pdf'])
    alive = live & _any3(throughput) \
        & ((rd.x != 0.0) | (rd.y != 0.0) | (rd.z != 0.0))
    if not last:
        rd = vnormalize(rd)
    return dict(ro=ro, rd=rd, throughput=throughput, result=result,
                last_brdf_pdf=last_brdf_pdf, avoid=avoid, alive=alive)


_shade_bsdf.reads = ()


def _eager(fn, scene, s, *static):
    '''The wavefront's runner of a shading segment: the call itself.'''
    return fn(scene, s, *static)


def _world_fetch(scene, rd, alive, hit):
    '''The environment's radiance along every lane's rd (world_at), in a
    `world.fetch` span; while tracing is on, after the span, its `world`
    counter (lights.world_counts) over the lanes it enters the result
    for, those alive that miss.'''
    with trace.span('world.fetch'):
        world = world_at(scene, rd)
    if trace.tracing():
        trace.add_counts('world', world_counts(scene, rd, alive & ~hit))
    return world


def _bounce(scene, carry, u, model='disney', lanes=None, last=True,
            shade=_eager):
    '''One wavefront bounce: the closest cast, the material rows, the
    world fetch (_world_fetch), segment A (_shade_hit), the shadow cast,
    segment B (_shade_bsdf).  carry: (ro, rd (normalised), throughput,
    result, last_brdf_pdf, avoid, alive); u: this bounce's [6, N]
    uniforms; lanes: path_trace's.  Returns the next carry, its rd
    normalised unless `last`.  shade(fn, scene, s, *static) runs each
    segment: the call itself here, a CUDA graph's replay in the pair's
    recompute (engine/fused.py), the same ops on the same inputs.  The
    casts, the rows and the world fetch, which hold the hand-written
    kernels and their backwards (a textured world's fetch is four texel
    gathers), run eagerly on every route.'''
    ro, rd, throughput, result, last_brdf_pdf, avoid, alive = carry
    with torch.no_grad():
        hit, normal, tex_s, tex_t, mtlid = cast_shaded(scene, ro, rd, avoid)
    params = material_rows(scene, mtlid, tex_s, tex_t)
    world = _world_fetch(scene, rd, alive, hit.hit)
    s = shade(_shade_hit, scene, dict(
        ro=ro, rd=rd, throughput=throughput, result=result,
        last_brdf_pdf=last_brdf_pdf, alive=alive, hit=hit.hit, t=hit.t,
        normal=normal, params=params, world=world, u=u[0:3]))
    with torch.no_grad():
        occ = cast_shadow(scene, s['ro_sh'], s['rd_sh'], hit.index,
                          s['tmax_sh'])
    if lanes is not None:
        lanes.append(dict(alive=alive, ro=ro, rd=rd, avoid=avoid, hit=hit,
                          shadow=s['live'] & _any3(s['li']['color']),
                          ro_sh=s['ro_sh'], rd_sh=s['rd_sh'],
                          tmax=s['tmax_sh'], occ=occ))
    c = shade(_shade_bsdf, scene, dict(
        material=s['material'], hitpos=s['hitpos'], normal=s['normal'],
        sign=s['sign'], result=s['result'], live=s['live'], li=s['li'],
        rd=s['rd'], throughput=s['throughput'],
        last_brdf_pdf=s['last_brdf_pdf'], occ=occ, index=hit.index,
        avoid=avoid, u=u[3:6]), model, last)
    return (c['ro'], c['rd'], c['throughput'], c['result'],
            c['last_brdf_pdf'], c['avoid'], c['alive'])


def path_trace(scene, ro, rd, uniforms, model='disney', lanes=None):
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
    return _path_trace(scene, ro, rd, uniforms, model, lanes)


def _path_trace(scene, ro, rd, uniforms, model='disney', lanes=None,
                shade=_eager):
    '''path_trace with each bounce's shading segments run by `shade`
    (_bounce).'''
    depth = (uniforms.shape[0] - 2) // 6
    zero = torch.zeros_like(ro.x)
    one = torch.ones_like(ro.x)
    carry = (ro, vnormalize(rd), V3(one, one, one), V3(zero, zero, zero),
             torch.full_like(ro.x, INF),
             torch.full(ro.x.shape, -1, dtype=torch.int32,
                        device=ro.x.device),
             torch.ones_like(ro.x, dtype=torch.bool))
    for b in range(depth):
        with trace.span('wavefront.bounce'):
            carry = _bounce(scene, carry, uniforms[2 + 6 * b:8 + 6 * b],
                            model, lanes, b == depth - 1, shade)
    return carry[3]


def pixel_grid(nx, ny, x0=0, y0=0, device='cuda'):
    '''Flattened global pixel ids [N] of an (nx, ny) film tile at offset
    (x0, y0), 'ij' order (x major).'''
    ii, jj = torch.meshgrid(
        x0 + torch.arange(nx, dtype=torch.int32, device=device),
        y0 + torch.arange(ny, dtype=torch.int32, device=device),
        indexing='ij')
    return ii.reshape(-1), jj.reshape(-1)


def _takes_fused(scene, fused, model):
    '''The route of render_sample: True for the megakernel, which only
    the Disney model takes (the reference's rule, path.py:211-230).'''
    from ptina_tpu_torch.engine.fused import fused_eligible
    if model != 'disney':
        return False
    return fused_eligible(scene) if fused is None else bool(fused)


def render_sample(scene, film, sample_index, x0=0, y0=0, full_res=None,
                  fused=None, model='disney', max_depth=MAX_DEPTH, rot=None):
    '''Accumulate one progressive sample over the film into pass 0, in
    place; returns the film.

    The film may be a tile or band of a larger frame: x0 / y0 are its
    global pixel offsets and full_res the whole frame's (nx, ny) (default:
    the film is the frame).  The NDC mapping, the Sobol rotation and the
    uniforms depend on global pixel ids only, so a tile renders the same
    bits as the same rows of the whole frame (parallel/sharding.py renders
    film bands this way).
    fused: for the Disney model, None = the megakernel where the scene is
    eligible, else the wavefront; True = the megakernel; False = the
    wavefront.  Any other model renders the wavefront (module
    docstring).  rot: optional precomputed pixel_rotation of this tile's
    global pixel ids for the wavefront — pass it from per-sample loops.'''
    _, _, nx, ny = film.shape
    fnx, fny = full_res if full_res is not None else (nx, ny)
    dims = 2 + 6 * max_depth
    mega = _takes_fused(scene, fused, model)
    with trace.span('render.sample',
                    route='megakernel' if mega else 'wavefront'):
        if mega:
            from ptina_tpu_torch.engine.fused import fused_trace_primary
            rad = fused_trace_primary(scene, sobol_block(sample_index, dims),
                                      nx, ny, x0, y0, fnx, fny)
        else:
            ii, jj = pixel_grid(nx, ny, x0, y0, device=film.device)
            u = sample_dims(sample_index, ii, jj, dims, rot=rot)
            x = (ii.to(torch.float32) + u[0]) / fnx * 2.0 - 1.0
            y = (jj.to(torch.float32) + u[1]) / fny * 2.0 - 1.0
            ro, rd = camera_rays(scene.cam_v2w, x, y)
            rad = path_trace(scene, ro, rd, u, model)
        return film_add(film, 0, rad.x, rad.y, rad.z,
                        torch.ones_like(rad.x))


def _render_step(scene, film, start_sample, n, model='disney',
                 max_depth=MAX_DEPTH, x0=0, y0=0, full_res=None, fused=None):
    '''`n` progressive samples from start_sample through render_sample (its
    route by `fused`) into the film tile at (x0, y0) of full_res, with the
    sample-invariant work hoisted: on the wavefront the per-pixel rotation
    is made once for the n samples (the megakernel makes it in-kernel).
    The film is the same bits for every grouping of the samples.'''
    _, _, nx, ny = film.shape
    rot = None
    if n > 1 and not _takes_fused(scene, fused, model):
        ii, jj = pixel_grid(nx, ny, x0, y0, device=film.device)
        rot = pixel_rotation(ii, jj, 2 + 6 * max_depth)
    for s in range(n):
        film = render_sample(scene, film, int(start_sample) + s, x0, y0,
                             full_res, fused, model, max_depth, rot)
    return film


SPB = 8  # samples per group, the reference's samples per dispatch


def render(scene, film, start_sample, spp=1, model='disney', spb=None,
           max_depth=MAX_DEPTH):
    '''Render `spp` progressive samples from `start_sample` into the film
    (in place; returns it), each through render_sample's automatic route,
    in groups of `spb` samples (None = SPB) by the reference's rule
    (ptina_tpu/engine/path.py:268-283): a group of spb while at least spb
    samples remain, then single samples.  A group makes its
    sample-invariant work once (_render_step: the wavefront's per-pixel
    rotation); a single sample makes it itself, as the reference's spb=1
    step does.  The film is the same bits for every spb.

    The reference scans a group in one device dispatch; here every sample
    still launches on its own and its Sobol point rides in the launch
    parameters.  Moving the point into a device buffer and capturing a
    group as one CUDA graph is the megakernel's host-path redesign
    (ROADMAP queue 2 (c)), not done here.'''
    spb = SPB if spb is None else int(spb)
    if spb < 1:
        raise ValueError(f'spb must be at least 1, got {spb}')
    s = 0
    while s < spp:
        step = spb if spp - s >= spb else 1
        film = _render_step(scene, film, int(start_sample) + s, step,
                            model=model, max_depth=max_depth)
        s += step
    return film
