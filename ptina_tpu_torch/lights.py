'''
Analytic lights (point spheres / area rects) and the environment light.

Reference: ptina_tpu/lights.py (reference ptina/light/__init__.py:51-121,
ptina/light/world.py).  The light pool's capacity L is small and static,
so the per-light tests stay Python loops over slots, each slot's
constants read as 0-d tensors from the [L] tables.  Kinds absent from the
pool (Lights.kinds) drop their geometry, as in the reference.
'''

import math

import torch

from ptina_tpu_torch.utils.mathutils import EPS, INF, clamp_min, safe_sqrt
from ptina_tpu_torch.utils.vec import (V3, vdot, vnormalize, vcross, vwhere,
                                       vspherical, vdir2tex)
from ptina_tpu_torch.scene import LIGHT_POINT, LIGHT_AREA
from ptina_tpu_torch.texture import sample_texture, texel_keys

__all__ = ['lights_hit', 'lights_sample', 'world_at', 'world_counts',
           'ray_sphere', 'ray_rect']


def _slot_v3(table, l):
    return V3(table[l, 0], table[l, 1], table[l, 2])


def ray_sphere(ro, rd, center, radius2):
    '''Nearest positive sphere hit distance, 0.0 on miss.'''
    op = center - ro
    b = vdot(op, rd)
    det = b * b + radius2 - vdot(op, op)
    sq = safe_sqrt(det)
    t_near = b - sq
    t_far = b + sq
    t = torch.where(t_near > EPS, t_near,
                    torch.where(t_far > EPS, t_far, 0.0))
    return torch.where(det >= 0.0, t, 0.0)


def ray_rect(ro, rd, pos, dirx, diry):
    '''One-sided rectangle pos +/- dirx +/- diry, visible where the ray
    faces its front.  Returns (hit mask, t).'''
    nrm = vnormalize(vcross(dirx, diry))
    nod = vdot(nrm, rd)
    facing = nod > EPS
    t = vdot(nrm, pos - ro) / torch.where(facing, nod, 1.0)
    p = ro + rd * t - pos
    u = vdot(p, dirx) / clamp_min(vdot(dirx, dirx), 1e-20)
    v = vdot(p, diry) / clamp_min(vdot(diry, diry), 1e-20)
    hit = facing & (torch.abs(u) < 1.0) & (torch.abs(v) < 1.0)
    return hit, torch.where(hit, t, INF)


def lights_hit(lights, ro, rd):
    '''Direct-hit query against every light; the NEAREST hit wins (the
    reference's deliberate divergence from ptina's first-hit scan).
    Returns dict(hit [N] bool, dis [N], pdf [N], color V3).'''
    n_l = lights.size.shape[0]
    zero = torch.zeros_like(ro.x)
    found = torch.zeros_like(ro.x, dtype=torch.bool)
    dis = torch.full_like(ro.x, INF)
    pdf = zero
    color = V3(zero, zero, zero)

    has_pt = 'point' in lights.kinds
    has_ar = 'area' in lights.kinds
    for l in range(n_l):
        live = l < lights.count
        is_point = lights.type[l] == LIGHT_POINT
        is_area = lights.type[l] == LIGHT_AREA
        size = lights.size[l]
        pos = _slot_v3(lights.pos, l)

        t_sph = ray_sphere(ro, rd, pos, size * size) if has_pt else zero
        if has_ar:
            dirx = _slot_v3(lights.axes[:, :, 0], l) * size
            diry = _slot_v3(lights.axes[:, :, 1], l) * size
            hit_rect, t_rect = ray_rect(ro, rd, pos, dirx, diry)
            t_ar = torch.where(is_area & hit_rect, t_rect, 0.0)
        else:
            t_ar = zero
        if has_pt:
            t = torch.where(is_point, t_sph, t_ar if has_ar else zero)
        else:
            t = t_ar
        area = torch.where(is_point, math.pi * size * size,
                           4.0 * size * size)
        valid = live & (t > 0.0) & (t < dis)

        dis = torch.where(valid, t, dis)
        pdf = torch.where(valid, t * t / clamp_min(area, 1e-12), pdf)
        color = vwhere(valid, _slot_v3(lights.color, l), color)
        found = found | valid

    return dict(hit=found, dis=dis, pdf=pdf, color=color)


def lights_sample(lights, hitpos, su, sv, sz):
    '''Next-event sample: sz picks the light, su/sv the point on it.
    Returns dict(dis, dir V3, pdf, color V3) with color already divided
    by the pdf and cosine-weighted for area lights.'''
    n_l = lights.size.shape[0]
    count = torch.clamp_min(lights.count, 1)
    idx = (sz * count.to(su.dtype)).to(torch.int32)
    idx = torch.minimum(torch.clamp_min(idx, 0), count - 1)

    zero = torch.zeros_like(hitpos.x)
    litpos = V3(zero, zero, zero)
    nrm = V3(zero, zero, zero)
    area = zero
    color = V3(zero, zero, zero)
    is_area_sel = torch.zeros_like(zero, dtype=torch.bool)

    has_pt = 'point' in lights.kinds
    has_ar = 'area' in lights.kinds
    disp_pt = vspherical(su, sv) if has_pt else None
    lx = su * 2.0 - 1.0
    ly = sv * 2.0 - 1.0

    for l in range(n_l):
        sel = idx == l
        size = lights.size[l]
        pos = _slot_v3(lights.pos, l)
        is_area = lights.type[l] == LIGHT_AREA

        lp_pt = pos + disp_pt * size if has_pt else None
        ax_x = _slot_v3(lights.axes[:, :, 0], l)
        ax_y = _slot_v3(lights.axes[:, :, 1], l)
        ax_z = _slot_v3(lights.axes[:, :, 2], l)
        lp_ar = pos + (ax_x * lx + ax_y * ly) * size if has_ar else None

        if has_pt and has_ar:
            lp = vwhere(is_area, lp_ar, lp_pt)
        else:
            z = 0.0 * lx
            lp = lp_ar if has_ar else (lp_pt if has_pt
                                       else pos + V3(z, z, z))
        ar = torch.where(is_area, 4.0 * size * size, math.pi * size * size)
        nr = vwhere(is_area, ax_z, 0.0)

        litpos = vwhere(sel, lp, litpos)
        nrm = vwhere(sel, nr, nrm)
        area = torch.where(sel, ar, area)
        color = vwhere(sel, _slot_v3(lights.color, l), color)
        is_area_sel = torch.where(sel, is_area, is_area_sel)

    toli = litpos - hitpos
    dis = clamp_min(safe_sqrt(vdot(toli, toli)), 1e-12)
    direction = toli * (1.0 / dis)
    pdf = dis * dis / clamp_min(area, 1e-12)
    out_color = color * (1.0 / pdf)
    cosine = clamp_min(vdot(nrm, direction), 0.0)
    out_color = vwhere(is_area_sel, out_color * cosine, out_color)

    empty = lights.count == 0
    return dict(
        dis=torch.where(empty, INF, dis),
        dir=vwhere(empty, 0.0, direction),
        pdf=torch.where(empty, 0.0, pdf),
        color=vwhere(empty, 0.0, out_color),
    )


def _no_atlas(scene):
    return (scene.textures.data.shape[1] == 1
            and scene.textures.data.shape[2] == 1)


def _world_uv(scene, rd):
    '''The environment's texture row [N] and equirect (s, t) of rd.'''
    texid = torch.clamp_min(scene.world_tex, 0)
    s, t = vdir2tex(V3(rd.x, rd.z, -rd.y))
    return texid.expand(rd.x.shape), s, t


def world_at(scene, rd):
    '''Environment radiance for directions rd (reference WorldLight.at,
    with the blender axis swizzle for the equirect lookup).  Returns V3.'''
    fac = scene.world_fac
    if _no_atlas(scene) or not scene.world_textured:
        one = torch.ones_like(rd.x)
        return V3(fac[0] * one, fac[1] * one, fac[2] * one)
    textured = scene.world_tex >= 0
    texid, s, t = _world_uv(scene, rd)
    tex = sample_texture(scene.textures, texid, s, t)
    texv = V3(tex[:, 0], tex[:, 1], tex[:, 2])
    const = V3(fac[0].expand(rd.x.shape), fac[1].expand(rd.x.shape),
               fac[2].expand(rd.x.shape))
    return vwhere(textured, texv * const, const)


def world_counts(scene, rd, enter):
    '''The `world` counter of one world fetch, int64 [4] on rd's device
    with no host sync: lanes fetched, lanes whose radiance enters the
    result (enter [N] bool: alive and missing), the distinct environment
    texels those lanes' four texel gathers read, and the environment's
    texels (its nx * ny; the last two 0 for an untextured world).'''
    n = rd.x.shape[0]
    live = enter.sum()
    zero = torch.zeros_like(live)
    if _no_atlas(scene) or not scene.world_textured:
        return torch.stack([live.new_full((), n), live, zero, zero])
    atlas = scene.textures
    texid, s, t = _world_uv(scene, rd)
    keys = texel_keys(atlas, texid, s, t)  # [4, N]
    slots = atlas.data[..., 0].numel()
    mark = torch.zeros(slots + 1, dtype=torch.int32, device=rd.x.device) \
        .index_fill_(0, torch.where(enter, keys, slots).reshape(-1), 1)
    tid = torch.clamp_min(scene.world_tex, 0).long()
    textured = scene.world_tex >= 0
    reached = torch.where(textured, mark[:slots].sum(), zero)
    texels = torch.where(textured, (atlas.nx[tid] * atlas.ny[tid]).long(),
                         zero)
    return torch.stack([live.new_full((), n), live, reached, texels])
