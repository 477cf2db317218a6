'''
Ray casts for the integrator (scene level) and for callers holding a bare
face table (table level).

Reference: ptina_tpu/intersect/dispatch.py.  The scene-level casts
(`cast_shaded`, `cast_shadow`) route by the reference's rule (route,
dispatch.py:41-53, its 'pallas' read as 'dense'): accel='blocked', or more
than MAX_DENSE_FACES faces under accel='auto', takes the blocked two-level
cast (intersect/blocked.py); accel='dense' above MAX_DENSE_FACES takes the
reference's brute route (intersect/brute.py, then the winner's attributes
interpolated from the scene's per-corner tables, dispatch.py:127-138);
every other scene the dense casts (intersect/dense_cast.py: cast_shade /
cast_any), whose kernels walk the scene's box tree (fused_coef,
fused_nodes, fused_order; scene.py).  The dense and blocked wrappers pick
the CUDA kernel or the plain torch version by the tensors' device; the
brute route is XLA code in the reference, not a Pallas kernel, and is
plain torch on both devices.

The table-level `cast_closest` / `cast_any` (dispatch.py:66-77) pack the
face table per call, as the reference does, and run the flat dense casts
(dense_cast.cast_closest / cast_any_flat), which test every face: a bare
table has no tree.  Above MAX_DENSE_FACES faces they take brute, as the
reference does.

Rays are SoA V3 rows; results are dense [N] rows.
'''

import torch

from ptina_tpu_torch.utils.vec import V3, vnormalize
from ptina_tpu_torch.intersect import blocked, brute, dense_cast
from ptina_tpu_torch.intersect.blocked import (BLOCK_FACES, MAX_BLOCKS,
                                               MAX_BLOCKED_FACES)
from ptina_tpu_torch.intersect.dense_cast import MAX_DENSE_FACES
from ptina_tpu_torch.intersect.plucker import pack_faces

__all__ = ['cast_closest', 'cast_any', 'cast_shaded', 'cast_shadow',
           'route', 'MAX_DENSE_FACES']


def route(nfaces, accel):
    '''The cast route of a scene of `nfaces` padded faces built with
    accel 'auto', 'dense' or 'blocked': 'dense', 'blocked' or 'brute'.
    The one copy of the rule: make_scene asks it whether to Morton-order,
    and cast_shaded / cast_shadow whom to call.  Raises for a blocked
    route above MAX_BLOCKS blocks.'''
    if accel == 'dense' and nfaces > MAX_DENSE_FACES:
        return 'brute'
    if accel != 'blocked' and nfaces <= MAX_DENSE_FACES:
        return 'dense'
    if nfaces > MAX_BLOCKED_FACES:
        raise ValueError(f'{nfaces} faces exceed the blocked cast\'s '
                         f'{MAX_BLOCKS} blocks of {BLOCK_FACES}')
    return 'blocked'


def _route(scene):
    return route(scene.face_coef.shape[0], scene.accel)


def _tree(scene):
    '''The dense casts' box tree: (fused_coef, fused_nodes, fused_order).'''
    return scene.fused_coef, scene.fused_nodes, scene.fused_order


def _as_v3(a):
    '''V3 rays as they are; an [N, 3] tensor split into rows.'''
    if isinstance(a, V3):
        return a
    return V3(*(a[:, k].contiguous() for k in range(3)))


def _big(tri_w2b):
    return tri_w2b.shape[0] > MAX_DENSE_FACES


def cast_closest(ro, rd, tri_w2b, avoid):
    '''Closest hit against a face table tri_w2b [F, 3, 4] (packed per
    call; brute above MAX_DENSE_FACES faces): Hit.'''
    ro, rd = _as_v3(ro), _as_v3(rd)
    if _big(tri_w2b):
        return brute.cast_closest(ro, rd, tri_w2b, avoid)
    return dense_cast.cast_closest(ro, rd, avoid, pack_faces(tri_w2b)[0])


def cast_any(ro, rd, tri_w2b, avoid, tmax):
    '''Occlusion against a face table tri_w2b [F, 3, 4] (packed per call;
    brute above MAX_DENSE_FACES faces): [N] bool.'''
    ro, rd = _as_v3(ro), _as_v3(rd)
    if _big(tri_w2b):
        return brute.cast_any(ro, rd, tri_w2b, avoid, tmax)
    return dense_cast.cast_any_flat(ro, rd, avoid, tmax,
                                    pack_faces(tri_w2b)[0])


def cast_shadow(scene, ro, rd, avoid, tmax):
    '''Occlusion cast routed by the scene: [N] bool.'''
    r = _route(scene)
    if r == 'brute':
        return brute.cast_any(ro, rd, scene.tri_w2b, avoid, tmax)
    if r == 'blocked':
        return blocked.blocked_cast_any(ro, rd, avoid, tmax, scene.face_coef,
                                        scene.block_bounds,
                                        scene.node_bounds)
    return dense_cast.cast_any(ro, rd, avoid, tmax, scene.face_coef,
                               *_tree(scene))


def cast_shaded(scene, ro, rd, avoid):
    '''Closest hit + shading attributes, routed by the scene.  Returns
    (hit, normal V3 unit (not yet two-sided-flipped), tex_s [N], tex_t [N],
    mtlid [N] int32 (-1 on a miss)).'''
    r = _route(scene)
    if r == 'brute':
        return _brute_shaded(scene, ro, rd, avoid)
    if r == 'blocked':
        hit, attrs = blocked.blocked_cast_shade(
            ro, rd, avoid, scene.face_coef, scene.face_attr,
            scene.block_bounds, scene.node_bounds)
    else:
        hit, attrs = dense_cast.cast_shade(ro, rd, avoid, scene.face_coef,
                                           scene.face_attr, *_tree(scene))
    normal = vnormalize(V3(attrs[0], attrs[1], attrs[2]))
    mtlid = torch.where(hit.hit, torch.round(attrs[5]).to(torch.int32), -1)
    return hit, normal, attrs[3], attrs[4], mtlid


def _brute_shaded(scene, ro, rd, avoid):
    '''cast_shaded's brute route (the reference's, dispatch.py:127-138):
    the brute closest hit, then the winner's normal, uv and material
    interpolated from the scene's per-corner tables.'''
    hit = brute.cast_closest(ro, rd, scene.tri_w2b, avoid)
    idx = torch.clamp_min(hit.index, 0).long()
    w0 = 1.0 - hit.u - hit.v
    nrm = scene.tri_nrm[idx]  # [N, 3 corners, 3]
    uv = scene.tri_uv[idx]    # [N, 3 corners, 2]
    n = (nrm[:, 0] * w0[:, None] + nrm[:, 1] * hit.u[:, None]
         + nrm[:, 2] * hit.v[:, None])
    tex = (uv[:, 0] * w0[:, None] + uv[:, 1] * hit.u[:, None]
           + uv[:, 2] * hit.v[:, None])
    mtlid = torch.where(hit.hit, scene.tri_mtl[idx], -1)
    return hit, vnormalize(V3(n[:, 0], n[:, 1], n[:, 2])), tex[:, 0], \
        tex[:, 1], mtlid
