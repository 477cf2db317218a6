'''
Scene-level ray casts for the integrator.

Reference: ptina_tpu/intersect/dispatch.py (`cast_shaded`, `cast_shadow`).
The reference routes by JAX backend (Pallas on TPU, brute XLA elsewhere);
the port has one dense route whose wrappers (intersect/dense_cast.py)
pick the CUDA kernel or the plain torch version by the tensors' device.
Scenes that need the blocked two-level route (more than MAX_DENSE_FACES
faces, or accel='blocked') raise NotImplementedError: that route is
later work.

Rays are SoA V3 rows; results are dense [N] rows.
'''

import torch

from ptina_tpu_torch.utils.vec import V3, vnormalize
from ptina_tpu_torch.intersect import dense_cast
from ptina_tpu_torch.intersect.dense_cast import MAX_DENSE_FACES

__all__ = ['cast_shaded', 'cast_shadow', 'MAX_DENSE_FACES']


def _dense_only(scene):
    f = scene.face_coef.shape[0]
    if scene.accel == 'blocked' or f > MAX_DENSE_FACES:
        raise NotImplementedError(
            f'{f} faces with accel={scene.accel!r} need the blocked '
            f'two-level cast, which is not ported yet')


def cast_shadow(scene, ro, rd, avoid, tmax):
    '''Occlusion cast: [N] bool.'''
    _dense_only(scene)
    return dense_cast.cast_any(ro, rd, avoid, tmax, scene.face_coef)


def cast_shaded(scene, ro, rd, avoid):
    '''Closest hit + shading attributes.  Returns (hit, normal V3 unit
    (not yet two-sided-flipped), tex_s [N], tex_t [N], mtlid [N] int32
    (-1 on a miss)).'''
    _dense_only(scene)
    hit, attrs = dense_cast.cast_shade(ro, rd, avoid, scene.face_coef,
                                       scene.face_attr)
    normal = vnormalize(V3(attrs[0], attrs[1], attrs[2]))
    mtlid = torch.where(hit.hit, torch.round(attrs[5]).to(torch.int32), -1)
    return hit, normal, attrs[3], attrs[4], mtlid
