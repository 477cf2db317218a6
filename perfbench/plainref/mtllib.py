'''
Material table fetch: mtlid + texcoord -> per-lane Disney parameters.

Reference: ptina_tpu/mtllib.py (reference MaterialPool.get,
ptina/mtllib.py:79-95).  mtlid == -1 selects the defaults row (the
table's last row).  The reference unrolls the factor fetch into a chain
of selects over the static table; the port gathers the lane's row, which
gives the same values.  Texture-modulated parameters multiply by a
bilinear texture sample, only when the scene has a texture atlas.
'''

import torch

from perfbench.plainref.scene import MATERIAL_PARAMS
from perfbench.plainref.vec import V3
from perfbench.plainref.texture import sample_texture
from perfbench.plainref.materials.disney import disney_derive

__all__ = ['fetch_material']


def fetch_material(scene, mtlid, tex_s, tex_t):
    '''mtlid [N] int32, tex_s / tex_t [N] -> derived Disney parameter dict
    (basecolor V3, scalars [N]).'''
    mats = scene.materials
    m1 = mats.fac.shape[0]  # M + 1 (last row = defaults for mtlid -1)
    # an id without a material row takes the defaults too, as the
    # reference's select chain (and its clamped texture gather) gives it
    row = torch.where((mtlid < 0) | (mtlid >= m1), m1 - 1, mtlid).long()
    base_rgb = mats.fac[:, 0, 0:3][row]  # [N, 3]
    scal_tab = mats.fac[:, :, 0][row]    # [N, 12]
    base = V3(base_rgb[:, 0], base_rgb[:, 1], base_rgb[:, 2])
    scal = [scal_tab[:, p] for p in range(1, 12)]

    if scene.textures.data.shape[1] > 1 or scene.textures.data.shape[2] > 1:
        per_lane_tex = mats.tex[row]  # [N, 12]
        has_tex = per_lane_tex >= 0
        for p_i in range(12):
            tid = torch.clamp_min(per_lane_tex[:, p_i], 0)
            texval = sample_texture(scene.textures, tid, tex_s, tex_t)
            if p_i == 0:
                base = V3(
                    base.x * torch.where(has_tex[:, 0], texval[:, 0], 1.0),
                    base.y * torch.where(has_tex[:, 0], texval[:, 1], 1.0),
                    base.z * torch.where(has_tex[:, 0], texval[:, 2], 1.0))
            else:
                scal[p_i - 1] = scal[p_i - 1] * torch.where(
                    has_tex[:, p_i], texval[:, 0], 1.0)

    params = {'basecolor': base}
    for p_i, name in enumerate(MATERIAL_PARAMS[1:], start=1):
        params[name] = scal[p_i - 1]
    return disney_derive(params)
