'''
Texture atlas sampling.

Reference: ptina_tpu/texture.py.  Bilinear filtering over
(s * (nx - 1), t * (ny - 1)) with wrap-around integer indexing, on the
padded [T, H, W, 4] atlas.
'''

import torch

__all__ = ['sample_texture']


def sample_texture(atlas, texid, s, t):
    '''Bilinear wrap-around fetch.  texid, s, t: [N].  Returns [N, 4].
    texid must be a valid row (clamp or select -1 upstream).'''
    texid = texid.long()
    nx = atlas.nx[texid].long()
    ny = atlas.ny[texid].long()
    px = s * (nx - 1).to(s.dtype)
    py = t * (ny - 1).to(t.dtype)
    ix = torch.floor(px).long()
    iy = torch.floor(py).long()
    fx = (px - ix)[..., None]
    fy = (py - iy)[..., None]

    def fetch(dx, dy):
        x = torch.remainder(ix + dx, torch.clamp_min(nx, 1))
        y = torch.remainder(iy + dy, torch.clamp_min(ny, 1))
        return atlas.data[texid, x, y]

    return (fetch(1, 1) * fx * fy
            + fetch(1, 0) * fx * (1.0 - fy)
            + fetch(0, 0) * (1.0 - fx) * (1.0 - fy)
            + fetch(0, 1) * (1.0 - fx) * fy)
