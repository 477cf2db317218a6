'''
Texture atlas sampling.

Reference: ptina_tpu/texture.py.  Bilinear filtering over
(s * (nx - 1), t * (ny - 1)) with wrap-around integer indexing, on the
padded [T, H, W, 4] atlas.

The texel gather's backward.  Each of a fetch's four texel gathers,
`data[texid, x, y]`, goes through TexelRows: its forward is the same
indexing (the same values bit for bit; with no grad mode, or an atlas
that needs none, autograd records nothing), and its backward,
texel_rows_backward, is the gather's own backward, index_put_ with
accumulate into zeros, so the gradient is autograd's own, bit for bit,
on either device.  On the card that backward is PyTorch's sort and its
serial walk over each texel's lanes; each runs inside a
`grad.texel_rows` span (utils/trace.py), and while tracing is on it
counts, as device sums (trace.add_counts('texel_rows', ...)), the lanes
it walks, the lanes whose cotangent row is nonzero and the distinct
texels it writes.
'''

import torch

from ptina_tpu_torch.utils import trace

__all__ = ['sample_texture', 'TexelRows', 'texel_rows_backward']


def _count(texid, x, y, g, shape):
    '''The texel_rows counters of one backward (tracing on): [lanes
    walked, lanes with a nonzero cotangent row, distinct texels written],
    int64 on the cotangent's device, with no host sync.'''
    t_, h_, w_ = shape[:3]
    flat = ((texid * h_ + x) * w_ + y).reshape(-1)
    mark = torch.zeros(t_ * h_ * w_, dtype=torch.int32, device=g.device) \
        .index_fill_(0, flat, 1)
    live = (g != 0).any(dim=1).sum()
    return torch.stack([live.new_full((), flat.shape[0]), live, mark.sum()])


def texel_rows_backward(texid, x, y, g, shape):
    '''The backward of one texel gather data[texid, x, y]: texid, x, y
    [N] int64, g [N, 4] cotangents -> the [T, H, W, 4] gradient of the
    atlas (shape), zeros with each lane's row added at its texel by
    index_put_(accumulate=True), as autograd's gather backward makes it.'''
    with trace.span('grad.texel_rows'):
        out = torch.zeros(shape, dtype=g.dtype, device=g.device) \
            .index_put_((texid, x, y), g, accumulate=True)
    if trace.tracing():
        trace.add_counts('texel_rows', _count(texid, x, y, g, shape))
    return out


class TexelRows(torch.autograd.Function):
    '''apply(data [T, H, W, 4], texid, x, y [N] int64) -> data[texid, x,
    y] [N, 4], by the same indexing; the backward is
    texel_rows_backward.'''

    @staticmethod
    def forward(ctx, data, texid, x, y):
        ctx.save_for_backward(texid, x, y)
        ctx.shape = data.shape
        return data[texid, x, y]

    @staticmethod
    def backward(ctx, g):
        texid, x, y = ctx.saved_tensors
        return texel_rows_backward(texid, x, y, g, ctx.shape), None, None, \
            None


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
        return TexelRows.apply(atlas.data, texid, x, y)

    return (fetch(1, 1) * fx * fy
            + fetch(1, 0) * fx * (1.0 - fy)
            + fetch(0, 0) * (1.0 - fx) * (1.0 - fy)
            + fetch(0, 1) * (1.0 - fx) * fy)
