'''
Texture atlas sampling.

Reference: ptina_tpu/texture.py.  Bilinear filtering over
(s * (nx - 1), t * (ny - 1)) with wrap-around integer indexing, on the
padded [T, H, W, 4] atlas.

The texel gather's backward.  Each of a fetch's four texel gathers,
`data[texid, x, y]`, goes through TexelRows: its forward is the same
indexing (the same values bit for bit; with no grad mode, or an atlas
that needs none, autograd records nothing), and its backward is
texel_rows_backward.  A fetch serves the material rows (mtllib: every
parameter's texture at the hit's uv, the lanes that miss or hit a
surface with no uvs reading the texels at uv 0) and a textured world
(lights.world_at: the lanes' directions on the environment map, where
the lanes that miss are the live ones and an orthographic camera's
direct misses all read one texel a gather).  Autograd's own gather
backward, index_put_ with accumulate into zeros, runs on the card as a
sort and a serial walk over each texel's lanes, most of them all-zero
rows on the texels at uv 0.  On CUDA tensors texel_rows_backward is
instead two launches of csrc/texel_rows.cu, which skips the lanes whose
cotangent row is all zeros and makes the sums index_put_ makes on the
card, each a float32 sum from +0 over the texel's lanes in lane order, so
the gradient is the aten path's bit for bit (the kernel's note says why
skipping keeps the bits).  On CPU tensors it is the plain twin,
texel_rows_backward_plain, the gather's own backward, so the CPU
gradients are autograd's own.  The library is built at the first
backward on the card (utils/cuda_build.py); LAUNCHES counts its launches.
Each backward runs inside a `grad.texel_rows` span (utils/trace.py), the
kernel's two launches alone inside a `grad.texel_rows.kernels` span, and
while tracing is on it counts, as device sums (trace.add_counts(
'texel_rows', ...)), the lanes it walks, the lanes whose cotangent row
is nonzero and the distinct texels it writes.
'''

import ctypes
import functools

import torch

from ptina_tpu_torch.utils import trace
from ptina_tpu_torch.utils.cuda_build import (build_shared_library, ptr,
                                              raise_on, stream_ptr)

__all__ = ['sample_texture', 'texel_keys', 'TexelRows',
           'texel_rows_backward', 'texel_rows_backward_plain',
           'build_library', 'LAUNCHES']

LAUNCHES = {'texel_rows': 0}

_SOURCES = ('texel_rows.cu',)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


@functools.lru_cache(maxsize=1)
def build_library():
    '''Compile (once per source hash; utils/cuda_build.py) and load the
    texel-row library.  Returns (ctypes.CDLL, nvcc log text — empty when
    an existing build was loaded).'''
    lib, log = build_shared_library('ptina_texel_rows', _SOURCES[0],
                                    _SOURCES)
    lib.ptina_texel_rows_scratch.argtypes = [_I, _I]
    lib.ptina_texel_rows_scratch.restype = ctypes.c_size_t
    lib.ptina_texel_rows.argtypes = [_P, _P, _P, _P, _L, _L, _L, _I, _I, _I,
                                     _I, _P, _P, _P]
    lib.ptina_texel_rows.restype = _I
    return lib, log


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


def texel_rows_backward_plain(texid, x, y, g, shape):
    '''Plain twin of texel_rows_backward: the gather's own backward,
    zeros of `shape` with each lane's row added at its texel by
    index_put_(accumulate=True) (on the card a float32 sum from +0 in lane
    order a texel and channel).'''
    return torch.zeros(shape, dtype=g.dtype, device=g.device) \
        .index_put_((texid, x, y), g, accumulate=True)


def _texel_rows_kernel(texid, x, y, g, shape):
    '''The two launches of csrc/texel_rows.cu, or an exception.'''
    n = g.shape[0]
    t_, h_, w_, c_ = shape
    texels = t_ * h_ * w_
    dev = g.device
    if g.dtype != torch.float32 or g.shape != (n, 4) or c_ != 4:
        raise ValueError('texel_rows_backward: g must be [N, 4] float32 '
                         'onto a [T, H, W, 4] atlas')
    for name, t in (('texid', texid), ('x', x), ('y', y)):
        if t.dtype != torch.int64 or t.shape != (n,) or t.device != dev:
            raise ValueError(f'texel_rows_backward: {name} must be [{n}] '
                             f'int64 on {dev}')
    if n >= 2 ** 31 or texels >= 2 ** 31:
        raise ValueError('texel_rows_backward: over 2^31 lanes or texels')
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    if n == 0 or texels == 0:
        return out.zero_()
    lib, _ = build_library()
    g = g.contiguous()
    if g.data_ptr() % 16:  # the kernel reads a row as one 16-byte load
        g = g.clone()
    scratch = torch.empty(lib.ptina_texel_rows_scratch(n, texels),
                          dtype=torch.uint8, device=dev)
    args = (ptr(g), texid.data_ptr(), x.data_ptr(), y.data_ptr(),
            texid.stride(0), x.stride(0), y.stride(0), n, h_, w_, texels,
            ptr(scratch), ptr(out), stream_ptr())
    with trace.span('grad.texel_rows.kernels'):
        err = lib.ptina_texel_rows(*args)
    raise_on(err, 'texel_rows')
    LAUNCHES['texel_rows'] += 2
    return out


def texel_rows_backward(texid, x, y, g, shape):
    '''The backward of one texel gather data[texid, x, y]: texid, x, y
    [N] int64, g [N, 4] cotangents -> the [T, H, W, 4] gradient of the
    atlas (shape), each texel's lanes' rows summed from +0 in lane order,
    as autograd's gather backward makes it on the card.  CPU tensors take
    the plain twin; CUDA tensors two launches of the kernel, or an
    exception.'''
    with trace.span('grad.texel_rows'):
        if g.device.type == 'cuda':
            out = _texel_rows_kernel(texid, x, y, g, shape)
        else:
            out = texel_rows_backward_plain(texid, x, y, g, shape)
    if trace.tracing():
        trace.add_counts('texel_rows', _count(texid, x, y, g, shape))
    return out


class TexelRows(torch.autograd.Function):
    '''apply(data [T, H, W, 4], texid, x, y [N] int64) -> data[texid, x,
    y] [N, 4], by the same indexing; the backward is
    texel_rows_backward, and nothing where autograd reaches the gather
    with no gradient (the pair's captured recompute can: its segments
    take every parameter of the fetch).'''

    @staticmethod
    def forward(ctx, data, texid, x, y):
        ctx.save_for_backward(texid, x, y)
        ctx.shape = data.shape
        ctx.set_materialize_grads(False)
        return data[texid, x, y]

    @staticmethod
    def backward(ctx, g):
        if g is None:  # reached, but no gradient flows here
            return None, None, None, None
        texid, x, y = ctx.saved_tensors
        return texel_rows_backward(texid, x, y, g, ctx.shape), None, None, \
            None


# the (dx, dy) corner of each of a bilinear fetch's four gathers, in the
# order sample_texture adds them
_CORNERS = ((1, 1), (1, 0), (0, 0), (0, 1))


def _bilinear(atlas, texid, s, t):
    '''(texid, the corner's (x, y) indices of each of the four gathers,
    fx, fy [N, 1]) of a bilinear wrap-around fetch.'''
    texid = texid.long()
    nx = atlas.nx[texid].long()
    ny = atlas.ny[texid].long()
    px = s * (nx - 1).to(s.dtype)
    py = t * (ny - 1).to(t.dtype)
    ix = torch.floor(px).long()
    iy = torch.floor(py).long()
    fx = (px - ix)[..., None]
    fy = (py - iy)[..., None]
    corners = [(torch.remainder(ix + dx, torch.clamp_min(nx, 1)),
                torch.remainder(iy + dy, torch.clamp_min(ny, 1)))
               for dx, dy in _CORNERS]
    return texid, corners, fx, fy


def sample_texture(atlas, texid, s, t):
    '''Bilinear wrap-around fetch.  texid, s, t: [N].  Returns [N, 4].
    texid must be a valid row (clamp or select -1 upstream).'''
    texid, corners, fx, fy = _bilinear(atlas, texid, s, t)

    def fetch(k):
        return TexelRows.apply(atlas.data, texid, *corners[k])

    return (fetch(0) * fx * fy
            + fetch(1) * fx * (1.0 - fy)
            + fetch(2) * (1.0 - fx) * (1.0 - fy)
            + fetch(3) * (1.0 - fx) * fy)


def texel_keys(atlas, texid, s, t):
    '''[4, N] int64: the flat atlas texel, (texid * H + x) * W + y, that
    each of sample_texture's four gathers reads for each lane.'''
    _, h_, w_ = atlas.data.shape[:3]
    texid, corners, _, _ = _bilinear(atlas, texid, s, t)
    return torch.stack([(texid * h_ + x) * w_ + y for x, y in corners])
