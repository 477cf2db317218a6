'''
Material table fetch: mtlid + texcoord -> per-lane Disney parameters.

Reference: ptina_tpu/mtllib.py (reference MaterialPool.get,
ptina/mtllib.py:79-95).  mtlid == -1 selects the defaults row (the
table's last row).  The reference unrolls the factor fetch into a chain
of selects over the static table; the port gathers the lane's row, which
gives the same values.  Texture-modulated parameters multiply by a
bilinear texture sample, only when the scene has a texture atlas.

The factor gather's backward.  Under autograd each of the two gathers'
backward is index_put_(accumulate=True), which PyTorch runs on the card
as a sort and a serial walk over each row's lanes, two dependent loads a
lane: with a handful of material rows and every lane of a 512^2 sample,
tens of milliseconds a bounce.  The fetch gathers through MaterialRows:
its forward is the same indexing (the same values bit for bit; with no
grad mode, or factors that need none, autograd records nothing), and its
backward, material_rows_backward, is one launch of csrc/material_rows.cu
on CUDA tensors.  The kernel makes the sums index_put_ makes on the card,
each a float32 sum from 0 in lane order, so the gradient is the aten
path's bit for bit.  On CPU tensors the backward is the plain twin,
material_rows_backward_plain: the gathers' own backward, index_put_ into
the rows, so the CPU gradients are autograd's own.  The library is built
at the first backward on the card (utils/cuda_build.py); LAUNCHES counts
its launches, each inside a `grad.material_rows` span (utils/trace.py).
'''

import ctypes
import functools

import torch

from ptina_tpu_torch.scene import MATERIAL_PARAMS
from ptina_tpu_torch.utils import trace
from ptina_tpu_torch.utils.cuda_build import (build_shared_library, ptr,
                                              raise_on, stream_ptr)
from ptina_tpu_torch.utils.vec import V3
from ptina_tpu_torch.texture import sample_texture
from ptina_tpu_torch.materials.disney import disney_derive

__all__ = ['fetch_material', 'material_rows', 'MaterialRows',
           'material_rows_backward', 'material_rows_backward_plain',
           'build_library', 'LAUNCHES']

LAUNCHES = {'material_rows': 0}

_SOURCES = ('material_rows.cu',)

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=1)
def build_library():
    '''Compile (once per source hash; utils/cuda_build.py) and load the
    material-row library.  Returns (ctypes.CDLL, nvcc log text — empty
    when an existing build was loaded).'''
    lib, log = build_shared_library('ptina_material_rows', _SOURCES[0],
                                    _SOURCES)
    lib.ptina_material_rows.argtypes = [_P, _P, _P, _I, _I, _P, _P]
    lib.ptina_material_rows.restype = _I
    return lib, log


def material_rows_backward_plain(row, g_base, g_scal, m1):
    '''Plain twin of material_rows_backward: the gathers' own backward,
    index_put_(accumulate=True) of each cotangent into its rows (float32,
    from 0, in lane order on the card), placed in the [m1, 12, 4]
    gradient: parameter p's channel 0 and basecolor's channels 0-2, the
    entries the gathers read, entry (0, 0) getting both its sums.'''
    def summed(g):
        return torch.zeros((m1, g.shape[1]), dtype=g.dtype,
                           device=g.device).index_put_((row,), g,
                                                       accumulate=True)
    out = torch.zeros((m1, 12, 4), dtype=g_base.dtype, device=row.device)
    out[:, :, 0] = summed(g_scal)
    out[:, 0, 0:3] += summed(g_base)
    return out


def material_rows_backward(row, g_base, g_scal, m1):
    '''The backward of fetch_material's two gathers: row [N] int64 (each
    in [0, m1)), g_base [N, 3] and g_scal [N, 12] float32 cotangents ->
    the [m1, 12, 4] float32 gradient of the factors.  CPU tensors take
    the plain twin; CUDA tensors one launch of the kernel, or an
    exception.'''
    if row.device.type != 'cuda':
        return material_rows_backward_plain(row, g_base, g_scal, m1)
    n = row.shape[0]
    if row.dtype != torch.int64 or row.dim() != 1:
        raise ValueError('material_rows_backward: row must be [N] int64')
    for name, g, w in (('g_base', g_base, 3), ('g_scal', g_scal, 12)):
        if g.dtype != torch.float32 or tuple(g.shape) != (n, w) \
                or g.device != row.device:
            raise ValueError(f'material_rows_backward: {name} must be '
                             f'[{n}, {w}] float32 on {row.device}')
    out = torch.empty((m1, 12, 4), dtype=torch.float32, device=row.device)
    if n == 0:
        return out.zero_()
    lib, _ = build_library()
    row, g_base, g_scal = (t.contiguous() for t in (row, g_base, g_scal))
    with trace.span('grad.material_rows'):
        raise_on(lib.ptina_material_rows(
            ptr(row), ptr(g_base), ptr(g_scal), n, m1, ptr(out),
            stream_ptr()), 'material_rows')
        LAUNCHES['material_rows'] += 1
    return out


class MaterialRows(torch.autograd.Function):
    '''apply(fac [M+1, 12, 4], row [N] int64) -> (base_rgb [N, 3],
    scal_tab [N, 12]): fetch_material's two gathers, by the same indexing;
    the backward is material_rows_backward.'''

    @staticmethod
    def forward(ctx, fac, row):
        ctx.save_for_backward(row)
        ctx.m1 = fac.shape[0]
        return fac[:, 0, 0:3][row], fac[:, :, 0][row]

    @staticmethod
    def backward(ctx, g_base, g_scal):
        row, = ctx.saved_tensors
        return material_rows_backward(row, g_base, g_scal, ctx.m1), None


def material_rows(scene, mtlid, tex_s, tex_t):
    '''mtlid [N] int32, tex_s / tex_t [N] -> the raw Disney parameter
    dict (basecolor V3, the 11 scalars [N]): the lane's factor row
    (MaterialRows), each parameter times its bilinear texture sample
    where the lane's material binds one, on a scene with a texture atlas
    whose table binds a texture at all (texture.TexelRows' gathers; a
    table that binds none, as under a textured world alone, fetches no
    texel: a factor times 1 is the factor, and its texels' gradient 0).
    The part of the fetch that holds hand-written backwards; the pair's
    recompute runs it eagerly between its captured shading segments
    (engine/fused.py).'''
    mats = scene.materials
    m1 = mats.fac.shape[0]  # M + 1 (last row = defaults for mtlid -1)
    # an id without a material row takes the defaults too, as the
    # reference's select chain (and its clamped texture gather) gives it
    row = torch.where((mtlid < 0) | (mtlid >= m1), m1 - 1, mtlid).long()
    base_rgb, scal_tab = MaterialRows.apply(mats.fac, row)  # [N, 3], [N, 12]
    base = V3(base_rgb[:, 0], base_rgb[:, 1], base_rgb[:, 2])
    scal = [scal_tab[:, p] for p in range(1, 12)]

    if mats.textured and (scene.textures.data.shape[1] > 1
                          or scene.textures.data.shape[2] > 1):
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
    return params


def fetch_material(scene, mtlid, tex_s, tex_t):
    '''mtlid [N] int32, tex_s / tex_t [N] -> derived Disney parameter dict
    (basecolor V3, scalars [N]): material_rows, then disney_derive.'''
    return disney_derive(material_rows(scene, mtlid, tex_s, tex_t))
