'''
The plain reference's scene build: a frozen copy of ptina_tpu_torch/scene.py
(material, light and texture tables, face padding, the Morton face order
of the blocked route, the per-face functionals and the cast tables), less
the box trees that only the program's kernels walk: the plain casts test
every face, so the reference needs no tree.

make_scene takes the same host inputs the harness hands the program and
works every table out again.  `round_to` (the control, see
perfbench/plainref/path.py) rounds the vertex table to a lower precision
before anything is derived from it.
'''

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from perfbench.plainref.intersect.casts import BLOCK_FACES, route
from perfbench.plainref.intersect.plucker import pack_faces
from perfbench.plainref.mathutils import sqrt


MATERIAL_PARAMS = (
    'basecolor', 'metallic', 'roughness', 'specular', 'specularTint',
    'subsurface', 'sheen', 'sheenTint', 'clearcoat', 'clearcoatGloss',
    'transmission', 'ior',
)

DEFAULT_MATERIAL = {
    'basecolor': 0.8, 'metallic': 0.0, 'roughness': 0.4, 'specular': 0.5,
    'specularTint': 0.4, 'subsurface': 0.0, 'sheen': 0.0, 'sheenTint': 0.4,
    'clearcoat': 0.0, 'clearcoatGloss': 0.5, 'transmission': 0.0, 'ior': 1.45,
}

LIGHT_POINT = 1
LIGHT_AREA = 2

# lobes the Disney evaluator drops when the parameter is zero across the
# whole table (materials/disney.py reads Materials.zero)
SPECIALIZABLE_PARAMS = ('metallic', 'subsurface', 'sheen', 'clearcoat',
                        'transmission')


@dataclasses.dataclass
class Materials:
    '''[M+1, 12, 4] factors and [M+1, 12] texture ids; row M holds the
    defaults for mtlid == -1.  `zero` names the parameters whose factor
    is 0 in every row (their lobes are skipped); `textured` lists the
    (material, param, texid) bindings with tex >= 0.'''
    fac: torch.Tensor
    tex: torch.Tensor
    zero: tuple = ()
    textured: tuple = ()


@dataclasses.dataclass
class Lights:
    '''Analytic light pool over a fixed capacity L; `kinds` is the static
    tuple of kinds present ('point' / 'area').'''
    color: torch.Tensor  # [L, 3]
    pos: torch.Tensor    # [L, 3]
    axes: torch.Tensor   # [L, 3, 3]
    size: torch.Tensor   # [L]
    type: torch.Tensor   # [L] int32 (0 = empty slot)
    count: torch.Tensor  # [] int32
    kinds: tuple = ('point', 'area')


@dataclasses.dataclass
class TextureAtlas:
    data: torch.Tensor  # [T, H, W, 4] f32
    nx: torch.Tensor    # [T] int32
    ny: torch.Tensor    # [T] int32


@dataclasses.dataclass
class Scene:
    tri_pos: torch.Tensor    # [F, 3, 3] f32
    tri_nrm: torch.Tensor    # [F, 3, 3] f32
    tri_uv: torch.Tensor     # [F, 3, 2] f32
    tri_mtl: torch.Tensor    # [F] int32 (-1 = default)
    tri_w2b: torch.Tensor    # [F, 3, 4] f32 world->barycentric functionals
    tri_attrs: torch.Tensor  # [18, F] corner-major shading attributes
    nfaces: torch.Tensor     # [] int32 live faces
    materials: Materials
    textures: TextureAtlas
    lights: Lights
    world_fac: torch.Tensor  # [4] f32
    world_tex: torch.Tensor  # [] int32
    cam_v2w: torch.Tensor    # [4, 4] f32
    cam_w2v: torch.Tensor    # [4, 4] f32
    # cast-kernel tables (intersect/plucker.pack_faces), built once
    face_coef: torch.Tensor  # [F, 16] f32
    face_attr: torch.Tensor  # [F, 18] f32
    accel: str = 'auto'
    world_tex_id: int = -1

    @property
    def device(self):
        return self.tri_w2b.device

    @property
    def world_textured(self):
        return self.world_tex_id >= 0


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def precompute_tri_functionals(tri_pos):
    '''Per-triangle 3x4 affine functionals M: M[0] . [p, 1] is the plane
    equation with a UNIT normal, M[1] / M[2] the barycentric weights of
    v1 / v2.  Degenerate triangles get all-zero rows.  tri_pos: [F, 3, 3]
    float32 tensor.'''
    v0 = tri_pos[:, 0]
    e1 = tri_pos[:, 1] - v0
    e2 = tri_pos[:, 2] - v0
    n = _cross(e1, e2)
    nn = _dot(n, n)
    ok = nn > 1e-20
    inv_nn = torch.where(ok, 1.0 / torch.where(ok, nn, 1.0), 0.0)
    gu = _cross(e2, n) * inv_nn[:, None]
    gv = _cross(n, e1) * inv_nn[:, None]
    n = n * torch.where(ok, 1.0 / sqrt(torch.where(ok, nn, 1.0)),
                        0.0)[:, None]
    return torch.stack([
        torch.cat([n, -_dot(n, v0)[:, None]], dim=-1),
        torch.cat([gu, -_dot(gu, v0)[:, None]], dim=-1),
        torch.cat([gv, -_dot(gv, v0)[:, None]], dim=-1),
    ], dim=1)


def pack_corner_attrs(tri_nrm, tri_uv, tri_mtl):
    '''Corner-major attribute table [3 corners x 6 channels, F] of
    (nrm.xyz, uv.xy, mtlid).'''
    f = tri_nrm.shape[0]
    mtl = tri_mtl.to(torch.float32)[:, None, None].expand(f, 3, 1)
    per_corner = torch.cat([tri_nrm, tri_uv, mtl], dim=-1)  # [F, 3, 6]
    return per_corner.permute(1, 2, 0).reshape(18, f)


def _morton30_host(p):
    '''30-bit Morton codes for points p [N, 3] in [0, 1] (host numpy;
    a verbatim copy of the reference's, so face orders are bit-equal;
    the bit spreading of ptina/tree/lbvh.py:12-30's morton3D).'''
    q = np.clip(np.floor(p * 1024.0), 0, 1023).astype(np.uint32)

    def expand(v):
        v = (v * np.uint32(0x00010001)) & np.uint32(0xFF0000FF)
        v = (v * np.uint32(0x00000101)) & np.uint32(0x0F00F00F)
        v = (v * np.uint32(0x00000011)) & np.uint32(0xC30C30C3)
        v = (v * np.uint32(0x00000005)) & np.uint32(0x49249249)
        return v
    return expand(q[:, 0]) * 4 + expand(q[:, 1]) * 2 + expand(q[:, 2])


def morton_face_order(tri_pos):
    '''Spatially-coherent face permutation: stable argsort of the Morton
    codes of face centroids normalized to the scene AABB (the leaf order
    of the reference's LBVH, ptina/tree/lbvh.py:168-208).  Host numpy —
    runs once at scene build.'''
    centers = tri_pos.reshape(-1, 3, 3).mean(axis=1)
    lo = centers.min(axis=0)
    hi = centers.max(axis=0)
    norm = (centers - lo) / np.maximum(hi - lo, 1e-12)
    return np.argsort(_morton30_host(norm), kind='stable')


def make_materials(materials=None, max_materials=None,
                   device='cuda'):
    '''Material table from 12-tuples of (fac, texid) pairs in
    MATERIAL_PARAMS order; fac may be scalar, 3- or 4-sequence.'''
    m = max_materials if max_materials is not None else len(materials or [])
    fac = np.ones((m + 1, 12, 4), np.float32)
    tex = np.full((m + 1, 12), -1, np.int32)
    for p, name in enumerate(MATERIAL_PARAMS):
        fac[:, p, :] = DEFAULT_MATERIAL[name]
    if materials:
        if len(materials) > m:
            raise ValueError('too many materials')
        for i, mat in enumerate(materials):
            for p, pair in enumerate(mat):
                f, t = pair
                if f is None:
                    f = 1.0
                f = np.asarray(f, np.float32).reshape(-1)
                if f.size == 1:
                    f = np.repeat(f, 4)
                elif f.size == 3:
                    f = np.concatenate([f, [1.0]]).astype(np.float32)
                fac[i, p, :] = f[:4]
                tex[i, p] = -1 if t is None else int(t)
    return _materials_from_numpy(fac, tex, device)


def _materials_from_numpy(fac, tex, device):
    zero = tuple(
        name for p, name in enumerate(MATERIAL_PARAMS)
        if name in SPECIALIZABLE_PARAMS and not fac[:, p, :3].any())
    textured = tuple(
        (mi, pi, int(tex[mi, pi]))
        for mi in range(fac.shape[0]) for pi in range(12) if tex[mi, pi] >= 0)
    return Materials(fac=torch.as_tensor(fac, device=device),
                     tex=torch.as_tensor(tex, device=device),
                     zero=zero, textured=textured)


def make_textures(images=None, device='cuda'):
    '''Pad and stack numpy images [nx, ny, c] into a TextureAtlas
    (uint8 -> float, grey -> RGB, RGB -> RGBA).'''
    if not images:
        return TextureAtlas(
            data=torch.zeros((1, 1, 1, 4), dtype=torch.float32, device=device),
            nx=torch.ones((1,), dtype=torch.int32, device=device),
            ny=torch.ones((1,), dtype=torch.int32, device=device))
    arrs = []
    for arr in images:
        arr = np.asarray(arr)
        if arr.dtype == np.uint8:
            arr = arr.astype(np.float32) / 255.0
        arr = arr.astype(np.float32)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        if arr.shape[2] == 1:
            arr = np.repeat(arr, 3, axis=2)
        if arr.shape[2] == 3:
            arr = np.concatenate([arr, np.ones_like(arr[:, :, :1])], axis=2)
        arrs.append(arr)
    h = max(a.shape[0] for a in arrs)
    w = max(a.shape[1] for a in arrs)
    data = np.zeros((len(arrs), h, w, 4), np.float32)
    nx = np.zeros(len(arrs), np.int32)
    ny = np.zeros(len(arrs), np.int32)
    for i, a in enumerate(arrs):
        data[i, :a.shape[0], :a.shape[1]] = a
        nx[i], ny[i] = a.shape[0], a.shape[1]
    return TextureAtlas(data=torch.as_tensor(data, device=device),
                        nx=torch.as_tensor(nx, device=device),
                        ny=torch.as_tensor(ny, device=device))


def make_lights(lights=None, max_lights=None, default_light=True,
                device='cuda'):
    '''Light pool from dicts with pos/color/size/type and optional axes;
    with no lights and default_light, the reference's default point light
    (color 32, pos (1, 2, 3), size 0.5).'''
    if lights is None and default_light:
        lights = [dict(color=(32, 32, 32), pos=(1, 2, 3), size=0.5,
                       type=LIGHT_POINT)]
    lights = lights or []
    if max_lights is None:
        max_lights = max(1, len(lights))
    n_l = max_lights
    if len(lights) > n_l:
        raise ValueError('too many lights')
    color = np.zeros((n_l, 3), np.float32)
    pos = np.zeros((n_l, 3), np.float32)
    axes = np.tile(np.eye(3, dtype=np.float32), (n_l, 1, 1))
    size = np.zeros(n_l, np.float32)
    ltype = np.zeros(n_l, np.int32)
    for i, lt in enumerate(lights):
        color[i] = lt['color']
        pos[i] = lt['pos']
        size[i] = lt['size']
        ltype[i] = lt['type']
        if 'axes' in lt:
            axes[i] = lt['axes']
    kinds = tuple(k for k, t in (('point', LIGHT_POINT), ('area', LIGHT_AREA))
                  if any(int(x) == t for x in ltype[:len(lights)]))
    return Lights(color=torch.as_tensor(color, device=device),
                  pos=torch.as_tensor(pos, device=device),
                  axes=torch.as_tensor(axes, device=device),
                  size=torch.as_tensor(size, device=device),
                  type=torch.as_tensor(ltype, device=device),
                  count=torch.tensor(len(lights), dtype=torch.int32,
                                     device=device),
                  kinds=kinds)


def make_scene(vertices, mtlids, materials, lights, cam_pers,
               world_fac=(0.1, 0.1, 0.1, 0.1), images=None, world_tex=-1,
               default_light=True, pad_faces_to=8, accel='auto',
               device='cuda', round_to=None):
    '''ptina_tpu_torch.scene.make_scene on host numpy inputs (vertices
    [F*3, 8] of pos3 + nrm3 + uv2, mtlids [F], the 12-tuple materials, the
    light dicts, the 4x4 world -> clip matrix), without the kernels' trees.
    round_to: a dtype the vertex table is rounded through first (the
    control), or None.'''
    vertices = np.asarray(vertices, np.float32)
    if round_to is not None:
        vertices = torch.from_numpy(vertices).to(round_to).to(
            torch.float32).numpy()
    nfaces = vertices.shape[0] // 3
    mtlids = np.asarray(mtlids, np.int32)
    fpad = max(pad_faces_to,
               ((nfaces + pad_faces_to - 1) // pad_faces_to) * pad_faces_to)
    morton = route(fpad, accel) == 'blocked'
    tri = vertices.reshape(nfaces, 3, 8)
    if morton and nfaces > 1:
        perm = morton_face_order(tri[:, :, 0:3])
        tri = tri[perm]
        mtlids = mtlids[perm]
    if morton:
        fpad = -(-fpad // BLOCK_FACES) * BLOCK_FACES
    tri_pos = np.zeros((fpad, 3, 3), np.float32)
    tri_nrm = np.zeros((fpad, 3, 3), np.float32)
    tri_uv = np.zeros((fpad, 3, 2), np.float32)
    tri_mtl = -np.ones(fpad, np.int32)
    tri_pos[:nfaces] = tri[:, :, 0:3]
    tri_nrm[:nfaces] = tri[:, :, 3:6]
    tri_uv[:nfaces] = tri[:, :, 6:8]
    tri_mtl[:nfaces] = mtlids
    cam_pers = np.asarray(cam_pers, np.float32)
    tri_pos_t = torch.from_numpy(tri_pos)
    tri_w2b = precompute_tri_functionals(tri_pos_t)
    tri_attrs = pack_corner_attrs(torch.from_numpy(tri_nrm),
                                  torch.from_numpy(tri_uv),
                                  torch.from_numpy(tri_mtl))
    coef, attr = pack_faces(tri_w2b, tri_attrs)

    def dev(x):
        return torch.tensor(np.asarray(x)).to(device)
    return Scene(
        tri_pos=tri_pos_t.to(device), tri_nrm=dev(tri_nrm),
        tri_uv=dev(tri_uv), tri_mtl=dev(tri_mtl), tri_w2b=tri_w2b.to(device),
        tri_attrs=tri_attrs.to(device),
        nfaces=torch.tensor(nfaces, dtype=torch.int32, device=device),
        materials=make_materials(materials, device=device),
        textures=make_textures(images, device=device),
        lights=make_lights(lights, default_light=default_light,
                           device=device),
        world_fac=dev(np.asarray(world_fac, np.float32)),
        world_tex=torch.tensor(int(world_tex), dtype=torch.int32,
                               device=device),
        cam_v2w=dev(np.linalg.inv(cam_pers).astype(np.float32)),
        cam_w2v=dev(cam_pers), face_coef=coef.to(device),
        face_attr=attr.to(device), accel=accel, world_tex_id=int(world_tex))


def with_tensor(obj, path, t):
    '''obj with the tensor at `path` (field names) replaced by t.'''
    if len(path) == 1:
        return dataclasses.replace(obj, **{path[0]: t})
    return dataclasses.replace(
        obj, **{path[0]: with_tensor(getattr(obj, path[0]), path[1:], t)})
