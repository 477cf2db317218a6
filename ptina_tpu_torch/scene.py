'''
Scene representation: one dataclass of tensors.

Reference: ptina_tpu/scene.py.  The host half (material, light and
texture tables, face padding, the Morton face order and the per-block
boxes) is copied numpy code; the per-face functionals are computed with
torch in float32 in the reference's operation order, on the host, and the
finished tensors are moved to the scene's device once.

Static structure stays plain Python attributes, as in the reference:
Materials.zero / textured, Lights.kinds, Scene.accel and
Scene.world_tex_id.

Beyond the reference's fields the port carries the two per-face tables
its cast kernels read (intersect/plucker.pack_faces), computed ONCE per
scene: the reference repacks them inside every traced cast.

Big scenes (more than MAX_DENSE_FACES padded faces, or accel='blocked')
take the blocked two-level cast (intersect/blocked.py): their faces are
Morton-ordered and padded to whole BLOCK_FACES blocks, and block_bounds
holds each block's box.  Block b is rows b * BLOCK_FACES ... of the same
face_coef / face_attr tables; the reference's transposed t5b / attrsb
block tables are a TPU layout and are not carried.  The port's own
node_bounds is the box tree its blocked kernels walk: an implicit
complete binary tree over leaves of LEAF_FACES consecutive faces
(compute_node_bounds); the reference has no such table.  accel='dense' above
MAX_DENSE_FACES takes the reference's brute route (intersect/dispatch.py):
build order, no Morton order, no blocks to pad to.

Dense-route scenes carry a second tree of the port's own (dense_tree), the
one every dense-route cast kernel walks: the path megakernel's two casts
(engine/fused.py) and the wavefront's scene-level casts
(intersect/dense_cast.py: cast_shade, cast_any).  fused_order holds the
faces re-ordered for it (fused_face_order), fused_coef their face_coef
rows in that order, and fused_nodes compute_node_bounds over that order.
The scene's own tables and face ids stay in build order: the kernels key
and gather by the original id.  Blocked- and brute-route scenes carry
these three with zero rows.
'''

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ptina_tpu_torch.intersect.blocked import (BLOCK_FACES, LEAF_FACES,
                                               MAX_BLOCKS, tree_leaves)
from ptina_tpu_torch.intersect.dense_cast import MAX_DENSE_FACES
from ptina_tpu_torch.intersect.dispatch import route
from ptina_tpu_torch.intersect.plucker import pack_faces
from ptina_tpu_torch.utils.mathutils import sqrt

__all__ = ['Scene', 'Materials', 'Lights', 'TextureAtlas', 'make_scene',
           'make_materials', 'make_lights', 'make_textures',
           'scene_from_numpy', 'with_tensor', 'precompute_tri_functionals',
           'pack_corner_attrs', 'morton_face_order', 'compute_block_bounds',
           'compute_node_bounds', 'fused_face_order', 'dense_tree',
           'DEFAULT_MATERIAL',
           'MATERIAL_PARAMS', 'LIGHT_POINT', 'LIGHT_AREA', 'MAX_DENSE_FACES',
           'BLOCK_FACES', 'LEAF_FACES', 'MAX_BLOCKS']

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
    block_bounds: torch.Tensor  # [ceil(F / BLOCK_FACES), 8] f32 boxes
    node_bounds: torch.Tensor   # [2 * P, 8] f32 box tree (compute_node_bounds)
    # the dense casts' and the megakernel's box tree (dense_tree; zero rows
    # on the blocked route)
    fused_order: torch.Tensor   # [F] int32 face id of each tree slot
    fused_coef: torch.Tensor    # [F, 16] f32 face_coef[fused_order]
    fused_nodes: torch.Tensor   # [2 * P, 8] f32 tree over fused_order
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


def compute_block_bounds(tri_pos, nfaces, block_faces=BLOCK_FACES):
    '''Per-face-block AABBs [ceil(F / block), 8] of (lo.xyz, hi.xyz, 0, 0)
    over the padded face table tri_pos [F, 3, 3].  Only live faces
    (index < nfaces) contribute; blocks of pure padding get an inverted
    box (+big lo, -big hi) so every slab test rejects them.  Host numpy.'''
    f = tri_pos.shape[0]
    nblocks = max(1, -(-f // block_faces))
    big = np.float32(3.4e38)
    out = np.zeros((nblocks, 8), np.float32)
    out[:, 0:3] = big
    out[:, 3:6] = -big
    for b in range(nblocks):
        s = b * block_faces
        e = min(min(s + block_faces, f), nfaces)
        if e <= s:
            continue
        verts = tri_pos[s:e].reshape(-1, 3)
        out[b, 0:3] = verts.min(axis=0)
        out[b, 3:6] = verts.max(axis=0)
    return out


def compute_node_bounds(tri_pos, nfaces):
    '''The box tree of the blocked casts: an implicit complete binary tree
    in heap layout over the leaves of LEAF_FACES consecutive faces of the
    padded table tri_pos [F, 3, 3].  Returns [2 * P, 8] float32 rows of
    (lo.xyz, hi.xyz, 0, 0), P the least power of two >= ceil(F / 32):
    node k has children 2k and 2k + 1, leaf l is node P + l (faces 32 l
    ... 32 l + 31, inside block l // 16), and each inner node's box is
    the union of its children's.  Leaves and nodes that hold no live face
    keep the inverted box of compute_block_bounds, so every slab test
    rejects them; row 0 is unused.  The tree's depth is log2(P): 12 for
    cornell_highpoly's 3,184 leaves, at most 16 at MAX_BLOCKS.  Host
    numpy.'''
    leaves = compute_block_bounds(tri_pos, nfaces, LEAF_FACES)
    p = tree_leaves(tri_pos.shape[0])
    out = np.zeros((2 * p, 8), np.float32)
    out[:, 0:3] = np.float32(3.4e38)
    out[:, 3:6] = np.float32(-3.4e38)
    out[p:p + leaves.shape[0]] = leaves
    for s in range(p.bit_length() - 2, -1, -1):  # levels bottom-up
        k = np.arange(1 << s, 2 << s)
        out[k, 0:3] = np.minimum(out[2 * k, 0:3], out[2 * k + 1, 0:3])
        out[k, 3:6] = np.maximum(out[2 * k, 3:6], out[2 * k + 1, 3:6])
    return out


def fused_face_order(tri_pos, nfaces):
    '''The face order of the dense box tree (dense_tree) over the padded table
    tri_pos [F, 3, 3]: the live faces whose box's largest extent exceeds
    a quarter of the scene box's largest extent first, in index order,
    then the other live faces in Morton order, then the padding.  A
    room-spanning wall scattered by Morton order would make every leaf it
    lands in span the room; gathered up front it costs its own leaves
    only.  [F] int64, host numpy.'''
    f = tri_pos.shape[0]
    if nfaces == 0:
        return np.arange(f)
    live = tri_pos[:nfaces]
    ext = live.max(axis=1) - live.min(axis=1)  # [nf, 3]
    verts = live.reshape(-1, 3)
    large = ext.max(axis=1) > 0.25 * (verts.max(axis=0)
                                      - verts.min(axis=0)).max()
    rest = np.flatnonzero(~large)
    if rest.size > 1:
        rest = rest[morton_face_order(live[rest])]
    return np.concatenate([np.flatnonzero(large), rest,
                           np.arange(nfaces, f)]).astype(np.int64)


def dense_tree(tri_pos, nfaces, coef):
    '''The box tree of a dense-route face table: (fused_coef [F, 16],
    fused_nodes [2P, 8], fused_order [F] int32) for the padded positions
    tri_pos [F, 3, 3] (numpy) with nfaces live faces and their coef rows
    [F, 16] (torch, plucker.pack_faces).  Host tensors.'''
    pos = np.asarray(tri_pos)
    order = fused_face_order(pos, int(nfaces))
    nodes = compute_node_bounds(pos[order], int(nfaces))
    return (coef[torch.from_numpy(order)], torch.from_numpy(nodes),
            torch.from_numpy(order.astype(np.int32)))


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


def _finish(tri_pos, tri_nrm, tri_uv, tri_mtl, tri_w2b, tri_attrs, nfaces,
            materials, textures, lights, world_fac, world_tex, cam_v2w,
            cam_w2v, accel, world_tex_id, device):
    '''Assemble the Scene from host tensors, add the kernel tables and
    move everything to `device`.'''
    coef, attr = pack_faces(tri_w2b, tri_attrs)
    pos = np.asarray(tri_pos)
    bounds = compute_block_bounds(pos, int(nfaces))
    nodes = compute_node_bounds(pos, int(nfaces))
    if route(pos.shape[0], accel) == 'dense':
        fused_coef, fused_nodes, order = dense_tree(pos, nfaces, coef)
    else:  # no dense cast takes the blocked or brute route
        fused_coef = coef[:0]
        fused_nodes = torch.zeros((0, 8), dtype=torch.float32)
        order = torch.zeros(0, dtype=torch.int32)

    def dev(x):
        if isinstance(x, np.ndarray):
            x = torch.tensor(x)  # a copy: the caller's array may be read-only
        return x.to(device)
    return Scene(
        tri_pos=dev(tri_pos), tri_nrm=dev(tri_nrm), tri_uv=dev(tri_uv),
        tri_mtl=dev(tri_mtl), tri_w2b=dev(tri_w2b), tri_attrs=dev(tri_attrs),
        nfaces=torch.tensor(int(nfaces), dtype=torch.int32, device=device),
        materials=materials, textures=textures, lights=lights,
        world_fac=dev(np.asarray(world_fac, np.float32)),
        world_tex=torch.tensor(int(world_tex), dtype=torch.int32,
                               device=device),
        cam_v2w=dev(np.asarray(cam_v2w, np.float32)),
        cam_w2v=dev(np.asarray(cam_w2v, np.float32)),
        face_coef=dev(coef), face_attr=dev(attr), block_bounds=dev(bounds),
        node_bounds=dev(nodes),
        fused_order=dev(order), fused_coef=dev(fused_coef),
        fused_nodes=dev(fused_nodes), accel=accel,
        world_tex_id=int(world_tex_id))


def make_scene(vertices, mtlids=None, materials=None, images=None,
               lights=None, world_fac=(0.1, 0.1, 0.1, 0.1), world_tex=-1,
               cam_pers=None, default_light=True, pad_faces_to=8,
               accel='auto', max_lights=None, max_materials=None,
               device='cuda'):
    '''Assemble a Scene from host-side numpy data.

    vertices: [F*3, 8] float array (pos3 + nrm3 + uv2 per vertex).
    mtlids: [F] int material ids (-1 = default material).
    cam_pers: 4x4 projection @ view matrix (world -> clip).
    accel: 'auto' | 'dense' | 'blocked' (intersect/dispatch.route routes
    by it).  The face count is padded to a multiple of pad_faces_to with
    all-zero faces, which never hit.  Scenes of the blocked route (more
    than MAX_DENSE_FACES padded faces, or accel='blocked') are first
    Morton-ordered and padded to whole BLOCK_FACES blocks, as the
    reference's morton=None rule does (scene.py:422-432); accel='dense'
    above MAX_DENSE_FACES keeps build order for the brute route.  Raises
    ValueError above MAX_BLOCKS blocks on the blocked route.'''
    from ptina_tpu_torch.io.matrix import ortho, lookat
    vertices = np.asarray(vertices, np.float32)
    if not (vertices.ndim == 2 and vertices.shape[1] == 8
            and vertices.shape[0] % 3 == 0):
        raise ValueError('vertices must be [F*3, 8]')
    nfaces = vertices.shape[0] // 3
    if mtlids is None:
        mtlids = -np.ones(nfaces, np.int32)
    mtlids = np.asarray(mtlids, np.int32)
    if mtlids.shape[0] != nfaces:
        raise ValueError('one material id per face')

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
    # padding triangles are degenerate (all-zero) -> never hit

    if cam_pers is None:
        cam_pers = ortho() @ lookat()
    cam_pers = np.asarray(cam_pers, np.float32)

    tri_pos_t = torch.from_numpy(tri_pos)
    tri_w2b = precompute_tri_functionals(tri_pos_t)
    tri_attrs = pack_corner_attrs(torch.from_numpy(tri_nrm),
                                  torch.from_numpy(tri_uv),
                                  torch.from_numpy(tri_mtl))
    return _finish(
        tri_pos_t, tri_nrm, tri_uv, tri_mtl, tri_w2b, tri_attrs, nfaces,
        make_materials(materials, max_materials=max_materials, device=device),
        make_textures(images, device=device),
        make_lights(lights, max_lights=max_lights,
                    default_light=default_light, device=device),
        world_fac, world_tex, np.linalg.inv(cam_pers), cam_pers, accel,
        world_tex, device)


_TRI_KEYS = ('tri_pos', 'tri_nrm', 'tri_uv', 'tri_mtl', 'tri_w2b',
             'tri_attrs')
_LIGHT_KEYS = ('color', 'pos', 'axes', 'size', 'type')


def scene_from_numpy(arrays, device='cuda'):
    '''Scene from a dict of numpy arrays holding the reference Scene's
    fields, so both packages render one scene from the same numbers:

      tri_pos, tri_nrm, tri_uv, tri_mtl, tri_w2b, tri_attrs, nfaces,
      mat_fac, mat_tex, mat_zero (tuple), mat_textured (tuple),
      light_color, light_pos, light_axes, light_size, light_type,
      light_count, light_kinds (tuple), tex_data, tex_nx, tex_ny,
      world_fac, world_tex, cam_v2w, cam_w2v, accel (str).

    The cast-kernel tables, block_bounds and node_bounds are derived
    here, not carried.'''
    a = arrays
    f = np.asarray(a['tri_w2b']).shape[0]
    route(f, a.get('accel', 'auto'))
    def t(x, dev=device):
        return torch.tensor(np.asarray(x), device=dev)  # a copy
    tri = {k: t(a[k], 'cpu') for k in _TRI_KEYS}
    mats = Materials(fac=t(a['mat_fac']), tex=t(a['mat_tex']),
                     zero=tuple(a['mat_zero']),
                     textured=tuple(tuple(int(v) for v in b)
                                    for b in a['mat_textured']))
    lights = Lights(**{k: t(a['light_' + k]) for k in _LIGHT_KEYS},
                    count=torch.tensor(int(a['light_count']),
                                       dtype=torch.int32, device=device),
                    kinds=tuple(a['light_kinds']))
    tex = TextureAtlas(data=t(a['tex_data']), nx=t(a['tex_nx']),
                       ny=t(a['tex_ny']))
    world_tex = int(np.asarray(a['world_tex']))
    return _finish(tri['tri_pos'], tri['tri_nrm'], tri['tri_uv'],
                   tri['tri_mtl'], tri['tri_w2b'], tri['tri_attrs'],
                   int(np.asarray(a['nfaces'])), mats, tex, lights,
                   a['world_fac'], world_tex, a['cam_v2w'], a['cam_w2v'],
                   a.get('accel', 'auto'), world_tex, device)


def with_tensor(obj, path, t):
    '''obj (a Scene, or its Materials, TextureAtlas or Lights) with the
    tensor at `path`, a tuple of field names such as ('materials', 'fac'),
    replaced by t through dataclasses.replace; obj itself is unchanged.'''
    if len(path) == 1:
        return dataclasses.replace(obj, **{path[0]: t})
    return dataclasses.replace(
        obj, **{path[0]: with_tensor(getattr(obj, path[0]), path[1:], t)})
