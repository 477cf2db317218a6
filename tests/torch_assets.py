'''
Scene assets and worker calls that the port's front-end tests share, on
the CPU (tests/test_torch_io.py, tests/test_torch_blender.py) and on the
card (tests/test_torch_cuda_frontends.py): a glTF 2.0 writer and the
assets it writes (cornell_monkey under a node hierarchy, matball with a
PNG roughness ramp), a PLY writer, readobj's dict for a vertex array, the
worker calls that load a front-end's arrays, and the Blender engine's
scene and final render without bpy.  The card tests share from it the
kernels' launch counters (launches, grew) and the megakernel-against-twin
gate (assert_radiance_close).  Imports nothing of JAX; pytest collects no
test from it.
'''

import base64
import json
import os
import struct
import time

import numpy as np
import torch

from ptina_tpu_torch import mtllib, texture
from ptina_tpu_torch.bench import bench_texture
from ptina_tpu_torch.blender import (PRINCIPLED_SOCKETS, RENDER_PASSES,
                                     light_to_pool_entry,
                                     principled_to_material, sync_worker,
                                     world_background)
from ptina_tpu_torch.engine import fused
from ptina_tpu_torch.intersect import blocked, dense_cast
from ptina_tpu_torch.io import _png as png_codec, matrix as gl_matrix
from ptina_tpu_torch.scenes import (BENCH_CAMERA, _CORNELL_MATERIALS_SPEC,
                                    _blob_parts, _ceiling_light, _materials,
                                    _mesh_to_vertices, _quad,
                                    _sphere_smooth_normals, _sphere_uvs,
                                    _uv_sphere)

_COUNTERS = (dense_cast.LAUNCHES, fused.LAUNCHES, blocked.LAUNCHES,
             mtllib.LAUNCHES, texture.LAUNCHES)


def launches():
    '''Every kernel launch counter of the port in one dict (the counters
    move on the host as each launch is issued).'''
    return {k: v for c in _COUNTERS for k, v in c.items()}


def grew(before):
    '''The counters that moved since launches() returned before, by how
    much.'''
    return {k: v - before[k] for k, v in launches().items() if v != before[k]}


def assert_radiance_close(k, p, relative):
    '''A megakernel's radiance k against its twin's p (V3s), at
    tests/test_fused.py's gates: relative, >= 95% of paths within 2e-2 of
    max(|p|, 0.05) and means within 1e-2; else >= 95% within 1e-3
    absolute and means within 2e-3.'''
    k = torch.stack([k.x, k.y, k.z])
    p = torch.stack([p.x, p.y, p.z])
    assert bool(torch.isfinite(k).all())
    if relative:
        d = ((k - p).abs() / torch.clamp_min(p.abs(), 0.05)).amax(0)
        assert (d < 2e-2).float().mean().item() > 0.95
        assert abs(k.mean().item() - p.mean().item()) \
            < 1e-2 * max(p.mean().item(), 1e-6)
    else:
        d = (k - p).abs().amax(0)
        assert (d < 1e-3).float().mean().item() > 0.95
        assert abs(k.mean().item() - p.mean().item()) \
            < 2e-3 * max(p.mean().item(), 1e-6)


_GL_COMPONENT = {np.dtype(np.float32): 0x1406, np.dtype(np.uint8): 0x1401,
                 np.dtype(np.uint16): 0x1403, np.dtype(np.uint32): 0x1405}
_GL_TYPE = {1: 'SCALAR', 2: 'VEC2', 3: 'VEC3'}


def write_gltf(path, meshes, nodes, materials=(), images=(), mode='gltf'):
    '''Write a glTF 2.0 asset.  meshes: one list of primitive dicts a
    mesh, each with 'position' [V, 3] float32 and optionally 'normal' [V,
    3], 'texcoord' [V, 2], 'indices' [K] (uint8 / 16 / 32), 'material'
    and 'interleave' (the vertex attributes in one byteStride view).
    nodes: glTF node dicts (the roots are the nodes no node lists as a
    child).  materials: glTF material dicts; images: PNG bytes, each one
    texture.  mode: 'gltf' (the buffer as a data URI), 'external' (a
    .bin file beside it) or 'glb'.'''
    blob, views, accessors = bytearray(), [], []

    def view(data, stride=None):
        blob.extend(b'\0' * (-len(blob) % 4))
        views.append({'buffer': 0, 'byteOffset': len(blob),
                      'byteLength': len(data)})
        if stride:
            views[-1]['byteStride'] = stride
        blob.extend(data)
        return len(views) - 1

    def accessor(v, arr, offset=0):
        arr = arr.reshape(arr.shape[0], -1)
        accessors.append({'bufferView': v, 'byteOffset': offset,
                          'componentType': _GL_COMPONENT[arr.dtype],
                          'count': arr.shape[0],
                          'type': _GL_TYPE[arr.shape[1]]})
        return len(accessors) - 1

    gl_meshes = []
    for prims in meshes:
        out = []
        for p in prims:
            cols = [(name, np.ascontiguousarray(p[key], np.float32))
                    for name, key in (('POSITION', 'position'),
                                      ('NORMAL', 'normal'),
                                      ('TEXCOORD_0', 'texcoord'))
                    if p.get(key) is not None]
            attrs = {}
            if p.get('interleave'):
                rows = np.concatenate([a for _, a in cols], axis=1)
                v, off = view(rows.tobytes(), stride=rows.shape[1] * 4), 0
                for name, a in cols:
                    attrs[name] = accessor(v, a, off)
                    off += a.shape[1] * 4
            else:
                for name, a in cols:
                    attrs[name] = accessor(view(a.tobytes()), a)
            pos = accessors[attrs['POSITION']]
            pos['min'] = cols[0][1].min(0).tolist()
            pos['max'] = cols[0][1].max(0).tolist()
            prim = {'attributes': attrs}
            if p.get('indices') is not None:
                idx = np.ascontiguousarray(p['indices'])
                prim['indices'] = accessor(view(idx.tobytes()), idx)
            if p.get('material') is not None:
                prim['material'] = int(p['material'])
            out.append(prim)
        gl_meshes.append({'primitives': out})
    children = {c for n in nodes for c in n.get('children', ())}
    model = {'asset': {'version': '2.0'}, 'scene': 0,
             'scenes': [{'nodes': [i for i in range(len(nodes))
                                   if i not in children]}],
             'nodes': list(nodes), 'meshes': gl_meshes}
    if materials:
        model['materials'] = list(materials)
    if images:
        model['images'] = [{'bufferView': view(png), 'mimeType': 'image/png'}
                           for png in images]
        model['textures'] = [{'source': i} for i in range(len(images))]
    model.update(accessors=accessors, bufferViews=views,
                 buffers=[{'byteLength': len(blob)}])
    if mode == 'glb':
        js = json.dumps(model).encode()
        js += b' ' * (-len(js) % 4)
        blob.extend(b'\0' * (-len(blob) % 4))
        with open(path, 'wb') as f:
            f.write(struct.pack('<III', 0x46546C67, 2,
                                12 + 8 + len(js) + 8 + len(blob)))
            f.write(struct.pack('<II', len(js), 0x4E4F534A) + js)
            f.write(struct.pack('<II', len(blob), 0x004E4942) + bytes(blob))
        return
    if mode == 'external':
        bin_name = os.path.splitext(os.path.basename(path))[0] + '.bin'
        with open(os.path.join(os.path.dirname(path), bin_name), 'wb') as f:
            f.write(blob)
        model['buffers'][0]['uri'] = bin_name
    else:
        model['buffers'][0]['uri'] = ('data:application/octet-stream;base64,'
                                      + base64.b64encode(blob).decode())
    with open(path, 'w') as f:
        json.dump(model, f)


def _node_local(node):
    '''A node's local matrix, as io.readgltf computes it.'''
    if 'matrix' in node:
        return np.asarray(node['matrix'], float).reshape(4, 4).T
    local = gl_matrix.identity()
    if 'scale' in node:
        local = gl_matrix.scale(node['scale']) @ local
    if 'rotation' in node:
        local = gl_matrix.quaternion(node['rotation']) @ local
    if 'translation' in node:
        local = gl_matrix.translate(node['translation']) @ local
    return local


def mesh_worlds(nodes):
    '''[(mesh index, world matrix)] of the node hierarchy in readgltf's
    walk order, each world composed as it composes it (parent @ local).'''
    out = []

    def walk(i, world):
        world = world @ _node_local(nodes[i])
        if 'mesh' in nodes[i]:
            out.append((nodes[i]['mesh'], world))
        for c in nodes[i].get('children', ()):
            walk(c, world)
    children = {c for n in nodes for c in n.get('children', ())}
    for i in range(len(nodes)):
        if i not in children:
            walk(i, gl_matrix.identity())
    return out


def gl_primitives(verts, mtlids, world, index_dtype, interleave=False):
    '''One mesh part ([F*3, 8] vertices in the world, [F] ids) as glTF
    primitives, one a material: positions and normals taken into the
    frame of `world` (a rotation, a uniform scale and a translation), the
    vertex rows deduplicated, indices of `index_dtype`.'''
    lin = world[:3, :3]
    rot = lin / np.cbrt(np.linalg.det(lin))
    pos = np.concatenate([verts[:, :3].astype(np.float64),
                          np.ones((len(verts), 1))], 1) \
        @ np.linalg.inv(world).T
    rows = np.concatenate([pos[:, :3], verts[:, 3:6].astype(np.float64) @ rot,
                           verts[:, 6:8]], 1).astype(np.float32)
    prims = []
    for m in dict.fromkeys(mtlids.tolist()):
        corners = rows.reshape(-1, 3, 8)[mtlids == m].reshape(-1, 8)
        uniq, idx = np.unique(corners, axis=0, return_inverse=True)
        prims.append(dict(position=uniq[:, :3], normal=uniq[:, 3:6],
                          texcoord=uniq[:, 6:8],
                          indices=idx.reshape(-1).astype(index_dtype),
                          material=m, interleave=interleave))
    return prims


def composed_inputs(meshes, nodes):
    '''The (p, n, t, world, mtlid) primitives readgltf hands
    compose_multiple_meshes for the asset, in its walk order.'''
    out = []
    for mi, world in mesh_worlds(nodes):
        for p in meshes[mi]:
            f = p['indices'].astype(np.int64)
            t = p.get('texcoord')
            out.append((p['position'][f].reshape(-1, 3, 3),
                        p['normal'][f].reshape(-1, 3, 3),
                        None if t is None else t[f].reshape(-1, 3, 2),
                        world, p['material']))
    return out


def _quat(axis, deg):
    axis = np.asarray(axis, float) / np.linalg.norm(axis)
    h = np.radians(deg) / 2
    return [*(axis * np.sin(h)).tolist(), float(np.cos(h))]


def gl_materials(mats):
    '''glTF pbrMetallicRoughness of the port's cornell materials (base
    color, metallic and roughness factors), and the worker's materials
    that readgltf returns for them.'''
    gl, ours = [], []
    for mat in mats:
        base = [*np.asarray(mat[0][0], np.float64).tolist(), 1.0]
        gl.append({'pbrMetallicRoughness': {
            'baseColorFactor': base, 'metallicFactor': float(mat[1][0]),
            'roughnessFactor': float(mat[2][0])}})
        ours.append(((base, -1), (float(mat[1][0]), -1),
                     (float(mat[2][0]), -1)))
    return gl, ours


def monkey_asset():
    '''cornell_monkey as a glTF asset: the shell (three primitives, one a
    material, uint16 indices) under a TRS root, the blob (interleaved,
    one byteStride view, uint32 indices) under a `matrix` child, the box
    under a TRS grandchild.  Returns (meshes, nodes, gl materials, the
    worker's materials).'''
    nodes = [
        {'translation': [0.25, -0.5, 0.125], 'rotation': _quat((0, 1, 0), 30),
         'scale': [1.25, 1.25, 1.25], 'children': [1, 2]},
        {'mesh': 0},
        {'matrix': (gl_matrix.translate((0.0, 0.5, 0.0))
                    @ gl_matrix.quaternion(_quat((1, 0, 0), 10))).T
         .reshape(-1).tolist(), 'mesh': 1, 'children': [3]},
        {'translation': [-0.5, 0.0, 0.25], 'mesh': 2},
    ]
    worlds = dict(mesh_worlds(nodes))
    (shell, ms), (blob, mb), (box, mx) = _blob_parts()
    meshes = [gl_primitives(shell, ms, worlds[0], np.uint16),
              gl_primitives(blob, mb, worlds[1], np.uint32, interleave=True),
              gl_primitives(box, mx, worlds[2], np.uint16)]
    gl, ours = gl_materials(_materials())
    return meshes, nodes, gl, ours


def ramp_png():
    '''The benchmark's 64x64 grey ramp (bench_texture) as 8-bit RGB, in
    the film's axis order, and its PNG (rows are the second axis, as
    glTF images are stored and readgltf swaps them back).'''
    ramp = np.round(bench_texture() * 255).astype(np.uint8)
    return ramp, png_codec.encode(np.ascontiguousarray(ramp.swapaxes(0, 1)))


def matball_asset(png):
    '''scenes.matball with its roughness ramp: the ground quad and the
    2,214-triangle sphere (spherical UVs) under one node, the ramp an
    embedded PNG bound as the ball's metallicRoughness texture (metallic
    factor 0, roughness factor 1).'''
    ground = np.asarray(_quad([-6, 0, 6], [6, 0, 6], [6, 0, -6], [-6, 0, -6]),
                        np.float32)
    ball = _uv_sphere((0.0, 1.0, 0.0), 1.0, nu=48, nv=24)
    verts = np.concatenate([
        _mesh_to_vertices(ground),
        _mesh_to_vertices(ball, normals=_sphere_smooth_normals(
            ball, (0.0, 1.0, 0.0)), uvs=_sphere_uvs(ball, (0.0, 1.0, 0.0)))])
    mtlids = np.asarray([0, 0] + [1] * ball.shape[0], np.int32)
    mats = _materials()
    gl, ours = gl_materials([mats[0], mats[3]])
    gl[1]['pbrMetallicRoughness'].update(
        metallicFactor=0.0, roughnessFactor=1.0,
        metallicRoughnessTexture={'index': 0})
    ours[1] = (ours[1][0], (0.0, 0), (1.0, 0))
    meshes = [gl_primitives(verts, mtlids, np.eye(4), np.uint16)]
    return meshes, [{'mesh': 0}], gl, ours, [png]


def write_ply(path, v, faces, binary):
    '''A PLY of vertex positions [V, 3] float32 and triangles [F, 3]:
    binary little-endian or ASCII, faces as uchar-counted int lists.'''
    head = (f'ply\nformat {"binary_little_endian" if binary else "ascii"} '
            f'1.0\ncomment torch_assets\nelement vertex {len(v)}\n'
            f'property float x\nproperty float y\nproperty float z\n'
            f'element face {len(faces)}\n'
            f'property list uchar int vertex_indices\nend_header\n')
    with open(path, 'wb') as f:
        f.write(head.encode())
        if binary:
            rec = np.zeros(len(faces), [('n', 'u1'), ('i', '<i4', 3)])
            rec['n'], rec['i'] = 3, faces
            f.write(np.ascontiguousarray(v, '<f4').tobytes() + rec.tobytes())
        else:
            f.write(''.join(f'{x} {y} {z}\n' for x, y, z in v).encode())
            f.write(''.join(f'3 {a} {b} {c}\n' for a, b, c in faces).encode())


def obj_of_vertices(verts, mtlids):
    '''readobj's dict for [F*3, 8] vertices: one v / vt / vn row a corner,
    usemtl runs named m<id>.'''
    n = len(verts)
    f = np.repeat(np.arange(n, dtype=np.int32).reshape(-1, 3, 1), 3, axis=2)
    runs = [(i, f'm{m}') for i, m in enumerate(mtlids.tolist())
            if i == 0 or m != mtlids[i - 1]]
    return dict(v=verts[:, :3], vt=verts[:, 6:8], vn=verts[:, 3:6], f=f,
                usemtl=runs, mtllib=None)


def load_worker(w, verts, mtlids, mats, images=(), res=512):
    '''The worker calls of a front-end: model, materials, images, the
    benchmark's ceiling light and world, res^2, the camera, then
    build_tree.  Returns build_tree's seconds (make_scene).'''
    w.load_model(verts, mtlids)
    w.load_materials(mats)
    w.load_images(list(images))
    w.clear_lights()
    light = _ceiling_light()
    world = np.eye(4)
    world[:3, :3], world[:3, 3] = light['axes'], light['pos']
    w.add_light(world, light['color'], light['size'], 'AREA')
    w.set_world_light((0.05, 0.05, 0.05, 1.0), -1)
    w.set_size(res, res)
    w.set_camera(BENCH_CAMERA)
    t0 = time.perf_counter()
    w.build_tree()
    return time.perf_counter() - t0


def _ceiling_lamp():
    '''The benchmark's ceiling light as a Blender AREA lamp: (world,
    color, energy in watts, size).  light_to_pool_entry takes half the
    size and gives L = P / (4 pi s^2), the benchmark's radiance.'''
    light = _ceiling_light()
    world = np.eye(4)
    world[:3, :3], world[:3, 3] = light['axes'], light['pos']
    half = light['size']
    return world, (1.0, 1.0, 1.0), \
        light['color'][0] * 4.0 * np.pi * half ** 2, 2.0 * half


# the Principled socket values of the Blender scene's two materials
BLENDER_MATERIALS = {
    name: dict(zip(PRINCIPLED_SOCKETS, ((*base, 1.0), 0.0, rough, 0.5, 0.4,
                                        0.0, 0.0, 0.4, 0.0, 0.5, 0.0, 1.45)))
    for name, (base, rough) in (('white', _CORNELL_MATERIALS_SPEC[0]),
                                ('glossy', _CORNELL_MATERIALS_SPEC[3]))}


def blender_objects(nu=59, nv=9):
    '''The Blender checks' two mesh objects, each (name, [F*3, 8]
    vertices in its own frame, world, material name): the room (the
    cornell shell and the box, identity world) and the blob (a smooth
    sphere of 2 * nu * (nv - 1) triangles, its world a translation).'''
    (sv, _), (bv, _), (xv, _) = _blob_parts(nu, nv)
    world = gl_matrix.translate((0.0, 1.3, 0.2))
    blob = bv.copy()
    blob[:, :3] -= np.float32([0.0, 1.3, 0.2])
    return [('Room', np.concatenate([sv, xv]), np.eye(4), 'white'),
            ('Blob', blob, world, 'glossy')]


def blender_scene(nu=59, nv=9):
    '''sync_worker's arguments for the Blender checks' scene, through the
    engine's helpers: the two materials (principled_to_material), no
    image, the two objects, a background (world_background) and the
    ceiling lamp (light_to_pool_entry).'''
    names = list(BLENDER_MATERIALS)
    meshes = [(v[:, 0:3].reshape(-1, 3, 3), v[:, 3:6].reshape(-1, 3, 3),
               v[:, 6:8].reshape(-1, 3, 2), world, names.index(m))
              for _, v, world, m in blender_objects(nu, nv)]
    world, color, energy, size = _ceiling_lamp()
    return ([principled_to_material(BLENDER_MATERIALS[n]) for n in names],
            [], meshes, world_background((0.05, 0.05, 0.05, 1.0), 1.0),
            [light_to_pool_entry(world, color, energy, 'AREA', size / 2)])


def final_render(w, sync, res=512, spp=32):
    '''The engine's final render on worker `w` (the module or a
    DaemonModule over it): init, sync_worker, res^2, the camera, spp x
    render() with render_preview() after the first, then every
    RENDER_PASSES image.  Returns (passes, samples/s).'''
    w.init()
    sync_worker(w, *sync)
    w.set_size(res, res)
    w.set_camera(BENCH_CAMERA)
    w.synchronize()
    t0 = time.perf_counter()
    for s in range(spp):
        w.render()
        if s == 0:
            w.render_preview()
    w.synchronize()
    sps = spp / (time.perf_counter() - t0)
    return [w.get_image(pid) for pid in range(len(RENDER_PASSES))], sps
