'''
Procedural benchmark scenes.

Reference: ptina_tpu/scenes.py (numpy geometry builders copied, so the
port needs no JAX).  Ported: cornell_box (34 triangles; its arrays in
worker-API form from cornell_box_vertices), cornell_monkey
(966 triangles: a 944-triangle smooth UV sphere stands in for Suzanne),
envlight_scene and matball (2,216 triangles each: a ground quad and a
2,214-triangle sphere), and cornell_highpoly (101,782 triangles at its
defaults: the big scene of the blocked route).  The fixed benchmark
camera is the reference's exams/benchmark.py:18-23 matrix.
'''

import numpy as np

from ptina_tpu_torch.scene import make_scene, LIGHT_AREA, LIGHT_POINT

__all__ = ['BENCH_CAMERA', 'cornell_box', 'cornell_box_vertices',
           'cornell_monkey', 'cornell_highpoly', 'envlight_scene', 'matball']

BENCH_CAMERA = np.array([
    [1.73205081e+00, 0.00000000e+00, 0.00000000e+00, 1.01348227e-02],
    [0.00000000e+00, 1.73205081e+00, -1.73205081e-05, -3.36860025e+00],
    [0.00000000e+00, -1.00020002e-05, -1.00020002e+00, 5.27350023e+00],
    [0.00000000e+00, -1.00000000e-05, -1.00000000e+00, 5.37243564e+00],
])


def _quad(a, b, c, d):
    '''Two triangles for quad a-b-c-d (counter-clockwise).'''
    return [[a, b, c], [a, c, d]]


def _mesh_to_vertices(tris, normals=None, uvs=None):
    '''tris [F, 3, 3] -> [F*3, 8] vertices, flat normals unless given.'''
    tris = np.asarray(tris, np.float32)
    f = tris.shape[0]
    if normals is None:
        n = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
        n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-12)
        normals = np.repeat(n[:, None, :], 3, axis=1)
    if uvs is None:
        uvs = np.zeros((f, 3, 2), np.float32)
    return np.concatenate([tris.reshape(f * 3, 3),
                           np.asarray(normals, np.float32).reshape(f * 3, 3),
                           np.asarray(uvs, np.float32).reshape(f * 3, 2)],
                          axis=1)


def _box_tris(center, size, yaw=0.0):
    '''12 triangles of a box rotated by yaw around +y.'''
    sx, sy, sz = size
    c, s = np.cos(yaw), np.sin(yaw)
    rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    corners = np.array([[x, y, z]
                        for x in (-sx, sx) for y in (-sy, sy)
                        for z in (-sz, sz)])
    corners = corners @ rot.T + np.array(center)
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1),
             (2, 3, 7, 6), (0, 2, 6, 4), (1, 5, 7, 3)]
    tris = []
    for a, b, c_, d in quads:
        tris += _quad(corners[a], corners[b], corners[c_], corners[d])
    return np.asarray(tris, np.float32)


def _cornell_shell():
    '''5 walls (10 tris) + material ids (0 white, 1 red, 2 green).'''
    x0, x1 = -2.0, 2.0
    y0, y1 = 0.0, 4.0
    z0, z1 = -2.0, 2.0
    tris, mtl = [], []

    def wall(quad, m):
        tris.extend(quad)
        mtl.extend([m, m])

    wall(_quad([x0, y0, z1], [x1, y0, z1], [x1, y0, z0], [x0, y0, z0]), 0)
    wall(_quad([x0, y1, z0], [x1, y1, z0], [x1, y1, z1], [x0, y1, z1]), 0)
    wall(_quad([x0, y0, z0], [x1, y0, z0], [x1, y1, z0], [x0, y1, z0]), 0)
    wall(_quad([x0, y0, z1], [x0, y0, z0], [x0, y1, z0], [x0, y1, z1]), 1)
    wall(_quad([x1, y0, z0], [x1, y0, z1], [x1, y1, z1], [x1, y1, z0]), 2)
    return np.asarray(tris, np.float32), mtl


_CORNELL_MATERIALS_SPEC = [
    ((0.725, 0.71, 0.68), 0.8),   # white
    ((0.63, 0.065, 0.05), 0.8),   # red
    ((0.14, 0.45, 0.091), 0.8),   # green
    ((0.85, 0.85, 0.85), 0.15),   # glossy (boxes / blob)
]


def _materials():
    mats = []
    for base, rough in _CORNELL_MATERIALS_SPEC:
        mats.append([
            (np.asarray(base, np.float32), -1),  # basecolor
            (0.0, -1),   # metallic
            (rough, -1),  # roughness
            (0.5, -1),   # specular
            (0.4, -1),   # specularTint
            (0.0, -1),   # subsurface
            (0.0, -1),   # sheen
            (0.4, -1),   # sheenTint
            (0.0, -1),   # clearcoat
            (0.5, -1),   # clearcoatGloss
            (0.0, -1),   # transmission
            (1.45, -1),  # ior
        ])
    return mats


def _ceiling_light(size=0.8, power=12.0):
    # right-handed axes with col2 = the sampling normal (+y), so the hit
    # and sample queries agree about the emitting side
    axes = np.stack([np.array([1.0, 0.0, 0.0]),
                     np.array([0.0, 0.0, -1.0]),
                     np.array([0.0, 1.0, 0.0])], axis=1)
    return dict(color=(power, power, power), pos=(0.0, 3.98, 0.0),
                size=size, type=LIGHT_AREA, axes=axes)


def _shell_uvs(ntris):
    '''Planar per-quad UVs for the cornell shell.'''
    tri_a = np.asarray([[0, 0], [1, 0], [1, 1]], np.float32)
    tri_b = np.asarray([[0, 0], [1, 1], [0, 1]], np.float32)
    return np.tile(np.stack([tri_a, tri_b]), (ntris // 2, 1, 1))


def _cornell_boxes():
    tall = _box_tris((-0.75, 1.2, -0.6), (0.6, 1.2, 0.6), yaw=np.radians(18))
    short = _box_tris((0.75, 0.6, 0.7), (0.6, 0.6, 0.6), yaw=np.radians(-17))
    return tall, short


def cornell_box_vertices():
    '''The cornell-two-boxes geometry in worker-API form: (vertices
    [F*3, 8], mtlids [F], materials list), for worker.load_model /
    load_materials.'''
    shell, mtl = _cornell_shell()
    tall, short = _cornell_boxes()
    mtlids = np.asarray(mtl + [0] * 12 + [0] * 12, np.int32)
    return (_mesh_to_vertices(np.concatenate([shell, tall, short])), mtlids,
            _materials())


def cornell_box(textured_image=None, device='cuda', **kw):
    '''Cornell two-boxes, 34 triangles.  textured_image: optional numpy
    image bound as material 0's basecolor texture, with planar wall UVs.'''
    verts, mtlids, mats = cornell_box_vertices()
    if textured_image is not None:
        shell, _ = _cornell_shell()
        tall, short = _cornell_boxes()
        kw.setdefault('images', [textured_image])
        mats[0][0] = (mats[0][0][0], 0)  # basecolor fac * texture 0
        verts = np.concatenate([
            _mesh_to_vertices(shell, uvs=_shell_uvs(shell.shape[0])),
            _mesh_to_vertices(tall),
            _mesh_to_vertices(short),
        ])
    kw.setdefault('cam_pers', BENCH_CAMERA)
    kw.setdefault('lights', [_ceiling_light()])
    kw.setdefault('world_fac', (0.05, 0.05, 0.05, 1.0))
    return make_scene(verts, mtlids, materials=mats, device=device, **kw)


def _uv_sphere(center, radius, nu=59, nv=9):
    '''UV sphere: 2*nu caps + 2*nu*(nv-2) quad triangles (944 at 59, 9).'''
    cx, cy, cz = center

    def point(iu, iv):
        theta = np.pi * iv / nv
        phi = 2 * np.pi * iu / nu
        return np.array([cx + radius * np.sin(theta) * np.cos(phi),
                         cy + radius * np.cos(theta),
                         cz + radius * np.sin(theta) * np.sin(phi)])

    tris = []
    for iu in range(nu):
        iu1 = (iu + 1) % nu
        tris.append([point(iu, 1), point(iu1, 1), point(0, 0)])
        for iv in range(1, nv - 1):
            a, b = point(iu, iv), point(iu1, iv)
            c, d = point(iu1, iv + 1), point(iu, iv + 1)
            tris += [[a, b, c], [a, c, d]]
        tris.append([point(iu1, nv - 1), point(iu, nv - 1), point(0, nv)])
    return np.asarray(tris, np.float32)


def _sphere_smooth_normals(tris, center):
    n = tris - np.asarray(center)[None, None, :]
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
    return n


def _blob_parts(nu=59, nv=9):
    '''cornell_monkey's geometry (cornell_highpoly's with a finer sphere)
    as three parts, each (vertices [F*3, 8], mtlids [F]): the cornell
    shell, a smooth UV sphere of 2 * nu * (nv - 1) triangles, a box.'''
    shell, mtl = _cornell_shell()
    blob = _uv_sphere((0.0, 1.3, 0.2), 1.0, nu=nu, nv=nv)
    tall = _box_tris((-1.2, 0.45, -0.9), (0.45, 0.45, 0.45),
                     yaw=np.radians(20))
    return [
        (_mesh_to_vertices(shell), np.asarray(mtl, np.int32)),
        (_mesh_to_vertices(blob, normals=_sphere_smooth_normals(
            blob, (0.0, 1.3, 0.2))), np.full(blob.shape[0], 3, np.int32)),
        (_mesh_to_vertices(tall), np.zeros(12, np.int32)),
    ]


def _blob_scene(parts, device, kw):
    verts = np.concatenate([v for v, _ in parts])
    mtlids = np.concatenate([m for _, m in parts])
    kw.setdefault('cam_pers', BENCH_CAMERA)
    kw.setdefault('lights', [_ceiling_light()])
    kw.setdefault('world_fac', (0.05, 0.05, 0.05, 1.0))
    return make_scene(verts, mtlids, materials=_materials(), device=device,
                      **kw)


def cornell_monkey(device='cuda', **kw):
    '''Cornell + a 944-triangle smooth blob + a box = 966 triangles.'''
    return _blob_scene(_blob_parts(), device, kw)


def cornell_highpoly(nu=320, nv=160, device='cuda', **kw):
    '''Cornell + a smooth UV sphere of 2 * nu * (nv - 1) triangles + a box
    (101,782 triangles at the defaults): the big scene.  Above
    MAX_DENSE_FACES it takes the blocked two-level cast, with
    Morton-ordered face blocks (101,888 padded faces in 199 blocks).'''
    return _blob_scene(_blob_parts(nu, nv), device, kw)


def envlight_scene(env_res=(64, 128), device='cuda', **kw):
    '''Glossy sphere + ground under a procedural equirect sky (world_tex
    0) with a bright sun blob, plus a small point light, so both MIS
    strategies carry weight.'''
    h, w = env_res
    ty = np.linspace(0, 1, h, dtype=np.float32)[:, None]
    tx = np.linspace(0, 1, w, dtype=np.float32)[None, :]
    sky = np.stack([0.3 + 0.4 * ty + 0.0 * tx,
                    0.45 + 0.3 * ty + 0.0 * tx,
                    0.7 + 0.25 * ty + 0.0 * tx], axis=-1)
    sun = np.exp(-(((ty - 0.7) / 0.08) ** 2 + ((tx - 0.25) / 0.05) ** 2))
    env = (sky + 18.0 * sun[..., None]).astype(np.float32)

    ground = np.asarray(_quad([-6, 0, 6], [6, 0, 6], [6, 0, -6],
                              [-6, 0, -6]), np.float32)
    ball = _uv_sphere((0.0, 1.0, 0.0), 1.0, nu=48, nv=24)
    verts = np.concatenate([
        _mesh_to_vertices(ground),
        _mesh_to_vertices(ball,
                          normals=_sphere_smooth_normals(ball, (0, 1.0, 0))),
    ])
    mtlids = np.asarray([0, 0] + [3] * ball.shape[0], np.int32)
    kw.setdefault('images', [env])
    kw.setdefault('world_tex', 0)
    kw.setdefault('world_fac', (1.0, 1.0, 1.0, 1.0))
    kw.setdefault('lights', [dict(color=(24, 20, 14), pos=(2.0, 3.0, 2.0),
                                  size=0.4, type=LIGHT_POINT)])
    return make_scene(verts, mtlids, materials=_materials(), device=device,
                      **kw)


def _sphere_uvs(tris, center):
    '''Equirect per-corner UVs from sphere directions (seam triangles
    wrap).'''
    d = tris - np.asarray(center)[None, None, :]
    d /= np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-12)
    u = 0.5 + np.arctan2(d[..., 2], d[..., 0]) / (2 * np.pi)
    v = 0.5 - np.arcsin(np.clip(d[..., 1], -1, 1)) / np.pi
    return np.stack([u, v], axis=-1).astype(np.float32)


def matball(roughness_tex=None, device='cuda', **kw):
    '''Material-preview ball on a ground plane, lit by the default point
    light and the environment.  roughness_tex: optional numpy image bound
    to the ball's roughness (texture 0, spherical UVs).'''
    ground = np.asarray(_quad([-6, 0, 6], [6, 0, 6], [6, 0, -6],
                              [-6, 0, -6]), np.float32)
    ball = _uv_sphere((0.0, 1.0, 0.0), 1.0, nu=48, nv=24)
    uvs = None
    images = None
    mats = _materials()
    if roughness_tex is not None:
        images = [roughness_tex]
        mats[3][2] = (1.0, 0)  # roughness from texture 0
        uvs = _sphere_uvs(ball, (0.0, 1.0, 0.0))
    verts = np.concatenate([
        _mesh_to_vertices(ground),
        _mesh_to_vertices(ball, normals=_sphere_smooth_normals(
            ball, (0.0, 1.0, 0.0)), uvs=uvs),
    ])
    mtlids = np.asarray([0, 0] + [3] * ball.shape[0], np.int32)
    kw.setdefault('world_fac', (0.3, 0.3, 0.35, 1.0))
    kw.setdefault('images', images)
    return make_scene(verts, mtlids, materials=mats, device=device, **kw)
