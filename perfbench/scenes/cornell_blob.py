'''
The cornell_blob scene family, frozen: a copy of the numpy geometry of
ptina_tpu_torch/scenes.py (_blob_parts: the Cornell shell, a smooth UV
sphere of 2 * nu * (nv - 1) triangles, a box; _materials, the ceiling
area light and BENCH_CAMERA, the reference's exams/benchmark.py:18-23
matrix), so a change to the program's scenes cannot move the yardstick.

build(config) returns the host inputs that the harness hands to both the
program's scene build and the plain reference's: vertices [F*3, 8],
material ids [F], the materials' 12-tuples, the light dicts, the camera's
world -> clip matrix and the world factor.
'''

import numpy as np

LIGHT_AREA = 2  # ptina_tpu_torch.scene.LIGHT_AREA

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


def build(config):
    '''The scene's inputs for a configuration of this family (its keys
    nu, nv: the blob's tessellation).'''
    parts = _blob_parts(int(config['nu']), int(config['nv']))
    return dict(vertices=np.concatenate([v for v, _ in parts]),
                mtlids=np.concatenate([m for _, m in parts]),
                materials=_materials(), lights=[_ceiling_light()],
                cam_pers=BENCH_CAMERA, world_fac=(0.05, 0.05, 0.05, 1.0))
