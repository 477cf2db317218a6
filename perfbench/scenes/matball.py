'''
The matball scene family, frozen: a copy of the numpy geometry of
ptina_tpu_torch/scenes.py's matball (a ground quad and a smooth UV sphere
of 2,208 triangles with equirect texture coordinates: 2,210 faces, padded
to 2,216; the four Disney materials of cornell_blob, the ball's roughness
bound to texture 0; the default point light; world factor (0.3, 0.3,
0.35, 1)) with the reference's exams/matball.py camera, perspective(fov
45) @ lookat(pos (0, 1, 0), back (2.5, 1.5, 2.5)), and its checker
roughness map (64x64, 8-texel squares of 0.1 and 0.8, grey), so a change
to the program's scenes cannot move the yardstick.

build(config) returns cornell_blob's host inputs and `images`, the
published atlas's one image [64, 64, 3].
'''

import numpy as np

from perfbench.scenes.cornell_blob import (_materials, _mesh_to_vertices,
                                           _quad, _sphere_smooth_normals,
                                           _uv_sphere)

LIGHT_POINT = 1  # ptina_tpu_torch.scene.LIGHT_POINT

# perspective(fov=45) @ lookat(pos=(0, 1, 0), back=(2.5, 1.5, 2.5)),
# ptina_tpu_torch/io/matrix.py's float64 product
MATBALL_CAMERA = np.array([
    [1.7071067811860354e+00, 1.7070889348624582e-12,
     -1.7071067811870604e+00, -1.7046900860646243e-12],
    [-6.6673911831327981e-01, 2.2224637277065620e+00,
     -6.6673911831065724e-01, -2.2224637277065629e+00],
    [-6.5107475683529314e-01, -3.9064485410117594e-01,
     -6.5107475683529314e-01, 4.1319759184293057e+00],
    [-6.5094455490411918e-01, -3.9056673294247157e-01,
     -6.5094455490411918e-01, 4.2311396068767744e+00],
])

CENTER = (0.0, 1.0, 0.0)


def _sphere_uvs(tris, center):
    '''Equirect per-corner UVs from sphere directions (seam triangles
    wrap).'''
    d = tris - np.asarray(center)[None, None, :]
    d /= np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-12)
    u = 0.5 + np.arctan2(d[..., 2], d[..., 0]) / (2 * np.pi)
    v = 0.5 - np.arcsin(np.clip(d[..., 1], -1, 1)) / np.pi
    return np.stack([u, v], axis=-1).astype(np.float32)


def checker(size, square, low, high):
    '''The published roughness map [size, size, 3]: squares of `square`
    texels alternating low / high, grey.'''
    u, v = np.meshgrid(np.arange(size), np.arange(size), indexing='ij')
    on = (((u // square) + (v // square)) % 2).astype(np.float32)
    grey = on * np.float32(high - low) + np.float32(low)
    return np.stack([grey] * 3, axis=-1)


def build(config):
    '''The scene's inputs for a configuration of this family (its keys
    nu, nv: the ball's tessellation; checker: the map's size, square,
    low and high).'''
    ground = np.asarray(_quad([-6, 0, 6], [6, 0, 6], [6, 0, -6],
                              [-6, 0, -6]), np.float32)
    ball = _uv_sphere(CENTER, 1.0, nu=int(config['nu']),
                      nv=int(config['nv']))
    mats = _materials()
    mats[3][2] = (1.0, 0)  # roughness from texture 0
    vertices = np.concatenate([
        _mesh_to_vertices(ground),
        _mesh_to_vertices(ball, normals=_sphere_smooth_normals(ball, CENTER),
                          uvs=_sphere_uvs(ball, CENTER)),
    ])
    mtlids = np.asarray([0, 0] + [3] * ball.shape[0], np.int32)
    c = config['checker']
    return dict(vertices=vertices, mtlids=mtlids, materials=mats,
                lights=[dict(color=(32, 32, 32), pos=(1, 2, 3), size=0.5,
                             type=LIGHT_POINT)],
                cam_pers=MATBALL_CAMERA, world_fac=(0.3, 0.3, 0.35, 1.0),
                images=[checker(int(c['size']), int(c['square']),
                                float(c['low']), float(c['high']))])
