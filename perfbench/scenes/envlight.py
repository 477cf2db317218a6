'''
The envlight scene family, frozen: a copy of ptina_tpu_torch/scenes.py's
envlight_scene (a ground quad and a smooth glossy UV sphere of 2,208
triangles: 2,210 faces, padded to 2,216; the four Disney materials of
cornell_blob, the ball the glossy one at roughness 0.15; its point light;
world factor (1, 1, 1, 1) on texture 0, the equirect sky and sun) with
that scene's default camera, ortho() @ lookat() (an orthographic view of
[-1, 1]^2 from (0, 0, 3) toward the origin), and its sky-and-sun formula
evaluated at the configuration's size, so a change to the program's
scenes cannot move the cell.

build(config) returns cornell_blob's host inputs, `images` (the atlas's
one image, the environment [rows, cols, 3]) and `world_tex` 0.
'''

import numpy as np

from perfbench.scenes.cornell_blob import (_materials, _mesh_to_vertices,
                                           _quad, _sphere_smooth_normals,
                                           _uv_sphere)

LIGHT_POINT = 1  # ptina_tpu_torch.scene.LIGHT_POINT

# ortho() @ lookat(), ptina_tpu_torch/io/matrix.py's float64 product
ENVLIGHT_CAMERA = np.array([
    [1.0, 0.0, 0.0, 0.0],
    [0.0, 1.0, 0.0, 0.0],
    [0.0, 0.0, -0.01, 0.03],
    [0.0, 0.0, 0.0, 1.0],
])

CENTER = (0.0, 1.0, 0.0)


def sky(rows, cols):
    '''The environment [rows, cols, 3] float32: envlight_scene's sky, a
    vertical blue gradient, plus 18 x a Gaussian sun at (0.7, 0.25) of
    the map (peak ~19).'''
    ty = np.linspace(0, 1, rows, dtype=np.float32)[:, None]
    tx = np.linspace(0, 1, cols, dtype=np.float32)[None, :]
    base = np.stack([0.3 + 0.4 * ty + 0.0 * tx,
                     0.45 + 0.3 * ty + 0.0 * tx,
                     0.7 + 0.25 * ty + 0.0 * tx], axis=-1)
    sun = np.exp(-(((ty - 0.7) / 0.08) ** 2 + ((tx - 0.25) / 0.05) ** 2))
    return (base + 18.0 * sun[..., None]).astype(np.float32)


def build(config):
    '''The scene's inputs for a configuration of this family (its keys
    nu, nv: the ball's tessellation; environment: the map's rows and
    cols).'''
    ground = np.asarray(_quad([-6, 0, 6], [6, 0, 6], [6, 0, -6],
                              [-6, 0, -6]), np.float32)
    ball = _uv_sphere(CENTER, 1.0, nu=int(config['nu']),
                      nv=int(config['nv']))
    vertices = np.concatenate([
        _mesh_to_vertices(ground),
        _mesh_to_vertices(ball, normals=_sphere_smooth_normals(ball,
                                                               CENTER)),
    ])
    mtlids = np.asarray([0, 0] + [3] * ball.shape[0], np.int32)
    env = config['environment']
    return dict(vertices=vertices, mtlids=mtlids, materials=_materials(),
                lights=[dict(color=(24, 20, 14), pos=(2.0, 3.0, 2.0),
                             size=0.4, type=LIGHT_POINT)],
                cam_pers=ENVLIGHT_CAMERA, world_fac=(1.0, 1.0, 1.0, 1.0),
                images=[sky(int(env['rows']), int(env['cols']))],
                world_tex=0)
