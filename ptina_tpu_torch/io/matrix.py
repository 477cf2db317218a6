'''
Reference: ptina_tpu/io/matrix.py (copied: numpy-only host code, so the port needs no
JAX to run it).

Host-side 4x4 camera/transform matrix builders (numpy only).

Same conventions as the reference's OpenGL-style matrices
(reference: ptina/tools/matrix.py:19-101): clip space is [-1, 1]^3 with
z = -1 the near plane, cameras look down -z in view space.
'''

import numpy as np

__all__ = ['identity', 'affine', 'lookat', 'ortho', 'frustum', 'orthogonal',
           'perspective', 'scale', 'translate', 'quaternion', 'euler_xyz']


def identity():
    return np.eye(4)


def affine(lin, pos):
    '''Assemble a 4x4 from a 3x3 linear part and a translation.'''
    m = np.eye(4)
    m[:3, :3] = lin
    m[:3, 3] = pos
    return m


def lookat(pos=(0, 0, 0), back=(0, 0, 3), up=(0, 1, 1e-12)):
    '''World->view for a camera at pos+back looking toward pos
    (reference defaults, ptina/tools/matrix.py:19-31).'''
    pos = np.asarray(pos, float)
    back = np.asarray(back, float)
    up = np.asarray(up, float)
    fwd = -back / np.linalg.norm(back)
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    up = np.cross(right, fwd)
    cam2world = affine(np.stack([right, up, -fwd], axis=1), pos + back)
    return np.linalg.inv(cam2world)


def ortho(left=-1, right=1, bottom=-1, top=1, near=-100, far=100):
    m = np.eye(4)
    m[0, 0] = 2 / (right - left)
    m[1, 1] = 2 / (top - bottom)
    m[2, 2] = -2 / (far - near)
    m[0, 3] = -(right + left) / (right - left)
    m[1, 3] = -(top + bottom) / (top - bottom)
    m[2, 3] = -(far + near) / (far - near)
    return m


def frustum(left=-1, right=1, bottom=-1, top=1, near=1, far=100):
    m = np.zeros((4, 4))
    m[0, 0] = 2 * near / (right - left)
    m[1, 1] = 2 * near / (top - bottom)
    m[0, 2] = (right + left) / (right - left)
    m[1, 2] = (top + bottom) / (top - bottom)
    m[2, 2] = -(far + near) / (far - near)
    m[2, 3] = -2 * far * near / (far - near)
    m[3, 2] = -1
    return m


def orthogonal(size=1, aspect=1, near=-100, far=100):
    return ortho(-size * aspect, size * aspect, -size, size, near, far)


def perspective(fov=60, aspect=1, near=0.05, far=500):
    half = np.tan(np.radians(fov) / 2)
    ax, ay = half * aspect, half
    return frustum(-near * ax, near * ax, -near * ay, near * ay, near, far)


def scale(factor):
    return affine(np.eye(3) * np.asarray(factor), np.zeros(3))


def translate(offset):
    return affine(np.eye(3), np.asarray(offset) * np.ones(3))


def quaternion(q):
    '''Rotation from quaternion (x, y, z, w).'''
    x, y, z, w = q
    r = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (w * y + x * z)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])
    return affine(r, np.zeros(3))


def euler_xyz(theta):
    '''Rotation from XYZ euler angles (applied x, then y, then z).'''
    cx, sx = np.cos(theta[0]), np.sin(theta[0])
    cy, sy = np.cos(theta[1]), np.sin(theta[1])
    cz, sz = np.cos(theta[2]), np.sin(theta[2])
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return affine(rz @ ry @ rx, np.zeros(3))
