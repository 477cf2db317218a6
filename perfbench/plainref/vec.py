'''
SoA 3-vectors for the hot path.

Reference: ptina_tpu/utils/vec.py.  `V3` keeps x/y/z as three dense [N]
tensors (structure of arrays), as the reference does, so every vector
operation is elementwise over rays and the parity tests compare the two
packages row to row.  Scalar operands (Python numbers or 0-d tensors)
broadcast over all components.
'''

from __future__ import annotations

import math

import torch

from perfbench.plainref.mathutils import TAU, clamp_min, safe_sqrt

__all__ = ['V3', 'v3', 'vdot', 'vdot_or_zero', 'vnorm', 'vnormalize', 'vcross',
           'vlerp', 'vwhere', 'vavg3', 'vreflect', 'vrefract', 'vtanframe',
           'vspherical', 'vdir2tex']


class V3:
    __slots__ = ('x', 'y', 'z')

    def __init__(self, x, y, z):
        self.x, self.y, self.z = x, y, z

    def __add__(self, o):
        if isinstance(o, V3):
            return V3(self.x + o.x, self.y + o.y, self.z + o.z)
        return V3(self.x + o, self.y + o, self.z + o)

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, V3):
            return V3(self.x - o.x, self.y - o.y, self.z - o.z)
        return V3(self.x - o, self.y - o, self.z - o)

    def __rsub__(self, o):
        return V3(o - self.x, o - self.y, o - self.z)

    def __mul__(self, o):
        if isinstance(o, V3):
            return V3(self.x * o.x, self.y * o.y, self.z * o.z)
        return V3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, V3):
            return V3(self.x / o.x, self.y / o.y, self.z / o.z)
        return V3(self.x / o, self.y / o, self.z / o)

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)

    @classmethod
    def full_like(cls, ref, vals):
        '''Broadcast a constant 3-sequence to the shape of `ref` (a V3).'''
        vx, vy, vz = vals
        return cls(torch.full_like(ref.x, vx), torch.full_like(ref.y, vy),
                   torch.full_like(ref.z, vz))


def v3(x, y, z):
    '''A V3 from three tensors or numbers.'''
    return V3(torch.as_tensor(x), torch.as_tensor(y), torch.as_tensor(z))


def vdot(a: V3, b: V3):
    return a.x * b.x + a.y * b.y + a.z * b.z


def vdot_or_zero(a: V3, b: V3):
    return clamp_min(vdot(a, b), 0.0)


def vnorm(a: V3):
    return safe_sqrt(vdot(a, a))


def vnormalize(a: V3, eps=1e-12):
    inv = 1.0 / clamp_min(vnorm(a), eps)
    return a * inv


def vcross(a: V3, b: V3):
    return V3(a.y * b.z - a.z * b.y,
              a.z * b.x - a.x * b.z,
              a.x * b.y - a.y * b.x)


def vlerp(fac, src, dst):
    return src * (1.0 - fac) + dst * fac


def vwhere(mask, a, b):
    '''Component-wise select; a/b may be V3 or scalars.'''
    ax, ay, az = (a.x, a.y, a.z) if isinstance(a, V3) else (a, a, a)
    bx, by, bz = (b.x, b.y, b.z) if isinstance(b, V3) else (b, b, b)
    return V3(torch.where(mask, ax, bx), torch.where(mask, ay, by),
              torch.where(mask, az, bz))


def vavg3(a: V3):
    return (a.x + a.y + a.z) * (1.0 / 3.0)


def vreflect(i: V3, n: V3):
    '''Mirror i around n (reference: ptina/common.py:247-249).'''
    return i - n * (2.0 * vdot(n, i))


def vrefract(i: V3, n: V3, eta):
    '''Snell refraction.  Returns (has_refract mask, unit direction V3;
    zeros on total internal reflection).'''
    noi = vdot(n, i)
    discr = 1.0 - eta * eta * (1.0 - noi * noi)
    has = discr > 0.0
    t = i * eta - n * (eta * noi + safe_sqrt(discr))
    t = vnormalize(t)
    return has, vwhere(has, t, 0.0)


def vtanframe(nrm: V3, up=(233.0, 666.0, 512.0)):
    '''Tangent frame (tan, bitan) vectors for a unit normal.'''
    upv = V3.full_like(nrm, up)
    bitan = vnormalize(vcross(nrm, upv))
    tan = vcross(bitan, nrm)
    return tan, bitan


def vspherical(h, p):
    '''Direction from cos-elevation h and turn fraction p.'''
    r = safe_sqrt(1.0 - h * h)
    ang = p * TAU
    return V3(r * torch.cos(ang), r * torch.sin(ang), h)


def vdir2tex(d: V3):
    '''Equirectangular direction -> (s, t).'''
    d = vnormalize(d)
    s = torch.atan2(d.z, d.x) / math.pi * 0.5 + 0.5
    t = torch.atan2(d.y, safe_sqrt(d.x * d.x + d.z * d.z)) / math.pi + 0.5
    return s, t
