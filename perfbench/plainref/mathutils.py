'''
Math commons for the path tracer.

Reference: ptina_tpu/utils/mathutils.py.  The engines use the scalar-row
helpers (clamp, lerp, safe_sqrt; normaldist: the MLT mutation) and the
SoA vector algebra of utils/vec.py; the reference's [..., 3] helpers
(dot, cross, normalize, frames, spherical maps, reflect / refract) are
here too, on tensors with a trailing component axis, for callers that
hold vectors that way.

clamp and clamp_min are the shading path's jnp.clip and jnp.maximum
against a constant, written as torch.maximum / torch.minimum against a
0-dim host tensor: at a bound their gradient is JAX's, half the incoming
one (a tie splits it between the two operands), where torch.clamp passes
all of it.  Their values are torch.clamp's, NaN included, but for the
sign of a zero result (max(-0, +0) is +0).
'''

import math

import numpy as np
import torch

EPS = 1e-6
INF = 1e6
PI = math.pi
TAU = 2.0 * math.pi

__all__ = [
    'EPS', 'INF', 'PI', 'TAU',
    'clamp', 'clamp_min', 'lerp', 'unlerp', 'smoothstep',
    'dot', 'dot_or_zero', 'norm', 'normalize', 'cross', 'vavg',
    'tanframe', 'tanspace', 'spherical', 'unspherical', 'dir2tex',
    'reflect', 'refract', 'normaldist', 'safe_div', 'safe_sqrt', 'sqrt',
]


def sqrt(x):
    '''The correctly rounded (IEEE) float32 square root, as jnp.sqrt and
    np.sqrt give it; every square root of the port goes through here.
    CUDA's sqrt is IEEE (and the kernels' sqrtf, built without fast math,
    equals it), so a CUDA tensor keeps its dtype.  torch.sqrt on the CPU
    is not correctly rounded on every host (its vectorised path can be
    1 ulp off, in float64 too), so elsewhere the root is taken in float64
    and rounded to the input's dtype.  That is exact for float32: the
    root of a float32 in [2^2e, 2^2e+2) lies at least 2^(e-50) from every
    float32 rounding midpoint (x - m^2 is a nonzero multiple of
    2^(2e-48)), four float64 ulps, so a float64 root within 4 ulps rounds
    to the right float32.'''
    if x.device.type == 'cuda':
        return torch.sqrt(x)
    return torch.sqrt(x.double()).to(x.dtype)


def safe_sqrt(x):
    '''sqrt clamped at zero: 0 (never nan) where x <= 0 or x is nan,
    exactly as the reference's double-where form.'''
    m = x > 0.0
    return torch.where(m, sqrt(torch.where(m, x, 1.0)), 0.0)


def clamp_min(x, lo):
    '''jnp.maximum(x, lo) for a constant lo.'''
    return torch.maximum(x, torch.tensor(lo, dtype=x.dtype))


def clamp(x, lo=0.0, hi=1.0):
    '''jnp.clip(x, lo, hi) for constant bounds.'''
    return torch.minimum(clamp_min(x, lo), torch.tensor(hi, dtype=x.dtype))


def lerp(fac, src, dst):
    '''src*(1-fac) + dst*fac (reference: ptina/common.py:269-271).'''
    return src * (1.0 - fac) + dst * fac



def unlerp(val, src, dst):
    return (val - src) / (dst - src)


def smoothstep(x, a=0.0, b=1.0):
    t = clamp((x - a) / (b - a))
    return t * t * (3.0 - 2.0 * t)


def dot(a, b):
    return torch.sum(a * b, dim=-1)


def dot_or_zero(a, b):
    '''max(0, a.b) (reference: ptina/common.py:178-180).'''
    return clamp_min(dot(a, b), 0.0)


def norm(v):
    return safe_sqrt(torch.sum(v * v, dim=-1))


def normalize(v, eps=1e-12):
    return v / clamp_min(norm(v), eps)[..., None]


def cross(a, b):
    '''[..., 3] cross product, broadcast over the batch axes.'''
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def vavg(v):
    '''Component mean of a vector (reference Vavg, ptina/common.py:73-77).'''
    return torch.mean(v, dim=-1)


def safe_div(a, b, eps=1e-12):
    '''a/b with sign-preserving clamped denominator (never nan/inf).'''
    mag = clamp_min(torch.abs(b), eps)
    return a / torch.where(b < 0, -mag, mag)


def tanframe(nrm, up=(233.0, 666.0, 512.0)):
    '''Tangent frame (tan, bitan) for a [..., 3] normal
    (reference: ptina/common.py:213-217), as two [..., 3] vectors.'''
    up = torch.as_tensor(up, dtype=nrm.dtype, device=nrm.device)
    bitan = normalize(cross(nrm, up.expand(nrm.shape)))
    tan = cross(bitan, nrm)
    return tan, bitan


def tanspace(nrm, up=(233.0, 666.0, 512.0)):
    '''Tangent frame columns [tan, bitan, nrm] as an [..., 3, 3] matrix.'''
    tan, bitan = tanframe(nrm, up)
    return torch.stack([tan, bitan, nrm], dim=-1)


def spherical(h, p):
    '''Direction from cos-elevation h and turn fraction p
    (reference: ptina/common.py:221-225).  h, p: [...] -> [..., 3].'''
    r = safe_sqrt(1.0 - h * h)
    ang = p * TAU
    return torch.stack([r * torch.cos(ang), r * torch.sin(ang), h], dim=-1)


def unspherical(d):
    '''Inverse of spherical (reference: ptina/common.py:228-231).'''
    p = torch.atan2(d[..., 1], d[..., 0]) / TAU
    return d[..., 2], torch.remainder(p, 1.0)


def dir2tex(d):
    '''Equirectangular mapping direction -> (s, t) in [0,1]
    (reference: ptina/common.py:234-239).'''
    d = normalize(d)
    s = torch.atan2(d[..., 2], d[..., 0]) / PI * 0.5 + 0.5
    t = torch.atan2(d[..., 1], norm(d[..., [0, 2]])) / PI + 0.5
    return s, t


def reflect(i, n):
    '''Mirror i around n (reference: ptina/common.py:247-249).'''
    return i - 2.0 * dot(n, i)[..., None] * n


def refract(i, n, eta):
    '''Snell refraction of incident i at normal n with ratio eta.
    Returns (has_refract [...], direction [..., 3])
    (reference: ptina/common.py:252-260).'''
    noi = dot(n, i)
    eta = torch.as_tensor(eta, dtype=i.dtype, device=i.device) \
        .expand(noi.shape)
    discr = 1.0 - eta * eta * (1.0 - noi * noi)
    has = discr > 0.0
    t = eta[..., None] * i - n * (eta * noi + safe_sqrt(discr))[..., None]
    t = normalize(t)
    return has, torch.where(has[..., None], t, torch.zeros_like(t))

_SQRT2 = float(np.sqrt(np.float32(2.0)))
# Giles (2010), "Approximating the erfinv function": the single-precision
# central (w < 5) and tail branches, highest coefficient first
_ERFINV_CENTRAL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                   -4.39150654e-06, 2.1858087e-04, -1.25372503e-03,
                   -4.17768164e-03, 2.46640727e-01, 1.50140941)
_ERFINV_TAIL = (-2.00214257e-04, 1.00950558e-04, 1.34934322e-03,
                -3.67342844e-03, 5.73950773e-03, -7.62246130e-03,
                9.43887047e-03, 1.00167406, 2.83297682)


def normaldist(samp):
    '''Uniform [0, 1) -> standard normal, sqrt(2) erfinv(2 samp - 1), by
    the reference's two-branch single-precision polynomial in its
    operation order (not torch.erfinv).  Exactly odd around samp = 0.5:
    both branches are functions of (1 - s)(1 + s) times s, so an MLT
    proposal stays exactly symmetric.'''
    s = torch.clamp(samp * 2.0 - 1.0, -1.0 + 1e-7, 1.0 - 1e-7)
    w = -torch.log((1.0 - s) * (1.0 + s))
    wc = w - 2.5
    pc = _ERFINV_CENTRAL[0]
    for c in _ERFINV_CENTRAL[1:]:
        pc = pc * wc + c
    wt = sqrt(w) - 3.0
    pt = _ERFINV_TAIL[0]
    for c in _ERFINV_TAIL[1:]:
        pt = pt * wt + c
    return _SQRT2 * (torch.where(w < 5.0, pc, pt) * s)
