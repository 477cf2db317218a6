'''
Math commons for the path tracer.

Reference: ptina_tpu/utils/mathutils.py.  Only the scalar-row helpers the
engines use are ported (normaldist: the MLT mutation); the [..., 3] array
helpers of the reference serve its non-SoA code, and the SoA vector
algebra lives in utils/vec.py.

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

__all__ = ['EPS', 'INF', 'PI', 'TAU', 'clamp', 'clamp_min', 'lerp',
           'safe_sqrt', 'normaldist']


def safe_sqrt(x):
    '''sqrt clamped at zero: 0 (never nan) where x <= 0 or x is nan,
    exactly as the reference's double-where form.'''
    m = x > 0.0
    return torch.where(m, torch.sqrt(torch.where(m, x, 1.0)), 0.0)


def clamp_min(x, lo):
    '''jnp.maximum(x, lo) for a constant lo.'''
    return torch.maximum(x, torch.tensor(lo, dtype=x.dtype))


def clamp(x, lo=0.0, hi=1.0):
    '''jnp.clip(x, lo, hi) for constant bounds.'''
    return torch.minimum(clamp_min(x, lo), torch.tensor(hi, dtype=x.dtype))


def lerp(fac, src, dst):
    '''src*(1-fac) + dst*fac (reference: ptina/common.py:269-271).'''
    return src * (1.0 - fac) + dst * fac


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
    wt = torch.sqrt(w) - 3.0
    pt = _ERFINV_TAIL[0]
    for c in _ERFINV_TAIL[1:]:
        pt = pt * wt + c
    return _SQRT2 * (torch.where(w < 5.0, pc, pt) * s)
