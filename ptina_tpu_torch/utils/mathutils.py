'''
Math commons for the path tracer.

Reference: ptina_tpu/utils/mathutils.py.  Only the scalar-row helpers the
wavefront slice uses are ported; the [..., 3] array helpers of the
reference serve its non-SoA code, and the SoA vector algebra lives in
utils/vec.py.
'''

import math

import torch

EPS = 1e-6
INF = 1e6
PI = math.pi
TAU = 2.0 * math.pi

__all__ = ['EPS', 'INF', 'PI', 'TAU', 'clamp', 'lerp', 'safe_sqrt']


def safe_sqrt(x):
    '''sqrt clamped at zero: 0 (never nan) where x <= 0 or x is nan,
    exactly as the reference's double-where form.'''
    m = x > 0.0
    return torch.where(m, torch.sqrt(torch.where(m, x, 1.0)), 0.0)


def clamp(x, lo=0.0, hi=1.0):
    return torch.clamp(x, lo, hi)


def lerp(fac, src, dst):
    '''src*(1-fac) + dst*fac (reference: ptina/common.py:269-271).'''
    return src * (1.0 - fac) + dst * fac
