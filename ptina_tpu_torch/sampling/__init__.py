'''
Integer hashes for pixel decorrelation.

Reference: ptina_tpu/sampling/__init__.py (wanghash family; reference
ptina/sampling/__init__.py:8-31).

torch has no usable uint32 arithmetic (no wrapping multiply, and `>>` on
int32 is arithmetic), so the hashes compute in int64 and mask every
result back to 32 bits: a product of two values below 2^32 and 2^30 fits
in int64 exactly, and a shift of a non-negative int64 is a logical u32
shift.  Inputs and outputs are int64 tensors holding u32 values.
'''

import torch

__all__ = ['wanghash', 'wanghash2', 'wanghash3', 'u32_to_unit']

_M32 = 0xFFFFFFFF


def _u32(x):
    return torch.as_tensor(x).to(torch.int64) & _M32


def wanghash(x):
    '''Wang integer hash on u32 values held in int64.'''
    x = _u32(x)
    x = (x ^ 61) ^ (x >> 16)
    x = (x * 9) & _M32
    x = x ^ (x >> 4)
    x = (x * 0x27d4eb2d) & _M32
    x = x ^ (x >> 15)
    return x


def wanghash2(i, j):
    return wanghash((wanghash(i) + _u32(j)) & _M32)


def wanghash3(i, j, k):
    return wanghash((wanghash2(i, j) + _u32(k)) & _M32)


def u32_to_unit(h):
    '''u32 hash -> float32 in [0, 1] exactly as the reference converts
    (round-to-nearest u32 -> f32, times 2^-32).'''
    return h.to(torch.float32) * (1.0 / 4294967296.0)
