'''
Integer hashes for pixel decorrelation, and the counter-hashed uniforms
of the MLT proposal streams (hash_uniform).

Reference: ptina_tpu/sampling/__init__.py (wanghash family; reference
ptina/sampling/__init__.py:8-31).  uniform_grid draws with torch.rand
from an explicit torch.Generator where the reference takes a JAX key
(threefry is not reimplemented), as engine/mlt.mlt_init does.

torch has no usable uint32 arithmetic (no wrapping multiply, and `>>` on
int32 is arithmetic), so the hashes compute in int64 and mask every
result back to 32 bits: a product of two values below 2^32 and 2^30 fits
in int64 exactly, and a shift of a non-negative int64 is a logical u32
shift.  Inputs and outputs are int64 tensors holding u32 values.
'''

import torch

__all__ = ['wanghash', 'wanghash2', 'wanghash3', 'hash_uniform',
           'u32_to_unit', 'uniform_grid']

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


def hash_uniform(*ints):
    '''Integers -> float32 uniforms in [0, 1]: a wang-hash chain over the
    arguments (broadcast together), as the reference's: h = wanghash(a0),
    then h = wanghash(h + a_k) for each further argument, each value taken
    mod 2^32 (the reference's cast to uint32, so a signed int32 product
    that wrapped gives the same bits as its exact int64 value here).'''
    h = wanghash(ints[0])
    for x in ints[1:]:
        h = wanghash((h + _u32(x)) & _M32)
    return u32_to_unit(h)


def u32_to_unit(h):
    '''u32 hash -> float32 in [0, 1] exactly as the reference converts
    (round-to-nearest u32 -> f32, times 2^-32).'''
    return h.to(torch.float32) * (1.0 / 4294967296.0)


def uniform_grid(generator, shape, device='cuda'):
    '''Plain pseudo-random float32 uniforms in [0, 1) of `shape` (reference
    RandomSampler, ptina/sampling/random.py): torch.rand from `generator`, a
    torch.Generator on `device` (None: torch's default generator there).'''
    return torch.rand(shape, generator=generator, device=device)
