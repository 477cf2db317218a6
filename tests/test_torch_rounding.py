'''
The port's square root against the correctly rounded one, on the CPU:

  * utils.mathutils.sqrt equals np.sqrt(x.astype(float64)).astype(float32)
    (the IEEE float32 result; jnp.sqrt's too, but for subnormal inputs,
    which XLA's CPU backend flushes to zero) bit for bit
    on 2^16 float32 values from a seed: normal values over the whole
    exponent range and over [0.01, 100], subnormals, and the special
    values (0, -0, negatives, NaN, inf, 1 +- ulp, the largest finite
    float).  torch.sqrt on the CPU is not correctly rounded on every host;
    the parity tests compare f32 results bit for bit or at 1e-5, so one
    ulp in a plane row's norm or a shading root shows there;
  * safe_sqrt keeps its contract: 0, never NaN, where x <= 0 or x is NaN,
    the helper's value elsewhere, and a zero gradient on the zeroed lanes;
  * a source scan of ptina_tpu_torch finds no torch.sqrt, torch.rsqrt,
    .sqrt() / .rsqrt() call or power by 0.5 outside the helper.
'''

import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptina_tpu_torch.utils import mathutils as tm

torch.set_num_threads(2)

N = 1 << 16
PORT = pathlib.Path(__file__).resolve().parent.parent / 'ptina_tpu_torch'
HELPER = ('utils/mathutils.py', 'sqrt')


def _values(kind, seed=0):
    '''N float32 values of one kind, from a seed.'''
    rng = np.random.default_rng(seed)
    if kind == 'normal':  # every positive normal exponent
        bits = rng.integers(0x00800000, 0x7f800000, N, dtype=np.int64)
        return bits.astype(np.uint32).view(np.float32)
    if kind == 'range':  # where the shading and the face tables live
        return rng.uniform(0.01, 100.0, N).astype(np.float32)
    if kind == 'subnormal':
        bits = rng.integers(1, 0x00800000, N, dtype=np.int64)
        return bits.astype(np.uint32).view(np.float32)
    assert kind == 'special'
    one = np.float32(1.0)
    big = np.finfo(np.float32).max
    special = np.array([
        0.0, -0.0, -1.0, -1e-30, -np.inf, np.nan, -np.nan, np.inf, big,
        np.nextafter(big, np.float32(0)), one, np.nextafter(one, np.float32(2)),
        np.nextafter(one, np.float32(0)), np.finfo(np.float32).tiny,
        np.finfo(np.float32).smallest_subnormal, 4.0, 2.0, 0.25,
    ], np.float32)
    rest = rng.standard_normal(N - special.size).astype(np.float32)
    return np.concatenate([special, rest])


def _expected(x):
    with np.errstate(invalid='ignore'):
        return np.sqrt(x.astype(np.float64)).astype(np.float32)


def _same_bits(got, want):
    '''Bit for bit, but for the payload and sign of a NaN.'''
    got, want = np.asarray(got), np.asarray(want)
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan)
    diff = got.view(np.int32)[~nan] != want.view(np.int32)[~nan]
    assert not diff.any(), (
        f'{int(diff.sum())} lanes differ, e.g. x -> {got[~nan][diff][:4]} '
        f'vs {want[~nan][diff][:4]}')


KINDS = ['normal', 'range', 'subnormal', 'special']


@pytest.mark.parametrize('kind', KINDS)
def test_sqrt_correctly_rounded(kind):
    x = _values(kind)
    got = tm.sqrt(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (N,)
    _same_bits(got.numpy(), _expected(x))


@pytest.mark.parametrize('kind', ['range', 'special'])
def test_sqrt_matches_jax(kind):
    '''The reference's jnp.sqrt, on the same values but for subnormal
    inputs: XLA's CPU backend flushes those to zero.'''
    x = _values(kind, seed=1)
    x = x[~((x != 0) & (np.abs(x) < np.finfo(np.float32).tiny))]
    _same_bits(tm.sqrt(torch.from_numpy(x)).numpy(),
               np.asarray(jnp.sqrt(jnp.asarray(x))))


def test_sqrt_keeps_float64():
    '''A float64 tensor stays float64 (correct rounding is promised for
    float32 only: torch's float64 root itself can be 1 ulp off).'''
    x = np.random.default_rng(2).uniform(0.0, 1e6, 4096)
    got = tm.sqrt(torch.from_numpy(x))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.sqrt(x), rtol=4.5e-16, atol=0)


@pytest.mark.parametrize('kind', KINDS)
def test_safe_sqrt_zero_contract(kind):
    x = _values(kind, seed=3)
    got = tm.safe_sqrt(torch.from_numpy(x)).numpy()
    zero = ~(x > 0.0)  # x <= 0 or NaN
    assert not np.isnan(got).any()
    assert np.array_equal(got[zero].view(np.int32),
                          np.zeros(int(zero.sum()), np.int32))
    _same_bits(got[~zero], _expected(x[~zero]))


def test_safe_sqrt_gradient_zero_where_clamped():
    x = torch.tensor([-1.0, -0.0, 0.0, float('nan'), 0.25, 4.0],
                     requires_grad=True)
    tm.safe_sqrt(x).sum().backward()
    assert torch.equal(x.grad, torch.tensor([0.0, 0.0, 0.0, 0.0, 1.0, 0.25]))


def _root(node):
    while isinstance(node, ast.Attribute):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _sqrt_calls(source):
    '''(line, function) of every torch.sqrt / torch.rsqrt (torch.Tensor's
    too), every .sqrt() / .rsqrt() method call (in-place forms too) and
    every power by +-0.5 in source.'''
    names = {'sqrt', 'rsqrt', 'sqrt_', 'rsqrt_'}
    found = []

    def visit(node, func):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            func = node.name
        if isinstance(node, ast.Attribute) and node.attr in names:
            if _root(node) == 'torch':
                found.append((node.lineno, func))
        elif (isinstance(node, ast.Call)
              and isinstance(node.func, ast.Attribute)
              and node.func.attr in names and not node.args):
            found.append((node.lineno, func))  # a tensor's method
        elif isinstance(node, ast.BinOp) and isinstance(node.op, ast.Pow):
            e = node.right
            if isinstance(e, ast.UnaryOp) and isinstance(e.op, ast.USub):
                e = e.operand
            if isinstance(e, ast.Constant) and e.value == 0.5:
                found.append((node.lineno, func))
        for child in ast.iter_child_nodes(node):
            visit(child, func)

    visit(ast.parse(source), None)
    return found


@pytest.mark.parametrize('snippet', [
    'y = torch.sqrt(x)', 'y = torch.rsqrt(x)', 'y = x.sqrt()',
    'y = (a + b).rsqrt()', 'x.sqrt_()', 'f = torch.Tensor.sqrt',
    'y = x ** 0.5', 'y = (a * b) ** -0.5',
])
def test_scan_finds_square_roots(snippet):
    assert _sqrt_calls(snippet) == [(1, None)]
    assert _sqrt_calls('y = np.sqrt(x) + math.sqrt(2.0) + x ** 2\n'
                       'z = mathutils.sqrt(x) + tm.safe_sqrt(x)') == []


def _packages():
    return sorted({p.parent.relative_to(PORT).as_posix()
                   for p in PORT.rglob('*.py')})


@pytest.mark.parametrize('package', _packages())
def test_no_square_root_outside_helper(package):
    stray = []
    for path in sorted((PORT / package).glob('*.py')):
        rel = path.relative_to(PORT).as_posix()
        for line, func in _sqrt_calls(path.read_text()):
            if (rel, func) != HELPER:
                stray.append(f'{rel}:{line} in {func}')
    assert not stray, ('square roots outside mathutils.sqrt: '
                       + ', '.join(stray))
