'''
The material fetch's backward on the CPU (ptina_tpu_torch/mtllib.py:
MaterialRows, material_rows_backward and its plain twin).  The kernel,
csrc/material_rows.cu, runs only on the card
(tests/test_torch_cuda_material_rows.py); here:

  * the plain twin (the gathers' own index_put_ with accumulate, placed
    in the factors' gradient) equals autograd's backward of the two
    gathers bit for bit, on integer-valued and on random cotangents;
  * MaterialRows on CPU tensors: the gathers' values bit for bit, the
    backward the plain twin's;
  * fetch_material through MaterialRows on the CPU, under
    torch.no_grad(), with factors that need no grad, and with grad: the
    plain fetch's values bit for bit, no graph where nothing needs grad,
    and autograd's gradient of the plain gathers bit for bit; no library
    built and no launch.
'''

import numpy as np
import pytest
import torch

from ptina_tpu_torch import mtllib
from ptina_tpu_torch.mtllib import (MaterialRows, fetch_material,
                                    material_rows_backward,
                                    material_rows_backward_plain)
from ptina_tpu_torch.scenes import cornell_box

PATTERNS = ('one_row', 'uniform', 'defaults')


@pytest.fixture
def one_thread():
    '''One intra-op thread: PyTorch's CPU index_put_ with accumulate splits
    rows of several columns over its threads, so only one thread sums each
    row in lane order, as index_put_ and the kernel do on the card.'''
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


def _rows(pattern, n, m1, rng):
    '''[n] int64 rows: every lane in row min(1, m1 - 1) ("one_row", the
    case that serialised PyTorch's kernel), uniform over the rows, or all
    in the defaults row (m1 - 1).'''
    if pattern == 'one_row':
        return torch.full((n,), min(1, m1 - 1), dtype=torch.int64)
    if pattern == 'defaults':
        return torch.full((n,), m1 - 1, dtype=torch.int64)
    return torch.from_numpy(rng.randint(0, m1, n).astype(np.int64))


def _cotangents(n, rng, integer):
    if integer:
        gb, gs = rng.randint(-8, 9, (n, 3)), rng.randint(-8, 9, (n, 12))
    else:
        gb, gs = rng.standard_normal((n, 3)), rng.standard_normal((n, 12))
    return (torch.from_numpy(gb.astype(np.float32)),
            torch.from_numpy(gs.astype(np.float32)))


def _gather_grad(row, gb, gs, m1, rng):
    '''Autograd's gradient of fac through fetch_material's two gathers.'''
    fac = torch.from_numpy(rng.uniform(0, 1, (m1, 12, 4)).astype(
        np.float32)).requires_grad_(True)
    base, scal = fac[:, 0, 0:3][row], fac[:, :, 0][row]
    return torch.autograd.grad((base, scal), fac, (gb, gs))[0]


@pytest.mark.parametrize('integer', [True, False],
                         ids=['integer', 'random'])
@pytest.mark.parametrize('pattern', PATTERNS)
@pytest.mark.parametrize('n', [1, 257, 4096])
@pytest.mark.parametrize('m1', [1, 5, 300])
def test_plain_twin_equals_index_put(m1, n, pattern, integer, one_thread):
    """Bit for bit, on integer-valued cotangents (whose sums are exact in
    any order) and on random ones, and equal to float32 sums from 0 in
    lane order; only the entries the gathers read are nonzero."""
    rng = np.random.RandomState(m1 * 7 + n + integer)
    row = _rows(pattern, n, m1, rng)
    gb, gs = _cotangents(n, rng, integer)
    want = _gather_grad(row, gb, gs, m1, rng)
    got = material_rows_backward_plain(row, gb, gs, m1)
    assert got.dtype == torch.float32 and got.shape == (m1, 12, 4)
    assert torch.equal(got, want)
    if n <= 257:
        sums = torch.zeros((m1, 15))
        for i in range(n):
            sums[row[i]] += torch.cat([gb[i], gs[i]])
        assert torch.equal(got[:, :, 0], sums[:, 3:] + torch.nn.functional
                           .pad(sums[:, :1], (0, 11)))
        assert torch.equal(got[:, 0, 1:3], sums[:, 1:3])
    touched = torch.zeros(12, 4, dtype=torch.bool)
    touched[:, 0] = True
    touched[0, :3] = True
    assert (got[:, ~touched] == 0).all()
    assert got.abs().max() > 0 or not (gb.any() or gs.any())


@pytest.mark.parametrize('m1', [1, 5, 300])
def test_material_rows_on_the_cpu(m1, one_thread):
    '''MaterialRows.apply: the plain gathers' values bit for bit; its
    backward (material_rows_backward, the plain twin on CPU tensors)
    equals the twin's.'''
    n = 1000
    rng = np.random.RandomState(m1)
    row = _rows('uniform', n, m1, rng)
    fac = torch.from_numpy(rng.uniform(0, 1, (m1, 12, 4)).astype(
        np.float32)).requires_grad_(True)
    base, scal = MaterialRows.apply(fac, row)
    assert torch.equal(base, fac[:, 0, 0:3][row])
    assert torch.equal(scal, fac[:, :, 0][row])
    assert base.grad_fn.name() == 'MaterialRowsBackward'
    gb, gs = _cotangents(n, rng, integer=False)
    got = torch.autograd.grad((base, scal), fac, (gb, gs))[0]
    assert torch.equal(got, material_rows_backward_plain(row, gb, gs, m1))
    assert torch.equal(got, material_rows_backward(row, gb, gs, m1))


def _graph(t):
    '''Names of the autograd nodes behind t.'''
    seen, names, stack = set(), set(), [t.grad_fn]
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.add(fn.name())
        stack.extend(f for f, _ in fn.next_functions)
    return names


def _parts(v):
    '''A fetched value's tensors: a V3's three rows, or the tensor.'''
    return (v,) if isinstance(v, torch.Tensor) else (v.x, v.y, v.z)


def _fetch_inputs(n=512, seed=3):
    scene = cornell_box(device='cpu')
    rng = np.random.RandomState(seed)
    m1 = scene.materials.fac.shape[0]
    mtlid = torch.from_numpy(rng.randint(-1, m1 + 1, n).astype(np.int32))
    st = torch.from_numpy(rng.uniform(0, 1, (2, n)).astype(np.float32))
    return scene, mtlid, st[0], st[1]


def _leaf(scene):
    from ptina_tpu_torch.scene import with_tensor
    fac = scene.materials.fac.detach().clone().requires_grad_(True)
    return with_tensor(scene, ('materials', 'fac'), fac), fac


def _plain_gathers(fac, row):
    return fac[:, 0, 0:3][row], fac[:, :, 0][row]


@pytest.mark.parametrize('case', ['no_grad', 'fac_without_grad',
                                  'cpu_with_grad'])
def test_fetch_material_keeps_plain_indexing(case, monkeypatch, one_thread):
    '''On the CPU, under no_grad, or with factors that need no grad, the
    fetch through MaterialRows gives the plain gathers' values bit for
    bit and records no graph; with grad on the CPU its gradient is
    autograd's through the plain gathers, bit for bit.'''
    scene, mtlid, s, t = _fetch_inputs()

    def fetch(sc):
        return fetch_material(sc, mtlid, s, t)

    def loss(out):
        return (out['roughness'] * s).sum() + (out['basecolor'].x * t).sum()
    with monkeypatch.context() as m:
        m.setattr(MaterialRows, 'apply', _plain_gathers)
        want = fetch(scene)
        sc, fac = _leaf(scene)
        want_g, = torch.autograd.grad(loss(fetch(sc)), fac)
    if case == 'no_grad':
        sc, _ = _leaf(scene)
        with torch.no_grad():
            got = fetch(sc)
    elif case == 'fac_without_grad':
        got = fetch(scene)
    else:
        sc, fac = _leaf(scene)
        got = fetch(sc)
    assert set(got) == set(want)
    for k in want:
        for u, v in zip(_parts(want[k]), _parts(got[k])):
            assert torch.equal(u, v.detach()), k
    rough = got['roughness']
    if case == 'cpu_with_grad':
        assert 'MaterialRowsBackward' in _graph(rough)
        g, = torch.autograd.grad(loss(got), fac)
        assert torch.equal(g, want_g)
        assert g[:, 2, 0].abs().sum().item() > 0
    else:
        assert rough.grad_fn is None and not rough.requires_grad


def test_cpu_fetch_builds_no_library(monkeypatch):
    '''A gradient through the fetch on the CPU neither builds nor
    launches the kernel.'''
    def no_build():
        raise AssertionError('the CPU backward built the kernel library')
    monkeypatch.setattr(mtllib, 'build_library', no_build)
    before = dict(mtllib.LAUNCHES)
    scene, mtlid, s, t = _fetch_inputs()
    sc, fac = _leaf(scene)
    out = fetch_material(sc, mtlid, s, t)
    g, = torch.autograd.grad(out['roughness'].sum()
                             + out['basecolor'].x.sum(), fac)
    assert mtllib.LAUNCHES == before
    assert g.abs().sum().item() > 0
