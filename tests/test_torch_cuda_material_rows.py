'''
The material fetch's backward kernel on the card (csrc/material_rows.cu,
ptina_tpu_torch/mtllib.py: material_rows_backward, MaterialRows).
Marked `cuda`: each test skips where torch.cuda.is_available() is false
(the CPU-only test run).  On a machine with the card:

    python -m pytest tests/test_torch_cuda_material_rows.py -q -m cuda --noconftest

  * the kernel against its plain twin (material_rows_backward_plain, the
    gathers' own index_put_ backward): bit for bit, for M+1 in {1, 5, 300,
    4000} rows (4000: 500 blocks of 8 rows), N in {1, 257, 262,144}
    lanes, rows all one, uniform, or all the defaults row; one launch
    each;
  * operands at an odd offset or strided (the wrapper's contiguous
    copies);
  * two runs of the same backward are equal bit for bit;
  * the fetch's forward through MaterialRows equals plain indexing bit for
    bit, and its backward is one launch inside a grad.material_rows span;
  * material_grad on cornell_monkey at 512^2: 5 launches (one a bounce),
    and the gradient of PyTorch's own gather backward (the aten path,
    MaterialRows bypassed) and of the plain twin, bit for bit.
'''

import numpy as np
import pytest
import torch

from ptina_tpu_torch import diff, mtllib
from ptina_tpu_torch.mtllib import (MaterialRows, fetch_material,
                                    material_rows_backward,
                                    material_rows_backward_plain)
from ptina_tpu_torch.scene import with_tensor
from ptina_tpu_torch.scenes import cornell_monkey
from ptina_tpu_torch.utils import trace

pytestmark = pytest.mark.cuda

RES = 512


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (CUDA kernels have no CPU mode)')
    return torch.device('cuda')


def _inputs(pattern, n, m1, seed, dev):
    g = torch.Generator(device='cpu').manual_seed(seed)
    if pattern == 'one_row':
        row = torch.full((n,), min(1, m1 - 1), dtype=torch.int64)
    elif pattern == 'defaults':
        row = torch.full((n,), m1 - 1, dtype=torch.int64)
    else:
        row = torch.randint(0, m1, (n,), generator=g, dtype=torch.int64)
    gb = torch.randn((n, 3), generator=g)
    gs = torch.randn((n, 12), generator=g)
    return row.to(dev), gb.to(dev), gs.to(dev)


@pytest.mark.parametrize('pattern', ['one_row', 'uniform', 'defaults'])
@pytest.mark.parametrize('n', [1, 257, 262144])
@pytest.mark.parametrize('m1', [1, 5, 300, 4000])
def test_kernel_equals_plain_twin(dev, m1, n, pattern):
    row, gb, gs = _inputs(pattern, n, m1, m1 * 31 + n, dev)
    before = mtllib.LAUNCHES['material_rows']
    got = material_rows_backward(row, gb, gs, m1)
    torch.cuda.synchronize()
    assert mtllib.LAUNCHES['material_rows'] == before + 1
    want = material_rows_backward_plain(row, gb, gs, m1)
    assert got.shape == want.shape == (m1, 12, 4)
    assert torch.equal(got, want)
    assert got.abs().max() > 0


def test_kernel_takes_unaligned_and_strided_operands(dev):
    '''Operands at a 4-byte offset and a strided row (the wrapper's
    contiguous copy): the same sums.'''
    row, gb, gs = _inputs('uniform', 1001, 5, 3, dev)
    big_b = torch.randn((1002, 3), device=dev)
    big_b[1:] = gb
    rows2 = torch.stack([row, row], 1)
    got = material_rows_backward(rows2[:, 0], big_b[1:], gs, 5)
    assert torch.equal(got, material_rows_backward_plain(row, gb, gs, 5))


@pytest.mark.parametrize('pattern', ['one_row', 'uniform'])
def test_kernel_is_deterministic(dev, pattern):
    row, gb, gs = _inputs(pattern, 262144, 5, 7, dev)
    a = material_rows_backward(row, gb, gs, 5)
    b = material_rows_backward(row, gb, gs, 5)
    assert torch.equal(a, b)


def test_fetch_forward_is_plain_indexing_and_one_launch_a_backward(dev):
    scene = cornell_monkey(device=dev)
    n = 262144
    m1 = scene.materials.fac.shape[0]
    g = torch.Generator(device='cpu').manual_seed(3)
    mtlid = torch.randint(-1, m1 + 1, (n,), generator=g,
                          dtype=torch.int32).to(dev)
    st = torch.rand((2, n), generator=g).to(dev)
    with torch.no_grad():
        want = fetch_material(scene, mtlid, st[0], st[1])
    fac = scene.materials.fac.detach().clone().requires_grad_(True)
    sc = with_tensor(scene, ('materials', 'fac'), fac)
    got = fetch_material(sc, mtlid, st[0], st[1])
    for k, v in want.items():
        parts = (v,) if isinstance(v, torch.Tensor) else (v.x, v.y, v.z)
        gparts = (got[k],) if isinstance(got[k], torch.Tensor) \
            else (got[k].x, got[k].y, got[k].z)
        for a, b in zip(parts, gparts):
            assert torch.equal(a, b.detach()), k
    row = torch.where((mtlid < 0) | (mtlid >= m1), m1 - 1, mtlid).long()
    base, scal = MaterialRows.apply(fac, row)
    assert torch.equal(base, fac[:, 0, 0:3][row])
    assert torch.equal(scal, fac[:, :, 0][row])
    trace.reset()
    trace.enable()
    try:
        before = mtllib.LAUNCHES['material_rows']
        loss = got['roughness'].sum() + got['basecolor'].x.sum()
        gk, = torch.autograd.grad(loss, fac)
        torch.cuda.synchronize()
        assert mtllib.LAUNCHES['material_rows'] == before + 1
        span = trace.summary()['traced']['grad.material_rows']
        assert span['count'] == 1 and span['device_ns'] is not None
    finally:
        trace.disable()
        trace.reset()
    ga, = torch.autograd.grad(fac[:, 2, 0][row].sum()
                              + fac[:, 0, 0][row].sum(), fac)
    assert torch.equal(gk, ga)  # integer counts: exact either way


def _target(dev):
    return torch.tensor(np.random.RandomState(5).uniform(
        0.0, 1.0, (RES, RES, 3)).astype(np.float32), device=dev)


def _aten_gathers(fac, row):
    return fac[:, 0, 0:3][row], fac[:, :, 0][row]


def test_material_grad_matches_the_aten_path(dev, monkeypatch):
    """material_grad through the kernel: 5 launches, the same bits twice,
    and the plain twin's and the aten path's gradient bit for bit."""
    scene = cornell_monkey(device=dev)
    target = _target(dev)
    before = mtllib.LAUNCHES['material_rows']
    lk, gk = diff.material_grad(scene, target)
    torch.cuda.synchronize()
    assert mtllib.LAUNCHES['material_rows'] == before + 5
    _, gk2 = diff.material_grad(scene, target)
    assert torch.equal(gk, gk2)
    with monkeypatch.context() as m:
        m.setattr(mtllib, 'material_rows_backward',
                  material_rows_backward_plain)
        lp, gp = diff.material_grad(scene, target)
    with monkeypatch.context() as m:
        m.setattr(MaterialRows, 'apply', _aten_gathers)
        la, ga = diff.material_grad(scene, target)
    assert mtllib.LAUNCHES['material_rows'] == before + 10
    assert lk.item() == la.item() == lp.item()
    assert gk.abs().max() > 0
    assert torch.equal(gk, gp)
    assert torch.equal(gk, ga)
