'''
The texel gather's backward kernel on the card (csrc/texel_rows.cu,
ptina_tpu_torch/texture.py: texel_rows_backward, TexelRows).  Marked
`cuda`: each test skips where torch.cuda.is_available() is false (the
CPU-only test run).  On a machine with the card:

    python -m pytest tests/test_torch_cuda_texel_rows.py -q -m cuda --noconftest

  * the kernel against its plain twin (texel_rows_backward_plain,
    index_put_ with accumulate) and autograd's own gather backward (the
    aten path), bit for bit, on rows all zero, sparse, every lane live on
    random texels or on one texel, rows of -0 and rows holding a NaN; on
    one atlas, a two-texture atlas and a 1024 x 1024 one; N of 1, 257 and
    262,144; two launches each;
  * past the sizes above, bit for bit with the twin: 2^22 lanes (2,048
    segments, so the second launch walks each bucket in two groups of
    1,024 segments) and an atlas of three 1024 x 1024 textures
    (3,145,728 texels: the buckets are capped at 1,024, so each is split
    over two blocks of the second launch);
  * the launch plan's edge: an atlas of 2,097,152 texels (a 1024 x 2048
    environment, exactly 1,024 buckets of 2,048) and of 2,097,153,
    bit for bit with the twin;
  * lanes on the first and the last texel of the atlas;
  * cotangents at a 4-byte offset or strided, indices strided or
    broadcast (stride 0);
  * twenty runs of the same backward are equal bit for bit;
  * one backward is two launches inside one grad.texel_rows span, and
    they alone inside one grad.texel_rows.kernels span;
  * texture_grad at 512^2 on matball (the 64x64 ramp bound to roughness:
    232 launches, 116 backwards) and on the textured cornell (the ramp
    bound to basecolor, most lanes live): the same bits twice, and the
    gradient of the aten path (TexelRows bypassed) bit for bit.
'''

import numpy as np
import pytest
import torch

from ptina_tpu_torch import diff, texture
from ptina_tpu_torch.bench import bench_texture
from ptina_tpu_torch.scenes import cornell_box, matball
from ptina_tpu_torch.texture import (TexelRows, texel_rows_backward,
                                     texel_rows_backward_plain)
from ptina_tpu_torch.utils import trace

pytestmark = pytest.mark.cuda

RES = 512
ATLASES = [(1, 64, 64, 4), (2, 37, 53, 4), (1, 1024, 1024, 4)]
PATTERNS = ['all_zero', 'sparse', 'dense_random', 'dense_one', 'neg_zero',
            'nan']


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (CUDA kernels have no CPU mode)')
    return torch.device('cuda')


def _inputs(pattern, shape, n, seed, dev):
    '''texid, x, y [n] int64 and g [n, 4] float32 on dev.'''
    rng = np.random.default_rng(seed)
    t_, h_, w_ = shape[:3]
    if pattern == 'dense_one':
        idx = [np.full(n, d - 1) for d in (t_, h_, w_)]
    else:
        idx = [rng.integers(0, d, n) for d in (t_, h_, w_)]
    g = rng.standard_normal((n, 4)).astype(np.float32)
    if pattern == 'all_zero':
        g[:] = 0.0
        g[1::2] = -0.0
    elif pattern in ('sparse', 'neg_zero', 'nan'):
        dead = rng.random(n) < 0.9
        g[dead] = -0.0 if pattern == 'neg_zero' else 0.0
        if pattern == 'neg_zero':
            g[~dead, 0] = -0.0
        if pattern == 'nan':
            g[np.flatnonzero(~dead)[::5], 3] = np.nan
    return ([torch.from_numpy(i.astype(np.int64)).to(dev) for i in idx]
            + [torch.from_numpy(g).to(dev)])


def _aten(texid, x, y, g, shape):
    '''Autograd's own backward of the gather data[texid, x, y].'''
    data = torch.zeros(shape, device=g.device, requires_grad=True)
    return torch.autograd.grad(data[texid, x, y], data, g)[0]


def _same(a, b):
    '''Equal bits (a NaN equals a NaN of the same bits).'''
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


@pytest.mark.parametrize('pattern', PATTERNS)
@pytest.mark.parametrize('n', [1, 257, 262144])
@pytest.mark.parametrize('shape', ATLASES)
def test_kernel_equals_plain_twin_and_aten(dev, shape, n, pattern):
    texid, x, y, g = _inputs(pattern, shape, n, [n, len(pattern), shape[1]],
                             dev)
    before = texture.LAUNCHES['texel_rows']
    got = texel_rows_backward(texid, x, y, g, shape)
    torch.cuda.synchronize()
    assert texture.LAUNCHES['texel_rows'] == before + 2
    assert _same(got, texel_rows_backward_plain(texid, x, y, g, shape))
    assert _same(got, _aten(texid, x, y, g, shape))
    if pattern == 'all_zero':
        assert _same(got, torch.zeros(shape, device=dev))
    else:
        assert got.abs().nan_to_num().max() > 0 or n == 1
    if pattern == 'nan' and n > 5:
        assert bool(got.isnan().any())


@pytest.mark.parametrize('pattern', ['sparse', 'dense_random', 'dense_one'])
@pytest.mark.parametrize('shape,n', [((1, 64, 64, 4), 1 << 22),
                                     ((3, 1024, 1024, 4), 262144),
                                     ((3, 1024, 1024, 4), 1 << 22)])
def test_kernel_past_one_segment_group_and_uncapped_buckets(dev, shape, n,
                                                            pattern):
    '''Over 1,024 segments of 2,048 lanes, and over 1,024 buckets of
    2,048 texels: the twin's bits.'''
    texid, x, y, g = _inputs(pattern, shape, n, [n, len(pattern), shape[0]],
                             dev)
    before = texture.LAUNCHES['texel_rows']
    got = texel_rows_backward(texid, x, y, g, shape)
    torch.cuda.synchronize()
    assert texture.LAUNCHES['texel_rows'] == before + 2
    assert _same(got, texel_rows_backward_plain(texid, x, y, g, shape))
    assert got.abs().max() > 0


@pytest.mark.parametrize('pattern', ['sparse', 'dense_random', 'dense_one'])
@pytest.mark.parametrize('shape', [(1, 1024, 2048, 4), (1, 3, 699051, 4)],
                         ids=['2097152', '2097153'])
def test_kernel_at_the_bucket_edge(dev, shape, pattern):
    '''A 1024 x 2048 environment's 2,097,152 texels are exactly
    kBucketsMax buckets of kKeys texels, the launch plan's edge; one texel
    more caps the buckets and splits each over two blocks: the twin's
    bits at 262,144 lanes on both sides of it.'''
    n = 262144
    texid, x, y, g = _inputs(pattern, shape, n, [n, len(pattern), shape[2]],
                             dev)
    got = texel_rows_backward(texid, x, y, g, shape)
    torch.cuda.synchronize()
    assert _same(got, texel_rows_backward_plain(texid, x, y, g, shape))
    assert got.abs().max() > 0


@pytest.mark.parametrize('shape', ATLASES)
def test_keys_at_both_ends_of_the_atlas(dev, shape):
    '''Lanes on texel 0 and on the last texel, interleaved with lanes in
    between, some rows zero.'''
    t_, h_, w_ = shape[:3]
    n = 5000
    rng = np.random.default_rng(11)
    end = rng.integers(0, 3, n)  # 0: first texel, 1: last, 2: anywhere
    idx = []
    for d in (t_, h_, w_):
        mid = rng.integers(0, d, n)
        idx.append(torch.from_numpy(np.where(end == 0, 0, np.where(
            end == 1, d - 1, mid)).astype(np.int64)).to(dev))
    g = torch.from_numpy(rng.standard_normal((n, 4)).astype(np.float32))
    g[::4] = 0.0
    g = g.to(dev)
    got = texel_rows_backward(*idx, g, shape)
    assert _same(got, texel_rows_backward_plain(*idx, g, shape))
    assert got[0, 0, 0].abs().sum() > 0 and got[-1, -1, -1].abs().sum() > 0


def test_kernel_takes_offset_and_strided_operands(dev):
    '''A cotangent at a 4-byte offset and one strided, indices strided
    and broadcast: the same sums as contiguous copies.'''
    shape = (2, 37, 53, 4)
    texid, x, y, g = _inputs('sparse', shape, 3001, 3, dev)
    want = texel_rows_backward_plain(texid, x, y, g, shape)
    big = torch.randn(3001 * 4 + 1, device=dev)
    big[1:] = g.reshape(-1)
    off = big[1:].view(3001, 4)
    assert off.data_ptr() % 16
    assert _same(texel_rows_backward(texid, x, y, off, shape), want)
    wide = torch.randn(3001, 8, device=dev)
    wide[:, 2:6] = g
    assert _same(texel_rows_backward(texid, x, y, wide[:, 2:6], shape), want)
    pairs = torch.stack([x, y], 1)
    assert _same(texel_rows_backward(texid, pairs[:, 0], pairs[:, 1], g,
                                     shape), want)
    one = torch.ones((), dtype=torch.int64, device=dev).expand(3001)
    assert _same(texel_rows_backward(one, x, y, g, shape),
                 texel_rows_backward_plain(one, x, y, g, shape))


@pytest.mark.parametrize('pattern', ['sparse', 'dense_random', 'dense_one'])
def test_kernel_is_deterministic(dev, pattern):
    shape = ATLASES[0]
    texid, x, y, g = _inputs(pattern, shape, 262144, 7, dev)
    a = texel_rows_backward(texid, x, y, g, shape)
    for _ in range(19):
        assert _same(a, texel_rows_backward(texid, x, y, g, shape))


def test_one_backward_is_two_launches_in_one_span(dev):
    shape = ATLASES[0]
    texid, x, y, g = _inputs('sparse', shape, 262144, 9, dev)
    data = torch.rand(shape, device=dev)
    leaf = data.clone().requires_grad_(True)
    out = TexelRows.apply(leaf, texid, x, y)
    assert torch.equal(out, data[texid, x, y])
    trace.reset()
    trace.enable()
    try:
        before = texture.LAUNCHES['texel_rows']
        got, = torch.autograd.grad(out, leaf, g)
        torch.cuda.synchronize()
        assert texture.LAUNCHES['texel_rows'] == before + 2
        s = trace.summary()
        for name in ('grad.texel_rows', 'grad.texel_rows.kernels'):
            span = s['traced'][name]
            assert span['count'] == 1 and span['device_ns'] is not None
        assert s['traced']['grad.texel_rows.kernels']['device_ns'] \
            <= s['traced']['grad.texel_rows']['device_ns']
        lanes, live, texels = s['counts']['texel_rows']
        assert lanes == 262144 and live == int((g != 0).any(1).sum())
    finally:
        trace.disable()
        trace.reset()
    assert _same(got, _aten(texid, x, y, g, shape))


def _aten_gather(d, t, x, y):
    return d[t, x, y]


SCENES = {'matball': lambda dev: matball(roughness_tex=bench_texture(),
                                          device=dev),
          'cornell_textured': lambda dev: cornell_box(
              textured_image=bench_texture(), device=dev)}


@pytest.mark.parametrize('name', list(SCENES))
def test_texture_grad_matches_the_aten_path(dev, monkeypatch, name):
    '''texture_grad at 512^2 x 1 spp through the kernel: two launches a
    backward (matball: 116 backwards), the same bits twice, and the
    gradient of PyTorch's own gather backward (TexelRows bypassed) bit for
    bit.'''
    scene = SCENES[name](dev)
    target = torch.full((RES, RES, 3), 0.25, device=dev)
    before = texture.LAUNCHES['texel_rows']
    lk, gk = diff.texture_grad(scene, target)
    torch.cuda.synchronize()
    launches = texture.LAUNCHES['texel_rows'] - before
    assert launches > 0 and launches % 2 == 0
    if name == 'matball':
        assert launches == 232
    _, gk2 = diff.texture_grad(scene, target)
    assert _same(gk, gk2)
    with monkeypatch.context() as m:
        m.setattr(TexelRows, 'apply', staticmethod(_aten_gather))
        la, ga = diff.texture_grad(scene, target)
    assert texture.LAUNCHES['texel_rows'] - before == 2 * launches
    assert lk.item() == la.item()
    assert gk.abs().max() > 0
    assert _same(gk, ga)
