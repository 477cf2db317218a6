'''
The port's CUDA cast kernels against their plain torch versions, on the
card.  Marked `cuda`: each test skips where torch.cuda.is_available() is
false (the CPU-only test run).  On a machine with the card:

    python -m pytest tests/test_torch_cuda_kernels.py -q -m cuda

The kernels are built with --fmad=false, so on identical inputs they
agree with the plain versions bit for bit; the tolerances stated in
chip_smoke.py (index and occlusion on >= 99.99% of rays) hold with room.
'''

import numpy as np
import pytest
import torch

from ptina_tpu_torch.engine.path import render
from ptina_tpu_torch.film import new_film
from ptina_tpu_torch.intersect import dense_cast
from ptina_tpu_torch.scene import make_scene
from ptina_tpu_torch.scenes import cornell_box, cornell_monkey
from ptina_tpu_torch.utils.vec import V3

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (CUDA kernels have no CPU mode)')
    return torch.device('cuda')


def _random_scene(nf, dev):
    rng = np.random.RandomState(nf)
    tris = (rng.randn(nf, 3, 3) * 2.0).astype(np.float32)
    verts = np.concatenate([tris.reshape(-1, 3),
                            np.tile([[0.0, 1.0, 0.0]], (nf * 3, 1)),
                            rng.rand(nf * 3, 2)], axis=1)
    return make_scene(verts, rng.randint(-1, 3, nf), device=dev)


def _rays(n, f, dev, seed=0):
    rng = np.random.RandomState(seed)
    o = np.stack([rng.uniform(-1.9, 1.9, n), rng.uniform(0.1, 3.9, n),
                  rng.uniform(-1.9, 1.9, n)], 1).astype(np.float32)
    d = rng.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    avoid = np.where(rng.rand(n) < 0.25, rng.randint(0, f, n), -1)
    tmax = rng.uniform(0.0, 6.0, n).astype(np.float32)

    def t(a, dt=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=dev)
    return (V3(t(o[:, 0]), t(o[:, 1]), t(o[:, 2])),
            V3(t(d[:, 0]), t(d[:, 1]), t(d[:, 2])),
            t(avoid, torch.int32), t(tmax))


SCENES = {'cornell': lambda d: cornell_box(device=d),
          'cornell_monkey': lambda d: cornell_monkey(device=d),
          'random_2500': lambda d: _random_scene(2500, d)}


@pytest.mark.parametrize('name', sorted(SCENES))
@pytest.mark.parametrize('n', [262144, 1001])
def test_kernels_match_plain(dev, name, n):
    scene = SCENES[name](dev)
    ro, rd, avoid, tmax = _rays(n, scene.face_coef.shape[0], dev)
    hk, ak = dense_cast.cast_shade(ro, rd, avoid, scene.face_coef,
                                   scene.face_attr)
    hp, ap = dense_cast.cast_shade_plain(ro, rd, avoid, scene.face_coef,
                                         scene.face_attr)
    ok = dense_cast.cast_any(ro, rd, avoid, tmax, scene.face_coef)
    op = dense_cast.cast_any_plain(ro, rd, avoid, tmax, scene.face_coef)
    torch.cuda.synchronize()
    assert torch.equal(hk.index, hp.index)
    assert torch.equal(hk.hit, hp.hit)
    assert torch.equal(hk.t, hp.t)
    assert torch.equal(hk.u, hp.u) and torch.equal(hk.v, hp.v)
    assert torch.equal(ak, ap)
    assert torch.equal(ok, op)


def test_render_launches_kernels(dev):
    scene = cornell_box(device=dev)
    before = dict(dense_cast.LAUNCHES)
    film = render(scene, new_film(64, 64, device=dev), 0, spp=2)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(film).all())
    for k in before:
        assert dense_cast.LAUNCHES[k] - before[k] == 5 * 2
