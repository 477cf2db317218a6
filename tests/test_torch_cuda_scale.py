'''
The scale-out path on the card.  Marked `cuda`: each test skips where
torch.cuda.is_available() is false (the CPU-only test run).  On a machine
with the card:

    python -m pytest tests/test_torch_cuda_scale.py -q -m cuda --noconftest

  * render with spb 1, 3 and 8 gives the same film bit for bit, on the
    megakernel (one path launch a sample) and on the wavefront;
  * render_sharded over 4 x the card equals render bit for bit on the
    megakernel and the wavefront (cornell_monkey) and on the blocked route
    (a small cornell_highpoly), with each band's launches;
  * train_step_sharded's gradient on the card equals the one-band
    gradient of the same loss (rtol 1e-3, as tests/test_sharding.py);
    each band launches its casts and material_rows once a bounce, and
    two steps toward the wall at half its basecolor lower the loss;
  * the two-process launcher (python -m ptina_tpu_torch.parallel, two
    ranks on the card): each band and the gathered film equal a
    one-process render bit for bit, no collective runs while rendering,
    and the gradient all-reduce equals the in-process mean;
  * lbvh_build on the card equals its build on the CPU array by array
    (which tests/test_torch_lbvh.py holds to JAX's, whose tree
    tests/test_lbvh.py holds to its invariants), and its traversal
    agrees with brute on the card: cornell_monkey, envlight and
    cornell_highpoly.
'''

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ptina_tpu_torch.diff import render_image_diff
from ptina_tpu_torch.engine.path import render, render_sample
from ptina_tpu_torch.film import film_to_image, new_film
from ptina_tpu_torch.intersect.brute import cast_closest
from ptina_tpu_torch.intersect.lbvh import lbvh_build, lbvh_traverse
from ptina_tpu_torch.parallel import (make_mesh, render_sharded,
                                      train_step_sharded)
from ptina_tpu_torch.scene import with_tensor
from ptina_tpu_torch.scenes import (cornell_box, cornell_highpoly,
                                    cornell_monkey, envlight_scene)
from ptina_tpu_torch.utils.vec import V3

from torch_assets import grew, launches

pytestmark = pytest.mark.cuda

RES = 64
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (CUDA kernels have no CPU mode)')
    return torch.device('cuda', 0)


@pytest.mark.parametrize('wavefront', [False, True],
                         ids=['megakernel', 'wavefront'])
def test_spb_is_bit_equal(dev, wavefront):
    scene = cornell_monkey(device=dev)
    if wavefront:  # the automatic route takes the wavefront on this model
        films = [render(scene, new_film(RES, RES, device=dev), 0, spp=8,
                        spb=spb, model='lambert') for spb in (1, 3, 8)]
    else:
        before = launches()
        films = [render(scene, new_film(RES, RES, device=dev), 0, spp=8,
                        spb=spb) for spb in (1, 3, 8)]
        assert grew(before) == {'path': 24}
    assert all(torch.equal(films[0], f) for f in films[1:])


@pytest.mark.parametrize('fused_route', [None, False],
                         ids=['megakernel', 'wavefront'])
def test_bands_equal_render(dev, fused_route):
    scene = cornell_monkey(device=dev)
    mesh = make_mesh([dev] * 4)
    ref = new_film(RES, RES, device=dev)
    for s in range(2):
        render_sample(scene, ref, s, fused=fused_route)
    before = launches()
    film = render_sharded(scene, new_film(RES, RES, device=dev), 0, mesh,
                          spp=2, fused=fused_route)
    want = {'path': 8} if fused_route is None else {'shade': 40, 'any': 40}
    assert grew(before) == want
    assert torch.equal(film, ref)


def test_blocked_bands_equal_render(dev):
    scene = cornell_highpoly(nu=48, nv=24, accel='blocked', device=dev)
    ref = render(scene, new_film(RES, RES, device=dev), 0, spp=1)
    before = launches()
    film = render_sharded(scene, new_film(RES, RES, device=dev), 0,
                          make_mesh([dev] * 4))
    assert grew(before) == {'blocked_shade': 20, 'blocked_any': 20}
    assert torch.equal(film, ref)


def test_sharded_gradient_equals_one_band(dev):
    scene = cornell_box(device=dev)
    target = torch.zeros(RES, RES, 3, device=dev)
    film0 = new_film(RES, RES, device=dev)
    stepped, _ = train_step_sharded(scene, film0, target, 0,
                                    make_mesh([dev] * 4), lr=1.0)
    g4 = scene.materials.fac - stepped.materials.fac
    fac = scene.materials.fac.clone().requires_grad_(True)
    film = render_sample(with_tensor(scene, ('materials', 'fac'), fac),
                         new_film(RES, RES, device=dev), 0, fused=False)
    loss = torch.mean((film_to_image(film)[..., :3] - target) ** 2)
    g1, = torch.autograd.grad(loss, fac)
    assert g1.abs().max().item() > 0
    assert torch.allclose(g4, g1, rtol=1e-3,
                          atol=1e-6 * g1.abs().max().item())


@pytest.mark.parametrize('name', ['cornell_monkey', 'envlight',
                                  'cornell_highpoly'])
def test_lbvh_on_the_card(dev, name):
    scene = {'cornell_monkey': cornell_monkey, 'envlight': envlight_scene,
             'cornell_highpoly': cornell_highpoly}[name](device=dev)
    nf = int(scene.nfaces)
    tris = scene.tri_pos[:nf]
    got = lbvh_build(tris)
    cpu = lbvh_build(tris.cpu())
    for f in ('leaf', 'child', 'bmin', 'bmax', 'leaf_bmin', 'leaf_bmax'):
        assert torch.equal(getattr(got, f).cpu(), getattr(cpu, f)), f
    rng = np.random.RandomState(0)
    n = 4096
    ro = torch.from_numpy(rng.randn(n, 3).astype(np.float32)).to(dev)
    aim = tris[torch.from_numpy(rng.randint(0, nf, n)).to(dev)].mean(1)
    rd = torch.nn.functional.normalize(aim - ro, dim=1)
    avoid = torch.full((n,), -1, dtype=torch.int32, device=dev)
    ht = lbvh_traverse(got, scene.tri_w2b, ro, rd, avoid)
    hb = cast_closest(V3(*ro.T), V3(*rd.T), scene.tri_w2b, avoid)
    same = hb.index == ht.index
    assert same.float().mean().item() > 0.97
    hits = hb.hit & same
    assert torch.allclose(hb.t[hits], ht.t[hits], rtol=1e-4, atol=1e-4)


def test_sharded_steps_descend(dev):
    scene = cornell_monkey(device=dev)
    fac = scene.materials.fac.clone()
    fac[0, 0, :3] *= 0.5
    with torch.no_grad():
        target = render_image_diff(with_tensor(scene, ('materials', 'fac'),
                                               fac), RES, RES)
    mesh = make_mesh([dev] * 4)
    film0 = new_film(RES, RES, device=dev)
    before = launches()
    s1, l1 = train_step_sharded(scene, film0, target, 0, mesh, lr=1.0)
    assert grew(before) == {'shade': 20, 'any': 20, 'material_rows': 20}
    _, l2 = train_step_sharded(s1, film0, target, 0, mesh, lr=1.0)
    assert l2.item() < l1.item()


def test_two_process_launcher_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (CUDA kernels have no CPU mode)')
    r = subprocess.run(
        [sys.executable, '-m', 'ptina_tpu_torch.parallel', '--res', str(RES),
         '--spp', '2', '--device', 'cuda', '--timeout', '300'],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    out = json.loads([line for line in r.stdout.splitlines()
                      if line.startswith('{')][-1])
    assert out['world_sizes_seen'] == [2, 2]
    assert all(d.startswith('cuda') for d in out['devices'])
    assert out['band_equal'] is True and out['gathered_equal'] is True
    assert out['render_collectives'] == 0
    assert out['grad_allclose'] is True
