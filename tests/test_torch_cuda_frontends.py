'''
The scene front-ends on the card, at reduced sizes.  Marked `cuda`: each
test skips where torch.cuda.is_available() is false (the CPU-only test
run).  On a machine with the card:

    python -m pytest tests/test_torch_cuda_frontends.py -q -m cuda --noconftest

  * the cornell_monkey glTF asset of tests/torch_assets.py (TRS and
    `matrix` nodes, uint16 / uint32 indices, one byteStride view) as
    .gltf and .glb through readgltf and the worker at 64^2: the same
    image as the worker fed the composed arrays, bit for bit, one path
    launch a sample, the megakernel against its twin on the loaded scene;
  * matball as a GLB with its roughness ramp an 8-bit PNG (io._png) bound
    as the metallicRoughness texture: the ramp decodes as encoded, the
    worker's scene carries a texture atlas, one path launch a sample,
    the megakernel against its twin;
  * a GLB of a small cornell_highpoly through a worker set to
    accel='blocked': five launches of each blocked cast a sample, the
    composed arrays' image bit for bit;
  * cornell_monkey written by writeobj and loaded by
    worker.load_model(path) with obj_mtlids' ids: the same vertices and
    ids, one path launch a render;
  * the Blender engine's final-render calls through DaemonModule(worker)
    at 64^2 (one path launch a sample and one preview shade launch)
    equal the same calls on the test's thread, and an error on the
    daemon thread reaches the caller; the viewport ladder from 1/8 of
    64^2 through viewport_pass renders each rung at its size, one path
    launch a rung;
  * the six examples as `python -m ptina_tpu_torch.examples.<name>`
    processes at once (smoke_render at 64^2 x 4 spp on the monkey, the
    rest at their defaults): each exits 0, smoke_render prints the mean
    of the same render in this process, and every PNG they write
    decodes.
'''

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_assets
from torch_assets import assert_radiance_close, grew, launches
from ptina_tpu_torch import worker
from ptina_tpu_torch.blender import (ViewportRefiner, sync_worker,
                                     viewport_pass)
from ptina_tpu_torch.config import Config
from ptina_tpu_torch.engine import fused
from ptina_tpu_torch.engine.path import render
from ptina_tpu_torch.film import film_to_image, new_film
from ptina_tpu_torch.io import _png
from ptina_tpu_torch.io.multimesh import compose_multiple_meshes
from ptina_tpu_torch.io.readgltf import readgltf
from ptina_tpu_torch.io.readobj import obj_mtlids, writeobj
from ptina_tpu_torch.sampling.sobol import sobol_block
from ptina_tpu_torch.scenes import (BENCH_CAMERA, _blob_parts, _materials,
                                    cornell_monkey)
from ptina_tpu_torch.utils.daemon import DaemonModule

pytestmark = pytest.mark.cuda

RES, SPP = 64, 4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (CUDA kernels have no CPU mode)')
    return torch.device('cuda', 0)


def _render(load, spp, config=None):
    '''A fresh worker on the card, load(), spp renders: (image, launches).'''
    worker.init(config=config)
    load()
    before = launches()
    for _ in range(spp):
        worker.render()
    torch.cuda.synchronize()
    return worker.get_image(), grew(before)


def _hold_twin(scene, relative):
    '''The megakernel against its twin on a loaded scene.'''
    pt = sobol_block(0, 32)
    assert_radiance_close(fused.fused_trace_primary(scene, pt, RES, RES),
                          fused.fused_trace_primary_plain(scene, pt, RES,
                                                          RES),
                          relative)


def test_gltf_monkey_matches_composed_arrays(dev, tmp_path):
    meshes, nodes, gl, mats = torch_assets.monkey_asset()
    images = {}
    for mode in ('gltf', 'glb'):
        path = str(tmp_path / f'monkey.{mode}')
        torch_assets.write_gltf(path, meshes, nodes, gl, mode=mode)
        v, m, got, _ = readgltf(path)
        assert got == mats
        images[mode], moved = _render(
            lambda: torch_assets.load_worker(worker, v, m, got, res=RES), SPP)
        assert moved == {'path': SPP}
        _hold_twin(worker._S.scene, relative=False)
    verts, mtlids = compose_multiple_meshes(
        torch_assets.composed_inputs(meshes, nodes))
    direct, _ = _render(
        lambda: torch_assets.load_worker(worker, verts, mtlids, mats, res=RES),
        SPP)
    assert np.isfinite(direct).all()
    np.testing.assert_array_equal(images['gltf'], images['glb'])
    np.testing.assert_array_equal(images['gltf'], direct)


def test_glb_highpoly_takes_the_blocked_route(dev, tmp_path):
    parts = _blob_parts(48, 24)
    meshes = [torch_assets.gl_primitives(v, m, np.eye(4), np.uint32,
                                         interleave=i == 1)
              for i, (v, m) in enumerate(parts)]
    nodes = [{'mesh': i} for i in range(3)]
    gl, mats = torch_assets.gl_materials(_materials())
    path = str(tmp_path / 'highpoly.glb')
    torch_assets.write_gltf(path, meshes, nodes, gl, mode='glb')
    v, m, got, _ = readgltf(path)
    cfg = Config(accel='blocked')
    img, moved = _render(
        lambda: torch_assets.load_worker(worker, v, m, got, res=RES), 2, cfg)
    assert moved == {'blocked_shade': 5 * 2, 'blocked_any': 5 * 2}
    verts, mtlids = compose_multiple_meshes(
        torch_assets.composed_inputs(meshes, nodes))
    ref, _ = _render(
        lambda: torch_assets.load_worker(worker, verts, mtlids, mats, res=RES),
        2, cfg)
    np.testing.assert_array_equal(img, ref)


def test_blender_calls_on_the_daemon_thread(dev):
    sync = torch_assets.blender_scene()
    daemon = DaemonModule(worker)
    try:
        before = launches()
        passes, _ = torch_assets.final_render(daemon, sync, res=RES, spp=SPP)
        assert grew(before) == {'path': SPP, 'shade': 1}
        direct, _ = torch_assets.final_render(worker, sync, res=RES, spp=SPP)
        np.testing.assert_array_equal(passes[0], direct[0])
        assert all(np.isfinite(p).all() for p in passes)
        daemon.set_engine('no_such_engine')
        with pytest.raises(ValueError, match='engine'):
            daemon.render()
    finally:
        daemon.stop()


def test_gltf_matball_with_a_png_ramp(dev, tmp_path):
    ramp, png = torch_assets.ramp_png()
    np.testing.assert_array_equal(_png.decode(png),
                                  np.ascontiguousarray(ramp.swapaxes(0, 1)))
    meshes, nodes, gl, mats, pngs = torch_assets.matball_asset(png)
    path = str(tmp_path / 'matball.glb')
    torch_assets.write_gltf(path, meshes, nodes, gl, pngs, mode='glb')
    v, m, got, imgs = readgltf(path)
    assert got == mats and len(imgs) == 1
    np.testing.assert_array_equal(imgs[0], ramp)
    img, moved = _render(
        lambda: torch_assets.load_worker(worker, v, m, got, imgs, res=RES),
        SPP)
    assert moved == {'path': SPP}
    assert np.isfinite(img).all()
    scene = worker._S.scene
    assert scene.textures.data.shape[0] == 1 and scene.materials.textured
    _hold_twin(scene, relative=True)


def test_obj_through_the_worker(dev, tmp_path):
    (sv, sm), (bv, bm), (xv, xm) = _blob_parts()
    verts = np.concatenate([sv, bv, xv])
    mtlids = np.concatenate([sm, bm, xm])
    obj = torch_assets.obj_of_vertices(verts, mtlids)
    path = str(tmp_path / 'monkey.obj')
    writeobj(path, obj)
    worker.init()
    worker.load_model(path, obj_mtlids(obj, {f'm{i}': i for i in range(4)}))
    np.testing.assert_array_equal(worker._S.vertices, verts)
    np.testing.assert_array_equal(worker._S.mtlids, mtlids)
    worker.build_tree()
    before = launches()
    worker.render()
    assert grew(before) == {'path': 1}


def test_blender_viewport_ladder(dev):
    daemon = DaemonModule(worker)
    try:
        daemon.init()
        sync_worker(daemon, *torch_assets.blender_scene())
        refiner = ViewportRefiner(start_pixel_size=8, max_samples=SPP)
        rungs, act = [], {'redraw': True}
        before = launches()
        while act['redraw']:
            act = refiner.next_action((RES, RES), BENCH_CAMERA.tobytes())
            (w, h), buf = viewport_pass(daemon, act, BENCH_CAMERA)
            assert (w, h) == (act['width'], act['height'])
            assert np.isfinite(buf).all() and buf.any()
            rungs.append((w, h))
        moved = grew(before)
    finally:
        daemon.stop()
    assert rungs[0] == (RES // 8, RES // 8) and rungs[-1] == (RES, RES)
    assert moved == {'path': len(rungs)}


EXAMPLES = ('smoke_render', 'coverage', 'matball', 'metropolis',
            'objloader', 'interactive')


def test_examples_run_as_modules(dev, tmp_path):
    env = dict(os.environ, TMPDIR=str(tmp_path))
    procs = {name: subprocess.Popen(
        [sys.executable, '-m', f'ptina_tpu_torch.examples.{name}',
         *((str(RES), str(SPP), 'monkey') if name == 'smoke_render' else ())],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for name in EXAMPLES}
    outs = {}
    try:
        for name, p in procs.items():
            out, err = p.communicate(timeout=600)
            outs[name] = out
            assert p.returncode == 0, (name, out[-2000:], err[-4000:])
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    img = film_to_image(render(cornell_monkey(device=dev),
                               new_film(RES, RES, device=dev), 0,
                               spp=SPP)).cpu().numpy()
    got = re.search(r' mean (\S+) ', outs['smoke_render']).group(1)
    assert np.float32(got) == img[..., :3].mean()
    pngs = sorted(n for n in os.listdir(tmp_path) if n.endswith('.png'))
    assert {f'smoke_monkey_{RES}.png', 'coverage_cornell.png', 'matball.png',
            'metropolis_cornell.png', 'refine_f2_final.png'} <= set(pngs)
    for n in pngs:
        with open(tmp_path / n, 'rb') as f:
            assert _png.decode(f.read()).ndim == 3, n
