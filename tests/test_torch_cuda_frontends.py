'''
The scene front-ends on the card, at reduced sizes.  Marked `cuda`: each
test skips where torch.cuda.is_available() is false (the CPU-only test
run).  On a machine with the card:

    python -m pytest tests/test_torch_cuda_frontends.py -q -m cuda --noconftest

  * the cornell_monkey glTF asset of chip_smoke.py (TRS and `matrix`
    nodes, uint16 / uint32 indices, one byteStride view) as .gltf and
    .glb through readgltf and the worker at 64^2: the same image as the
    worker fed the composed arrays, bit for bit, one path launch a
    sample;
  * a GLB of a small cornell_highpoly through a worker set to
    accel='blocked': five launches of each blocked cast a sample, the
    composed arrays' image bit for bit;
  * the Blender engine's final-render calls through DaemonModule(worker)
    at 64^2 equal the same calls on the test's thread, and an error on
    the daemon thread reaches the caller.
'''

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (the assets and the worker calls)
from ptina_tpu_torch import worker  # noqa: E402
from ptina_tpu_torch.config import Config  # noqa: E402
from ptina_tpu_torch.engine import fused  # noqa: E402
from ptina_tpu_torch.intersect import blocked, dense_cast  # noqa: E402
from ptina_tpu_torch.io.multimesh import compose_multiple_meshes  # noqa: E402
from ptina_tpu_torch.io.readgltf import readgltf  # noqa: E402
from ptina_tpu_torch.scenes import _blob_parts  # noqa: E402
from ptina_tpu_torch.utils.daemon import DaemonModule  # noqa: E402

pytestmark = pytest.mark.cuda

RES, SPP = 64, 4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (CUDA kernels have no CPU mode)')
    return torch.device('cuda', 0)


def _launches():
    return {**dense_cast.LAUNCHES, **fused.LAUNCHES, **blocked.LAUNCHES}


def _render(load, spp, config=None):
    '''A fresh worker on the card, load(), spp renders: (image, launches).'''
    worker.init(config=config)
    load()
    before = _launches()
    for _ in range(spp):
        worker.render()
    torch.cuda.synchronize()
    grew = {k: v - before[k] for k, v in _launches().items()}
    return worker.get_image(), grew


def test_gltf_monkey_matches_composed_arrays(dev, tmp_path):
    meshes, nodes, gl, mats = chip_smoke.monkey_asset()
    images = {}
    for mode in ('gltf', 'glb'):
        path = str(tmp_path / f'monkey.{mode}')
        chip_smoke.write_gltf(path, meshes, nodes, gl, mode=mode)
        v, m, got, _ = readgltf(path)
        assert got == mats
        images[mode], grew = _render(
            lambda: chip_smoke.load_worker(worker, v, m, got, res=RES), SPP)
        assert grew['path'] == SPP and sum(grew.values()) == SPP
    verts, mtlids = compose_multiple_meshes(
        chip_smoke.composed_inputs(meshes, nodes))
    direct, _ = _render(
        lambda: chip_smoke.load_worker(worker, verts, mtlids, mats, res=RES),
        SPP)
    assert np.isfinite(direct).all()
    np.testing.assert_array_equal(images['gltf'], images['glb'])
    np.testing.assert_array_equal(images['gltf'], direct)


def test_glb_highpoly_takes_the_blocked_route(dev, tmp_path):
    parts = _blob_parts(48, 24)
    meshes = [chip_smoke.gl_primitives(v, m, np.eye(4), np.uint32,
                                       interleave=i == 1)
              for i, (v, m) in enumerate(parts)]
    nodes = [{'mesh': i} for i in range(3)]
    gl, mats = chip_smoke.gl_materials(chip_smoke._materials())
    path = str(tmp_path / 'highpoly.glb')
    chip_smoke.write_gltf(path, meshes, nodes, gl, mode='glb')
    v, m, got, _ = readgltf(path)
    cfg = Config(accel='blocked')
    img, grew = _render(
        lambda: chip_smoke.load_worker(worker, v, m, got, res=RES), 2, cfg)
    n = 5 * 2
    assert grew['blocked_shade'] == n and grew['blocked_any'] == n
    assert sum(grew.values()) == 2 * n
    verts, mtlids = compose_multiple_meshes(
        chip_smoke.composed_inputs(meshes, nodes))
    ref, _ = _render(
        lambda: chip_smoke.load_worker(worker, verts, mtlids, mats, res=RES),
        2, cfg)
    np.testing.assert_array_equal(img, ref)


def test_blender_calls_on_the_daemon_thread(dev):
    sync = chip_smoke.blender_scene()
    daemon = DaemonModule(worker)
    try:
        passes, _ = chip_smoke.final_render(daemon, sync, res=RES, spp=SPP)
        direct, _ = chip_smoke.final_render(worker, sync, res=RES, spp=SPP)
        np.testing.assert_array_equal(passes[0], direct[0])
        assert all(np.isfinite(p).all() for p in passes)
        daemon.set_engine('no_such_engine')
        with pytest.raises(ValueError, match='engine'):
            daemon.render()
    finally:
        daemon.stop()
