'''
The port's API helpers and the middle-split BVH against the JAX package,
on the CPU:

  * utils/daemon.py: DaemonModule serialises calls onto one thread in
    order and hands exceptions to the caller; OnDemandProxy builds on
    first use (tests/test_aux.py::test_daemon_module_serializes_calls);
  * utils/control.py: CamControl.matrix equal to the JAX package's (numpy
    on both sides, so exactly) after the same orbit, pan and zoom
    (tests/test_aux.py::test_cam_control_produces_valid_matrix);
  * intersect/middlebvh.py: its six arrays equal to JAX's, and its tree
    through lbvh_traverse against brute as
    tests/test_aux.py::test_middlebvh_matches_brute holds it (the same
    index on > 97% of rays, t within 1e-4 where they agree); it builds
    on the card unless asked for the CPU;
  * the new modules import with neither JAX nor a process group.
'''

import inspect
import os
import subprocess
import sys
import threading
import types

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ptina_tpu.intersect.middlebvh import middlebvh_build as jmiddlebvh_build
from ptina_tpu.utils.control import CamControl as JCamControl
from ptina_tpu_torch.intersect.brute import cast_closest
from ptina_tpu_torch.intersect.lbvh import LBVH, lbvh_traverse
from ptina_tpu_torch.intersect.middlebvh import middlebvh_build
from ptina_tpu_torch.scene import precompute_tri_functionals
from ptina_tpu_torch.utils import daemon
from ptina_tpu_torch.utils.control import CamControl
from ptina_tpu_torch.utils.vec import V3

torch.set_num_threads(2)

FIELDS = ('leaf', 'child', 'bmin', 'bmax', 'leaf_bmin', 'leaf_bmax')


def test_daemon_module_serializes_calls():
    mod = types.SimpleNamespace(calls=[], threads=set(), value=7)

    def record(x):
        mod.calls.append(x)
        mod.threads.add(threading.get_ident())
        return x * 2
    mod.record = record

    def boom():
        raise ValueError('boom')
    mod.boom = boom
    dm = daemon.DaemonModule(mod)
    try:
        callers = [threading.Thread(target=dm.record, args=(i,))
                   for i in range(16)]
        for t in callers:
            t.start()
        for t in callers:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in callers)
        assert dm.record(21) == 42
        assert sorted(mod.calls) == list(range(16)) + [21]
        assert len(mod.threads) == 1 \
            and threading.get_ident() not in mod.threads
        assert dm.value == 7  # plain attributes pass through
        with pytest.raises(ValueError, match='boom'):
            dm.boom()
        assert dm.record(1) == 2  # the thread outlives an exception
    finally:
        dm.stop()


def test_daemon_thread_runs_in_order_and_proxy_builds_on_demand():
    d = daemon.DaemonThread()
    seen = []
    try:
        for i in range(5):
            d.submit(lambda i=i: seen.append(i))
        assert d.call(lambda: list(seen)) == [0, 1, 2, 3, 4]
        assert d.call(lambda: d.call(lambda: 3)) == 3  # re-entrant
    finally:
        d.stop()
    built = []
    proxy = daemon.OnDemandProxy(lambda: built.append(1) or
                                 types.SimpleNamespace(x=5))
    assert built == []
    assert proxy.x == 5 and proxy.x == 5 and built == [1]


def test_cam_control_matches_jax():
    got, ref = CamControl(radius=3.0), JCamControl(radius=3.0)
    np.testing.assert_array_equal(got.matrix(aspect=1.0),
                                  ref.matrix(aspect=1.0))
    for cam in (got, ref):
        cam.orbit(0.1, 0.05)
        cam.pan(0.02, -0.01)
        cam.zoom(2)
    m = got.matrix(aspect=1.5)
    assert m.shape == (4, 4) and np.isfinite(m).all()
    np.testing.assert_array_equal(m, ref.matrix(aspect=1.5))
    assert got.radius < 3.0 and got.dirty is False
    ortho = CamControl(is_ortho=True)
    np.testing.assert_array_equal(ortho.matrix(2.0),
                                  JCamControl(is_ortho=True).matrix(2.0))


def _tris(seed, nf=48):
    return np.random.RandomState(seed).randn(nf, 3, 3).astype(np.float32)


def test_middlebvh_arrays_match_jax():
    for tris in (_tris(7), _tris(8, 1), _tris(9, 33)):
        ref = jmiddlebvh_build(jnp.asarray(tris))
        got = middlebvh_build(tris, device='cpu')
        assert isinstance(got, LBVH)
        for f in FIELDS:
            a, b = np.asarray(getattr(ref, f)), getattr(got, f).numpy()
            assert a.dtype == b.dtype and np.array_equal(a, b), f
    # a tensor input gives the same tree
    tris = _tris(7)
    t = middlebvh_build(torch.from_numpy(tris), device='cpu')
    assert torch.equal(t.child, middlebvh_build(tris, device='cpu').child)


def test_middlebvh_matches_brute():
    rng = np.random.RandomState(7)
    tris = torch.from_numpy(rng.randn(48, 3, 3).astype(np.float32))
    m = precompute_tri_functionals(tris)
    bvh = middlebvh_build(tris, device='cpu')
    nr = 96
    ro = torch.from_numpy(rng.randn(nr, 3).astype(np.float32) * 4)
    rd = torch.from_numpy(rng.randn(nr, 3).astype(np.float32))
    rd = rd / torch.linalg.norm(rd, dim=1, keepdim=True)
    avoid = torch.full((nr,), -1, dtype=torch.int32)
    hb = cast_closest(V3(*ro.T), V3(*rd.T), m, avoid)
    ht = lbvh_traverse(bvh, m, ro, rd, avoid)
    same = hb.index == ht.index
    assert same.float().mean().item() > 0.97
    hits = hb.hit & same
    assert hits.any()
    assert torch.allclose(hb.t[hits], ht.t[hits], rtol=1e-4, atol=1e-4)


def test_middlebvh_defaults_to_the_card():
    assert inspect.signature(middlebvh_build).parameters['device'].default \
        == 'cuda'


def test_new_modules_import_without_jax():
    '''A fresh interpreter imports the scale-out and BVH modules and pulls
    in no JAX, no ptina_tpu and no process group.'''
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ('import sys\n'
            'import ptina_tpu_torch.parallel, ptina_tpu_torch.intersect.lbvh\n'
            'import ptina_tpu_torch.intersect.middlebvh\n'
            'import ptina_tpu_torch.utils.daemon\n'
            'import ptina_tpu_torch.utils.control\n'
            'import torch.distributed as dist\n'
            'assert not dist.is_initialized()\n'
            'bad = [m for m in sys.modules if m.split(".")[0] in '
            '("jax", "flax", "ptina_tpu")]\n'
            'assert not bad, bad\n')
    out = subprocess.run([sys.executable, '-c', code], cwd=root,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=''))
    assert out.returncode == 0, out.stderr
