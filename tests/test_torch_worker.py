'''
The PyTorch port's flat worker API (ptina_tpu_torch.worker) on the CPU,
against the JAX reference's worker.

  * the three flows of tests/test_worker.py on device='cpu';
  * the 'path' engine's image against the reference worker's at 8x8, 2
    samples: >= 98% of pixels within 1e-3 * (1 + |ref|) (the port casts
    with the dense-cast contract on the CPU, the reference with brute;
    tests/test_torch_render.py);
  * checkpoints: a 'path'-engine checkpoint written by the reference's
    save_state resumes in the port's worker and the other way round (the
    resumed image against the other package's uninterrupted one, at the
    same allowance); within the port a resume continues bit for bit, for
    the 'path' engine and for 'mlt' (whose chains the port stores as
    numpy arrays); a reference MLT checkpoint (a pickled flax MLTState)
    is refused;
  * load_model from an OBJ file (io/readobj.py) gives the reference's
    vertices;
  * config.Config, utils.params.Params and utils.trace's log / timed
    behave as the reference's (fields and defaults, clamping, output).
'''

import dataclasses
import os
import pickle

import numpy as np
import pytest
import torch

from ptina_tpu import config as jconfig
from ptina_tpu import worker as jworker
from ptina_tpu.utils import params as jparams
from ptina_tpu.utils import trace as jtrace
from ptina_tpu.io import readobj as jreadobj
from ptina_tpu.scenes import (_cornell_shell as _jshell,
                              _mesh_to_vertices as _jvertices)
from ptina_tpu_torch import config, worker
from ptina_tpu_torch.io import readobj
from ptina_tpu_torch.utils import params, trace
from ptina_tpu_torch.scenes import (_cornell_shell, _mesh_to_vertices,
                                    BENCH_CAMERA)

torch.set_num_threads(2)


def _cornell_vertices():
    shell, mtl = _cornell_shell()
    return _mesh_to_vertices(shell), np.asarray(mtl, np.int32)


def _setup(w, res, engine=None, **init):
    '''Initialise worker module `w` (either package) on the cornell shell
    at res x res.'''
    w.init(engine=engine, **init)
    w.set_size(res, res)
    shell, mtl = _jshell()
    w.load_model(_jvertices(shell), np.asarray(mtl, np.int32))


def _close(got, ref):
    return (np.abs(got - ref) <= 1e-3 * (1.0 + np.abs(ref))).all(-1).mean()


def test_worker_full_flow():
    worker.init(device='cpu')
    worker.set_size(16, 16)
    verts, mtlids = _cornell_vertices()
    worker.load_model(verts, mtlids)
    worker.load_materials([])
    worker.load_images([])
    worker.build_tree()
    worker.render()
    worker.render()
    img = worker.get_image()
    assert img.shape == (16, 16, 4)
    assert np.isfinite(img).all()
    assert img[..., :3].mean() > 0.01

    worker.render_preview()
    albedo = worker.get_image(1)
    assert np.isfinite(albedo).all()
    assert albedo[..., :3].max() > 0

    out = np.zeros(16 * 16 * 3, np.float32)
    worker.fast_export_image(out)
    assert out.max() > 0

    worker.clear()
    img2 = worker.get_image()
    assert (img2[..., 3] == 0).all()  # cleared film is empty (debug pink)


def test_worker_lights_and_camera():
    worker.init(device='cpu')
    worker.set_size(8, 8)
    verts, mtlids = _cornell_vertices()
    worker.load_model(verts, mtlids)
    worker.clear_lights()
    world = np.eye(4)
    world[:3, 3] = [0, 3.9, 0]
    worker.add_light(world, color=(10, 10, 10), size=0.8, type='AREA')
    worker.set_world_light((0.2, 0.2, 0.2, 1.0), -1)
    worker.set_camera(BENCH_CAMERA)
    worker.render()
    img = worker.get_image()
    assert np.isfinite(img).all()


def test_worker_mlt_engine():
    worker.init(engine='mlt', device='cpu')
    worker.set_size(8, 8)
    verts, mtlids = _cornell_vertices()
    worker.load_model(verts, mtlids)
    worker.render()
    img = worker.get_image()
    assert np.isfinite(img).all()
    assert worker._S.mlt_state.x.shape == (32, 64)  # one chain per pixel


def test_worker_engines_and_preview_sample_index():
    ''''brute' renders, set_engine drops the chains, and render_preview
    leaves the sample index where it was (the reference's quirk).'''
    _setup(worker, 8, engine='brute', device='cpu')
    worker.render()
    assert worker._S.sample_index == 1
    assert np.isfinite(worker.get_image()).all()
    worker.render_preview()
    worker.render_preview()
    assert worker._S.sample_index == 1
    assert (worker.get_image(2)[..., 3] == 1.0).all()  # one AOV sample
    worker.set_engine('mlt')
    worker.render()
    assert worker._S.mlt_state is not None
    worker.set_engine('path')
    assert worker._S.mlt_state is None
    with pytest.raises(AttributeError):
        worker.set_config(no_such_field=1)
    worker.set_engine('other')
    with pytest.raises(ValueError, match='engine'):
        worker.render()


def test_worker_path_image_matches_reference():
    _setup(jworker, 8)
    _setup(worker, 8, device='cpu')
    for w in (jworker, worker):
        w.render()
        w.render()
    ref, got = jworker.get_image(), worker.get_image()
    assert got.shape == ref.shape == (8, 8, 4)
    assert _close(got[..., :3], ref[..., :3]) >= 0.98


@pytest.mark.parametrize('writer', ['reference', 'port'])
def test_path_checkpoint_crosses_packages(writer, tmp_path):
    '''Two samples in one package, saved; the other package resumes and
    renders the third; against three uninterrupted samples of the
    writer.'''
    path = str(tmp_path / 'render.ckpt')
    src, dst = (jworker, worker) if writer == 'reference' \
        else (worker, jworker)
    kw = {'device': 'cpu'} if src is worker else {}
    _setup(src, 8, **kw)
    src.render()
    src.render()
    src.save_state(path)
    src.render()
    want = src.get_image()
    _setup(dst, 8, **({} if src is worker else {'device': 'cpu'}))
    assert dst.load_state(path)
    assert dst.get_size() == (8, 8) and int(dst._S.sample_index) == 2
    dst.render()
    got = dst.get_image()
    assert int(dst._S.sample_index) == 3
    assert _close(got[..., :3], want[..., :3]) >= 0.98


@pytest.mark.parametrize('engine', ['path', 'mlt'])
def test_checkpoint_resumes_bit_for_bit(engine, tmp_path):
    path = str(tmp_path / 'render.ckpt')
    _setup(worker, 8, engine=engine, device='cpu')
    worker.render()
    worker.render()
    worker.save_state(path)
    worker.render()
    want = worker.get_image()
    chains = worker._S.mlt_state
    _setup(worker, 8, device='cpu')  # a 'path' worker: the file restores
    assert worker.load_state(path)
    assert worker._S.engine == engine
    worker.render()
    np.testing.assert_array_equal(worker.get_image(), want)
    if engine == 'mlt':
        got = worker._S.mlt_state
        for a, b in ((got.x, chains.x), (got.l.x, chains.l.x),
                     (got.b_sum, chains.b_sum), (got.step, chains.step)):
            assert a.dtype == b.dtype and torch.equal(a, b)
    assert not worker.load_state(str(tmp_path / 'missing.ckpt'))


def test_reference_mlt_checkpoint_is_refused(tmp_path):
    path = str(tmp_path / 'mlt.ckpt')
    _setup(jworker, 4, engine='mlt')
    jworker.render()
    jworker.save_state(path)
    _setup(worker, 4, device='cpu')
    with pytest.raises(pickle.UnpicklingError, match='MLTState'):
        worker.load_state(path)


def test_load_model_from_obj(tmp_path):
    '''A quad and a triangle without normals (fan-triangulated, flat
    normals generated): the port's readobj gives the reference's
    vertices, and the worker renders them.'''
    path = str(tmp_path / 'model.obj')
    with open(path, 'w') as fp:
        fp.write('# a quad floor and a triangle\n'
                 'v -1 0 -1\nv 1 0 -1\nv 1 0 1\nv -1 0 1\n'
                 'v 0 1 0\nvt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n'
                 'usemtl floor\nf 1/1 2/2 3/3 4/4\nusemtl tri\nf 1 3 5\n')
    obj, jobj = readobj.readobj(path), jreadobj.readobj(path)
    assert obj['usemtl'] == jobj['usemtl'] == [(0, 'floor'), (2, 'tri')]
    for k in ('v', 'vt', 'vn', 'f'):
        np.testing.assert_array_equal(obj[k], jobj[k])
    np.testing.assert_array_equal(readobj.obj_to_vertices(obj),
                                  jreadobj.obj_to_vertices(jobj))
    worker.init(device='cpu')
    worker.set_size(8, 8)
    worker.load_model(path)
    assert worker._S.vertices.shape == (9, 8)
    worker.render()
    assert np.isfinite(worker.get_image()).all()


def test_config_matches_reference():
    fields = [(f.name, f.default) for f in dataclasses.fields(config.Config)]
    assert fields == [(f.name, f.default)
                      for f in dataclasses.fields(jconfig.Config)]
    assert config.DEFAULT == config.Config()
    worker.init(config=config.Config(mlt_sigma=0.02), device='cpu')
    worker.set_config(mlt_large_step_prob=0.5, engine='brute')
    assert worker._S.mlt_lsp == 0.5 and worker._S.mlt_sigma == 0.02
    assert worker.get_config().engine == 'brute' == worker._S.engine


def test_params_match_reference():
    got, ref = params.Params(), jparams.Params()
    for p in (got, ref):
        p.add('exposure', 1.0, 0.0, 4.0)
        p.add('exposure', 3.0)  # registered once: keeps the first
        p.add('gamma', 2.2, 1.0, 3.0)
        p.set('exposure', 9.0)  # clamped to the range
        p.set('gamma', 0.5)
    assert list(got.items()) == list(ref.items()) \
        == [('exposure', 4.0, 0.0, 4.0), ('gamma', 1.0, 1.0, 3.0)]
    assert got.get('gamma') == ref.get('gamma') and 'gamma' in got
    assert worker.globals_params() is worker._S.params


def test_trace_log_and_timed_match_reference(capsys, tmp_path):
    for t in (trace, jtrace):
        t.set_verbosity(2)
        t.log('TinaScene', 'built')
        t.log('TinaRender', 'debug line', level=2)
        t.set_verbosity(0)
        t.log('TinaScene', 'silent')
        t.set_verbosity(1)
    out = capsys.readouterr().out.splitlines()
    assert out == ['[TinaScene] built', '[TinaRender] debug line'] * 2
    x = torch.ones(3)
    with trace.timed('block', sync=x, quiet=True):
        x = x * 2.0
    with trace.timed('block', quiet=True) as box:
        box['sync'] = [x, {'y': x}]
    assert len(trace.timings['block']) == 2
    assert all(dt >= 0.0 for dt in trace.timings['block'])
    with trace.profile_trace(str(tmp_path)) as d:
        torch.ones(8).sum()
    assert os.path.exists(os.path.join(d, 'trace.json'))
