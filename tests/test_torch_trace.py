'''
The port's tracing (ptina_tpu_torch/utils/trace.py): spans, their
parents and self time, the ring, the profiler's view of them, the span
trees of a wavefront sample and a gradient step, the tree-walk counters,
the benchmark's readers of all of these, and the benchmark's launch sites.

On the CPU (Tier-1) everything but the device clock and the kernels'
counters.  The tests marked `cuda` skip without a card; on one:

    python -m pytest tests/test_torch_trace.py -q -m cuda --noconftest

they hold a span's device markers to the host clock and to a timed spin,
the on-mode walk counters to fused_trace_visits / blocked_cast_visits on
the same rays, and the launches and radiance bits of traced renders and
gradients to untraced ones.
'''

import re
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from ptina_tpu_torch import diff  # noqa: E402
from ptina_tpu_torch.engine import fused  # noqa: E402
from ptina_tpu_torch.engine.fused import fused_trace_diff  # noqa: E402
from ptina_tpu_torch.engine.path import render_sample  # noqa: E402
from ptina_tpu_torch.film import new_film  # noqa: E402
from ptina_tpu_torch.intersect import blocked, dense_cast  # noqa: E402
from ptina_tpu_torch.scenes import (cornell_box, cornell_highpoly,  # noqa
                                    cornell_monkey)
from ptina_tpu_torch.utils import trace  # noqa: E402

DEPTH = 5
RES = 8
# the benchmark harness's own profiler annotations
HARNESS_NAMES = ('frame', 'step', 'perfbench.segment')


@pytest.fixture
def rec():
    '''A clean recorder, tracing off before and after.'''
    trace.disable()
    trace.reset()
    yield trace.RECORDER
    trace.disable()
    trace.reset()


@pytest.fixture(scope='module')
def box():
    return cornell_box(device='cpu')


def _tree(records):
    '''{id: (name, parent name)} of spans() records.'''
    by_id = {r['id']: r for r in records}
    return [(r['name'], by_id[r['parent']]['name'] if r['parent'] in by_id
             else None) for r in records]


def _children(records, name):
    '''The names of the children of the first span called name.'''
    first = next(r for r in records if r['name'] == name)
    return [r['name'] for r in records if r['parent'] == first['id']]


def test_off_records_nothing_but_the_set_up_spans(rec, box, monkeypatch):
    cornell_box(device='cpu')
    render_sample(box, new_film(RES, RES, device='cpu'), 0)
    got = trace.summary()
    assert got['traced'] == {} and got['walks'] == {}
    assert set(got['always']) == {'scene.build', 'scene.tables',
                                  'scene.trees', 'scene.upload'}
    assert got['always']['scene.build']['count'] == 1
    assert {r['name'] for r in trace.spans()} == set(got['always'])
    assert not trace.tracing()
    made, real = [], trace.Recorder
    monkeypatch.setattr(trace, 'Recorder', lambda cap: made.append(cap)
                        or real(cap))
    with blocked._walks(4, 'cpu') as vis:  # warms a throwaway recorder
        assert vis is None
    for n in (33, 65, 33):
        trace.warm_walks('k', (n, 2, 2), -1, 'cpu')
    assert made == [1, 1] and trace.summary()['walks'] == {}


def test_parents_and_self_time_under_enable(rec):
    trace.enable()
    assert trace.tracing()
    with trace.span('outer', tag=1):
        time.sleep(0.002)
        with trace.span('inner'):
            time.sleep(0.003)
        with trace.span('inner'):
            pass
    got = trace.summary()['traced']
    assert got['inner']['count'] == 2 and got['outer']['count'] == 1
    inner, outer = got['inner']['host_ns'], got['outer']
    assert inner >= 3e6 and outer['host_ns'] >= inner + 2e6
    assert outer['self_ns'] == outer['host_ns'] - inner
    assert got['inner']['self_ns'] == inner
    assert got['outer']['device_ns'] is None  # no card
    records = trace.spans()
    assert _tree(records) == [('inner', 'outer'), ('inner', 'outer'),
                              ('outer', None)]
    assert records[-1]['attrs'] == {'tag': 1}
    assert all(r['end_ns'] >= r['start_ns'] for r in records)


def test_a_span_on_another_thread_takes_the_waiting_span_as_parent(rec):
    '''As autograd's device thread runs a backward while the calling
    thread waits inside grad.backward.'''
    trace.enable()
    with trace.span('waits'):
        worker = threading.Thread(target=lambda: trace.span('runs')
                                  .__enter__().__exit__(None, None, None))
        worker.start()
        worker.join(timeout=30)
        assert not worker.is_alive()
    assert _tree(trace.spans()) == [('runs', 'waits'), ('waits', None)]
    got = trace.summary()['traced']
    assert got['waits']['self_ns'] == got['waits']['host_ns'] \
        - got['runs']['host_ns']


def test_the_ring_keeps_the_newest_and_counts_the_dropped(rec, monkeypatch):
    small = trace.Recorder(cap=4)
    monkeypatch.setattr(trace, 'RECORDER', small)
    trace.enable()
    for k in range(10):
        with trace.span('s', k=k):
            pass
    got = trace.summary()
    assert got['traced']['s']['count'] == 10
    assert got['recorded'] == 10 and got['dropped'] == 6
    assert [r['attrs']['k'] for r in trace.spans()] == [6, 7, 8, 9]
    assert trace.summary() == got  # reading changes nothing
    small.reset()
    assert small.summary()['recorded'] == 0


def test_profiler_sees_the_spans_as_nested_user_annotations(rec, box,
                                                            tmp_path):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert trace.tracing()
        render_sample(box, new_film(RES, RES, device='cpu'), 0)
    assert not trace.tracing()
    events = [e for e in prof.events()
              if e.name in ('render.sample', 'wavefront.bounce',
                            'wavefront.cast')]
    assert all(getattr(e, 'is_user_annotation', True) for e in events)
    names = [e.name for e in events]
    assert names.count('render.sample') == 1
    assert names.count('wavefront.bounce') == DEPTH
    assert names.count('wavefront.cast') == 2 * DEPTH
    for e in events:
        if e.name != 'render.sample':
            assert e.cpu_parent is not None
            assert e.cpu_parent.name == ('render.sample'
                                         if e.name == 'wavefront.bounce'
                                         else 'wavefront.bounce')
    assert trace.summary()['traced']['render.sample']['count'] == 1
    with trace.profile_trace(str(tmp_path)) as d:
        render_sample(box, new_film(RES, RES, device='cpu'), 1)
    text = (Path(d) / 'trace.json').read_text()
    assert '"wavefront.cast"' in text and '"render.sample"' in text


def test_no_span_takes_a_harness_annotation_name():
    names = set()
    for src in (ROOT / 'ptina_tpu_torch').rglob('*.py'):
        names |= set(re.findall(r"span\(\s*'([^']+)'", src.read_text()))
    assert {'scene.build', 'kernels.build', 'render.sample',
            'wavefront.bounce', 'wavefront.cast', 'grad.step',
            'grad.forward', 'grad.backward', 'grad.recompute',
            'grad.inner_backward', 'world.fetch'} <= names
    assert not names & set(HARNESS_NAMES)


def test_wavefront_sample_span_tree_and_bits(rec, box):
    off = render_sample(box, new_film(RES, RES, device='cpu'), 3)
    trace.enable()
    on = render_sample(box, new_film(RES, RES, device='cpu'), 3)
    assert torch.equal(off, on)
    records = trace.spans()
    assert _children(records, 'render.sample') == ['wavefront.bounce'] \
        * DEPTH
    assert records[-1]['attrs'] == {'route': 'wavefront'}
    bounces = [r for r in records if r['name'] == 'wavefront.bounce']
    for b in bounces:
        kids = [r for r in records if r['parent'] == b['id']]
        assert [(c['name'], c['attrs'].get('kind')) for c in kids] == \
            [('wavefront.cast', 'shaded'), ('world.fetch', None),
             ('wavefront.cast', 'shadow')]
    got = trace.summary()['traced']
    assert got['world.fetch']['count'] == DEPTH
    assert got['wavefront.bounce']['self_ns'] == \
        got['wavefront.bounce']['host_ns'] \
        - got['wavefront.cast']['host_ns'] - got['world.fetch']['host_ns']


def _target(seed=0):
    return torch.tensor(np.random.RandomState(seed).uniform(
        0.0, 1.0, (RES, RES, 3)).astype(np.float32))


def test_inverse_step_span_tree_and_bits(rec, box):
    target = _target()
    s_off, l_off = diff.inverse_render_step(box, target, 2)
    trace.enable()
    s_on, l_on = diff.inverse_render_step(box, target, 2)
    assert torch.equal(l_off, l_on)
    assert torch.equal(s_off.materials.fac, s_on.materials.fac)
    records = trace.spans()
    assert _children(records, 'grad.step') == ['grad.forward',
                                               'grad.backward']
    assert _children(records, 'grad.forward') == ['render.sample']
    got = trace.summary()['traced']
    assert got['grad.step']['count'] == 1
    assert got['render.sample']['count'] == 1


def test_pair_backward_splits_into_recompute_and_inner_backward(rec, box):
    target, path = _target(1), ('materials', 'fac')
    l_off, g_off = diff._loss_and_grad(box, target, path,
                                       trace_diff=fused_trace_diff)
    trace.enable()
    l_on, g_on = diff._loss_and_grad(box, target, path,
                                     trace_diff=fused_trace_diff)
    assert torch.equal(l_off, l_on) and torch.equal(g_off, g_on)
    records = trace.spans()
    assert _children(records, 'grad.backward') == ['grad.recompute',
                                                   'grad.inner_backward']
    assert _children(records, 'grad.recompute') == ['wavefront.bounce'] \
        * DEPTH
    got = trace.summary()['traced']
    back = got['grad.backward']
    assert back['self_ns'] == back['host_ns'] \
        - got['grad.recompute']['host_ns'] \
        - got['grad.inner_backward']['host_ns']


def _walks_by_loop(visits):
    '''The four sums of one launch's counters, warp by warp in numpy.'''
    v = visits.reshape(visits.shape[0], -1, 2).astype(np.int64)
    made = int((v[..., 0] >= 0).sum())
    inner = int(np.clip(v[..., 0], 0, None).sum())
    leaves = int(np.clip(v[..., 1], 0, None).sum())
    slots = 0
    for w in range(0, v.shape[0], 32):
        for k in range(v.shape[1]):
            slots += 32 * max(0, int(v[w:w + 32, k, 1].max()))
    return {'casts': made, 'inner': inner, 'leaves': leaves,
            'leaf_slots': slots}


@pytest.mark.parametrize('shape', [(96, 5, 2, 2), (77, 1, 2), (5, 3, 2)],
                         ids=['megakernel', 'blocked_tail', 'one_warp'])
def test_walk_counts_sum_the_warps(rec, shape):
    rng = np.random.default_rng(sum(shape))
    visits = rng.integers(0, 12, shape).astype(np.int32)
    visits[rng.random(shape[:-1]) < 0.3] = -1  # casts not made
    for _ in range(2):
        with trace.walk_buffer('k', shape, -1, 'cpu') as buf:
            buf.copy_(torch.from_numpy(visits))
    want = {k: 2 * v for k, v in _walks_by_loop(visits).items()}
    assert trace.summary()['walks'] == {'k': want}


def test_walk_buffers_are_counted_a_batch_at_a_time(rec):
    '''Launches fill their slots of a batch; a full batch is counted
    after its last launch and refilled, a partial one at summary().'''
    rng = np.random.default_rng(5)
    filled = []
    for j in range(2 * trace.WALK_BATCH + 3):
        with trace.walk_buffer('k', (40, 3, 2), -1, 'cpu') as buf:
            assert bool((buf == -1).all())  # a fresh or refilled slot
            got = rng.integers(0, 9, (40, 3, 2)).astype(np.int32)
            got[rng.random((40, 3)) < 0.3] = -1  # casts not made
            buf.copy_(torch.from_numpy(got))  # as the launch fills it
        filled.append(got)
        if j == trace.WALK_BATCH - 1:  # counted on the device already
            assert trace.RECORDER.walks['k'][0] == trace.WALK_BATCH * 120
    each = [_walks_by_loop(f) for f in filled]  # warps end at a launch
    want = {k: sum(e[k] for e in each) for k in each[0]}
    assert trace.summary()['walks'] == {'k': want}
    assert trace.summary()['walks'] == {'k': want}


def test_walk_buffer_counts_one_launch_in_every(rec):
    handed = []
    for j in range(7):
        with trace.walk_buffer('k', (32, 2), 0, 'cpu', every=3) as buf:
            handed.append(buf is not None)
            if buf is not None:
                buf.fill_(1)
    assert handed == [True, False, False, True, False, False, True]
    assert trace.summary()['walks']['k'] == {
        'casts': 3 * 32, 'inner': 3 * 32, 'leaves': 3 * 32,
        'leaf_slots': 3 * 32}


def test_timed_always_records_and_is_gone_from_timings(rec):
    assert not hasattr(trace, 'timings')
    x = torch.ones(3)
    with trace.timed('block', sync=x, quiet=True) as box_:
        box_['sync'] = x
    got = trace.summary()['always']['block']
    assert got['count'] == 1 and got['host_ns'] > 0
    assert trace.summary()['traced'] == {}


# ---- the benchmark's readers of the recorder

READERS = ('setup.scene_s', 'setup.kernels_s', 'path_kernel.nodes_per_cast',
           'path_kernel.leaf_slots_used', 'blocked_casts.nodes_per_cast',
           'blocked_casts.leaf_slots_used', 'wavefront.cast_host_ms',
           'wavefront.shade_host_ms', 'grad.recompute_ms',
           'grad.inner_backward_ms')


def _agg(count, host_ns, self_ns=None, device_ns=None):
    return {'count': count, 'host_ns': host_ns,
            'self_ns': host_ns if self_ns is None else self_ns,
            'device_ns': device_ns, 'device_count': count if device_ns
            else 0}


BY_HAND = {
    'traced': {'render.sample': _agg(8, 400e6),
               'wavefront.bounce': _agg(40, 360e6, 280e6),
               'wavefront.cast': _agg(80, 80e6),
               'grad.step': _agg(4, 1600e6, device_ns=1500e6),
               'grad.recompute': _agg(4, 500e6, device_ns=480e6),
               'grad.inner_backward': _agg(4, 600e6, device_ns=800e6)},
    'always': {'scene.build': _agg(2, 1.5e9),
               'kernels.build': _agg(3, 0.25e9)},
    'walks': {'path_kernel': {'casts': 1000, 'inner': 11000,
                              'leaves': 3000, 'leaf_slots': 6400},
              'blocked_casts': {'casts': 500, 'inner': 12500,
                                'leaves': 4000, 'leaf_slots': 16000}},
    'recorded': 0, 'dropped': 0}
WANT = {'setup.scene_s': 1.5, 'setup.kernels_s': 0.25,
        'path_kernel.nodes_per_cast': 11.0,
        'path_kernel.leaf_slots_used': 100.0 * 3000 / 6400,
        'blocked_casts.nodes_per_cast': 25.0,
        'blocked_casts.leaf_slots_used': 25.0,
        'wavefront.cast_host_ms': 10.0, 'wavefront.shade_host_ms': 35.0,
        'grad.recompute_ms': 120.0, 'grad.inner_backward_ms': 200.0}


def _reader(name):
    from perfbench.harness import manifest as mf
    return mf.reader(name)


@pytest.mark.parametrize('name', READERS)
def test_reader_is_none_on_an_empty_recorder(rec, name):
    assert _reader(name).read({}) is None


@pytest.mark.parametrize('name', READERS)
def test_reader_on_a_recorder_filled_by_hand(rec, monkeypatch, name):
    monkeypatch.setattr(trace, 'summary', lambda: BY_HAND)
    assert _reader(name).read({}) == pytest.approx(WANT[name], rel=1e-12)


def test_readers_are_listed_with_their_cells():
    from perfbench.harness import manifest as mf
    man = mf.manifest()
    entries = {m['name']: m for m in man['per_layer']}
    for name in READERS:
        assert entries[name]['workloads'], name
    assert entries['setup.scene_s']['workloads'] == [
        w['name'] for w in man['workloads']]


def test_host_readers_on_a_traced_cpu_sample(rec):
    scene = cornell_box(device='cpu')
    trace.enable()
    render_sample(scene, new_film(RES, RES, device='cpu'), 0)
    got = trace.summary()
    assert _reader('setup.scene_s').read({}) == pytest.approx(
        got['always']['scene.build']['host_ns'] * 1e-9)
    cast = _reader('wavefront.cast_host_ms').read({})
    shade = _reader('wavefront.shade_host_ms').read({})
    sample_ms = got['traced']['render.sample']['host_ns'] * 1e-6
    assert 0 < cast and 0 < shade and cast + shade <= sample_ms
    for name in ('grad.recompute_ms', 'path_kernel.nodes_per_cast',
                 'setup.kernels_s'):
        assert _reader(name).read({}) is None  # no card, no kernel


# ---- the harness's launch sites (its kernel readings go silent on a
# renamed one)

def test_every_launch_site_names_a_launch_in_the_port():
    import importlib
    import inspect
    from perfbench.harness import trace as htrace
    for (mod_name, fn_name), kernel in htrace.LAUNCH_SITES.items():
        fn = getattr(importlib.import_module(mod_name), fn_name, None)
        assert callable(fn), (mod_name, fn_name)
        src = inspect.getsource(fn)
        assert 'LAUNCHES[' in src and 'raise_on(' in src, (mod_name, fn_name)
        assert kernel in src, (mod_name, fn_name, kernel)
    for mod_name in htrace.COUNTERS:
        launches = getattr(importlib.import_module(mod_name), 'LAUNCHES',
                           None)
        assert isinstance(launches, dict) and launches, mod_name


# ---- on the card

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (CUDA kernels have no CPU mode)')
    return torch.device('cuda')


def _launches():
    return {**dense_cast.LAUNCHES, **fused.LAUNCHES, **blocked.LAUNCHES}


def _grew(before):
    return {k: v - before[k] for k, v in _launches().items()
            if v != before[k]}


@pytest.mark.cuda
def test_a_marker_after_a_synchronise_lands_on_the_host_clock(rec, dev):
    torch.ones(1, device=dev)
    trace.enable()
    with trace.span('first'):  # takes the anchor
        pass
    offs = []
    for _ in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter_ns()
        with trace.span('marker'):
            pass
        offs.append(trace.spans()[-1]['device_start_ns'] - t)
    assert all(abs(o) < 100e3 for o in offs), offs


@pytest.mark.cuda
def test_a_device_spin_shows_as_device_ms(rec, dev):
    torch.ones(1, device=dev)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    torch.cuda._sleep(20_000_000)
    end.record()
    torch.cuda.synchronize()
    spin_ms = start.elapsed_time(end)
    trace.enable()
    with trace.span('spin'):
        torch.cuda._sleep(20_000_000)
    got = trace.summary()['traced']['spin']
    assert got['device_count'] == 1
    assert got['device_ns'] * 1e-6 == pytest.approx(spin_ms, rel=0.1)
    assert got['device_ns'] > 5 * got['host_ns']


@pytest.mark.cuda
def test_megakernel_counters_equal_fused_trace_visits(rec, dev):
    from ptina_tpu_torch.sampling.sobol import sobol_block
    scene = cornell_monkey(device=dev)
    pt = sobol_block(7, 2 + 6 * DEPTH)
    _, visits = fused.fused_trace_visits(scene, pt, 64, 48)
    want = _walks_by_loop(visits.cpu().numpy())
    trace.enable()
    fused.fused_trace_primary(scene, pt, 64, 48)
    assert trace.summary()['walks'] == {'path_kernel': want}
    assert want['casts'] > 64 * 48 and 0 < want['leaves'] \
        <= want['leaf_slots']


@pytest.mark.cuda
def test_blocked_counters_equal_blocked_cast_visits(rec, dev):
    from ptina_tpu_torch.camera import camera_rays
    from ptina_tpu_torch.engine.path import pixel_grid
    scene = cornell_highpoly(nu=48, nv=24, accel='blocked', device=dev)
    nx, ny = 40, 30  # 1,200 rays: a partial last warp
    ii, jj = pixel_grid(nx, ny, device=dev)
    ro, rd = camera_rays(scene.cam_v2w, (ii.float() + 0.5) / nx * 2 - 1,
                         (jj.float() + 0.5) / ny * 2 - 1)
    avoid = torch.full((nx * ny,), -1, dtype=torch.int32, device=dev)
    tmax = torch.full((nx * ny,), 0.5, device=dev)
    tables = (scene.face_coef, scene.face_attr, scene.block_bounds,
              scene.node_bounds)
    shade, any_ = blocked.blocked_cast_visits(ro, rd, avoid, tmax, *tables)
    want = {k: a + b for (k, a), b in zip(
        _walks_by_loop(shade.cpu().numpy()).items(),
        _walks_by_loop(any_.cpu().numpy()).values())}
    trace.enable()
    blocked.blocked_cast_shade(ro, rd, avoid, *tables)
    blocked.blocked_cast_any(ro, rd, avoid, tmax, scene.face_coef,
                             *tables[2:])
    assert trace.summary()['walks'] == {'blocked_casts': want}
    assert want['casts'] == 2 * nx * ny


def _renders(scene, dev, fused_route):
    before = _launches()
    film = render_sample(scene, new_film(64, 64, device=dev), 5,
                         fused=fused_route)
    torch.cuda.synchronize()
    return film.cpu(), _grew(before)


@pytest.mark.cuda
@pytest.mark.parametrize('which', ['megakernel', 'dense_wavefront',
                                   'blocked_wavefront'])
def test_tracing_changes_no_launch_and_no_bit(rec, dev, which):
    if which == 'blocked_wavefront':
        scene, route = cornell_highpoly(nu=48, nv=24, accel='blocked',
                                        device=dev), None
    else:
        scene = cornell_monkey(device=dev)
        route = which == 'megakernel'
    off, n_off = _renders(scene, dev, route)
    trace.enable()
    on, n_on = _renders(scene, dev, route)
    assert n_on == n_off and n_on
    assert torch.equal(on, off)
    assert trace.summary()['traced']['render.sample']['device_count'] == 1


@pytest.mark.cuda
def test_traced_gradient_is_the_untraced_one(rec, dev):
    scene = cornell_monkey(device=dev)
    target = torch.rand(64, 64, 3, generator=torch.Generator().manual_seed(3))
    before = _launches()
    l_off, g_off = diff.material_grad(scene, target.to(dev))
    torch.cuda.synchronize()
    n_off = _grew(before)
    trace.enable()
    before = _launches()
    l_on, g_on = diff.material_grad(scene, target.to(dev))
    torch.cuda.synchronize()
    assert _grew(before) == n_off == {'path': 1, 'shade': DEPTH,
                                      'any': DEPTH}
    assert torch.equal(l_on, l_off) and torch.equal(g_on, g_off)
    got = trace.summary()['traced']
    for name in ('grad.backward', 'grad.recompute', 'grad.inner_backward'):
        assert got[name]['device_ns'] > 0, name
    records = trace.spans()
    assert _children(records, 'grad.backward') == ['grad.recompute',
                                                   'grad.inner_backward']
