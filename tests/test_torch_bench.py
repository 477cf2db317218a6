'''
The port's benchmark harness (ptina_tpu_torch.bench) and its example
(ptina_tpu_torch.examples.benchmark) on the CPU, at 8x8 films:

  * its metric table mirrors root bench.py's main() (read with ast: the
    _emit names, baselines and units, and the res / spp of the timed
    render behind each), one case per metric, with `torch_` before each
    name, in the same order, the cornell headline last;
  * the timed window's film equals one engine.path.render of the same
    samples bit for bit, and time_mlt's film a direct render_mlt from the
    same seeded generator;
  * the 32-ray float64 oracle on a small blocked scene;
  * the launch check raises on counts that do not match the route;
  * the example prints the reference's line; main() refuses the CPU.

On the card the harness runs as `python -m ptina_tpu_torch.bench`
(chip_smoke.py's bench phase).
'''

import ast
import os
import re

import numpy as np
import pytest
import torch

from ptina_tpu_torch import bench
from ptina_tpu_torch.engine.mlt import mlt_init, render_mlt
from ptina_tpu_torch.engine.path import render
from ptina_tpu_torch.examples import benchmark
from ptina_tpu_torch.film import new_film
from ptina_tpu_torch.intersect import dispatch
from ptina_tpu_torch.scenes import cornell_box, cornell_highpoly

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _value(node, env):
    '''A numeric expression of root bench.py: constants, names bound in
    its main() and products.'''
    return eval(compile(ast.Expression(node), 'bench.py', 'eval'),
                {'__builtins__': {}}, dict(env))


def _reference_rows():
    '''(name, baseline, unit, res, spp) of each _emit in root bench.py's
    main(), in order; res / spp from the measuring call behind it
    (_time_render directly or inside a helper; _time_mlt has no spp).'''
    with open(os.path.join(ROOT, 'bench.py')) as fh:
        tree = ast.parse(fh.read())
    funcs = {f.name: f for f in tree.body if isinstance(f, ast.FunctionDef)}

    def timed(call, env):
        name = call.func.id
        if name == '_time_render':
            return _value(call.args[1], env), _value(call.args[2], env)
        if name == '_time_mlt':
            return _value(call.args[1], env), None
        inner = [c for c in ast.walk(funcs[name]) if isinstance(c, ast.Call)
                 and getattr(c.func, 'id', '') == '_time_render']
        return timed(inner[0], {})

    env, measured, rows = {}, {}, []
    for stmt in funcs['main'].body:
        if isinstance(stmt, ast.Assign) and isinstance(stmt.value, ast.Tuple):
            env.update(zip((t.id for t in stmt.targets[0].elts),
                           (_value(v, env) for v in stmt.value.elts)))
        elif isinstance(stmt, ast.Assign) \
                and isinstance(stmt.value, ast.Call) \
                and getattr(stmt.value.func, 'id', '') in (
                    '_time_render', '_time_mlt', *funcs):
            measured[stmt.targets[0].id] = timed(stmt.value, env)
        elif isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call) \
                and getattr(stmt.value.func, 'id', '') == '_emit':
            args, kw = stmt.value.args, {k.arg: k.value
                                         for k in stmt.value.keywords}
            unit = _value(kw['unit'], env) if 'unit' in kw else 'samples/s'
            rows.append((args[0].value, _value(args[2], env), unit,
                         *measured[args[1].id]))
    return rows


REFERENCE = _reference_rows()


def test_the_reference_has_eight_metrics_and_the_port_as_many():
    assert len(REFERENCE) == 8
    assert len(bench.CONFIGS) == len(REFERENCE)
    assert bench.CONFIGS[-1].metric == 'torch_sps_cornell_512x512_32spp'


@pytest.mark.parametrize('i', range(len(REFERENCE)),
                         ids=[r[0] for r in REFERENCE])
def test_configs_mirror_root_bench(i):
    name, baseline, unit, res, spp = REFERENCE[i]
    cfg = bench.CONFIGS[i]
    assert cfg.metric == 'torch_' + name
    assert (cfg.baseline, cfg.unit, cfg.res, cfg.spp) == \
        (baseline, unit, res, spp)
    assert cfg.route in ('megakernel', 'blocked wavefront', 'mlt')


def test_timed_window_equals_one_render(monkeypatch):
    monkeypatch.setattr(bench, 'MAX_FRAMES', 2)
    scene = cornell_box(device='cpu')
    timed = bench.time_render(scene, 8, 2)
    assert timed.samples == 4 and timed.seconds > 0
    assert np.isfinite(timed.value) and timed.value > 0
    assert timed.host['cpu_seconds'] >= 0
    assert timed.host['device_mallocs'] == 0  # a CPU film: no cudaMalloc
    ref = render(scene, new_film(8, 8, device='cpu'), 0, spp=timed.samples)
    assert torch.equal(timed.film, ref)


def test_time_mlt_equals_render_mlt():
    scene = cornell_box(device='cpu')
    timed = bench.time_mlt(scene, 8, nchains=64, steps=1, rounds=1)
    assert np.isfinite(timed.value) and timed.value > 0
    assert timed.samples == 1
    state = mlt_init(64, generator=torch.Generator('cpu').manual_seed(1),
                     device='cpu')
    film = new_film(8, 8, device='cpu')
    for _ in range(2):  # the warm-up round, then the timed one
        state, film = render_mlt(scene, state, film, steps=1)
    assert torch.equal(timed.film, film)


def test_oracle_agreement_on_a_small_blocked_scene():
    scene = cornell_highpoly(nu=48, nv=24, accel='blocked', device='cpu')
    assert scene.block_bounds.shape[0] == 5
    assert dispatch.route(scene.face_coef.shape[0], scene.accel) == 'blocked'
    assert bench.oracle_agreement(scene) >= 31


def _timed(samples, **launches):
    return bench.Timed(1.0, samples, 1.0,
                       {**{k: 0 for k in bench.launch_counts()}, **launches},
                       None, {})


@pytest.mark.parametrize('route,samples,launches', [
    ('megakernel', 96, {'path': 96}),
    ('mlt', 16, {'path': 16}),
    ('blocked wavefront', 48, {'blocked_shade': 240, 'blocked_any': 240}),
])
def test_launch_check_by_route(route, samples, launches):
    bench.check_launches(route, _timed(samples, **launches))
    wrong = [_timed(samples + 1, **launches),
             _timed(samples, **launches, shade=1)]
    if route == 'blocked wavefront':
        wrong.append(_timed(samples, blocked_shade=5 * samples))
        wrong.append(_timed(samples, **launches, path=samples))
    else:
        wrong.append(_timed(samples, path=samples - 1))
        wrong.append(_timed(samples, blocked_shade=5 * samples))
    for t in wrong:
        with pytest.raises(RuntimeError):
            bench.check_launches(route, t)
    with pytest.raises(ValueError):
        bench.expected_launches('somewhere', samples)


def test_example_prints_the_reference_line(capsys, monkeypatch):
    monkeypatch.setattr(bench, 'MAX_FRAMES', 2)
    sps = benchmark.main('cornell_box', spp=1, res=8, device='cpu')
    out = capsys.readouterr().out.strip().splitlines()[-1]
    assert re.fullmatch(
        r'cornell_box: \d+\.\d{3} sps \(1 spp frames, 8x8\)', out), out
    assert out == f'cornell_box: {sps:.3f} sps (1 spp frames, 8x8)'


def test_main_refuses_the_cpu():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    with pytest.raises(SystemExit) as e:
        bench.main()
    assert e.value.code != 0
