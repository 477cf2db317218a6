'''The envmap.inverse cell on the CPU: its traffic mix's two-unit dry run
on its own configuration (the 1024 x 2048 environment, a test-size film)
through the program's plain route, judged correct; and the readers of
its world-fetch metrics on a fake summary(): grad.world_fetch_ms (the
world.fetch spans' device ms over the grad.step count),
world.miss_share and world.texels_reached (the program's `world`
counter), each reading nothing where the program recorded nothing (the
parent's program, an untextured world).'''

import pytest

from perfbench import run as bench_run
from perfbench.harness import manifest as mf

from conftest import shrink

MAN = mf.manifest()


def test_two_units_on_its_own_cell():
    cell = bench_run.Cell(MAN, 'envmap.inverse', 3141592653)
    cell.device = 'cpu'
    shrink(cell)
    assert cell.inputs['images'][0].shape == (1024, 2048, 3)
    drv = mf.driver(cell.traffic['kind'])
    st = drv.setup(cell)
    window = drv.window(st, 0.0, False, units=2)
    assert window['attempted'] == 2 and window['failed'] == 0
    window.update(setup_s=1.0, cpu_s=0.5, config=cell.config,
                  device_kind='cpu')
    for m in mf.cell_metrics(MAN, 'envmap.inverse', False):
        assert mf.reader(m['name']).read(window) > 0
    checks = drv.check(st, window, mf.limits('envmap.inverse'))
    assert checks and all(c['value'] <= c['limit'] for c in checks.values())


def _fake(monkeypatch, traced=None, counts=None):
    from ptina_tpu_torch.utils import trace
    got = {'traced': traced or {}}
    if counts is not None:
        got['counts'] = counts
    monkeypatch.setattr(trace, 'summary', lambda: got)


def _span(count, device_ns=None):
    return {'count': count, 'host_ns': 1000 * count, 'self_ns': 10,
            'device_ns': device_ns, 'device_count': count if device_ns
            else 0}


def test_world_fetch_ms(monkeypatch):
    _fake(monkeypatch, {'world.fetch': _span(50, 25_000_000),
                        'grad.step': _span(10)})
    assert mf.reader('grad.world_fetch_ms').read({}) == pytest.approx(2.5)


@pytest.mark.parametrize('traced', [
    {}, {'grad.step': _span(10)}, {'world.fetch': _span(50, 10)},
    {'world.fetch': _span(50), 'grad.step': _span(10)}])
def test_world_fetch_ms_reads_nothing(monkeypatch, traced):
    _fake(monkeypatch, traced)
    assert mf.reader('grad.world_fetch_ms').read({}) is None


def test_world_counter_shares(monkeypatch):
    _fake(monkeypatch, counts={'world': [1000, 250, 300, 20000]})
    assert mf.reader('world.miss_share').read({}) == pytest.approx(25.0)
    assert mf.reader('world.texels_reached').read({}) == pytest.approx(1.5)


@pytest.mark.parametrize('counts', [None, {}, {'texel_rows': [4, 2, 1]},
                                    {'world': [0, 0, 0, 0]}])
def test_world_counter_reads_nothing(monkeypatch, counts):
    _fake(monkeypatch, counts=counts)
    assert mf.reader('world.miss_share').read({}) is None
    assert mf.reader('world.texels_reached').read({}) is None


def test_untextured_world_reads_no_texels(monkeypatch):
    _fake(monkeypatch, counts={'world': [1000, 250, 0, 0]})
    assert mf.reader('world.miss_share').read({}) == pytest.approx(25.0)
    assert mf.reader('world.texels_reached').read({}) is None
