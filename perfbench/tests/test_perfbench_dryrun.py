'''Each traffic mix of BENCHMARK.json runs a two-unit dry run at a test
size on the CPU through the program's plain route, is judged correct, and
a run's last line has the result's keys.'''

import pytest

from perfbench import run as bench_run
from perfbench.harness import manifest as mf

from conftest import shrink

MAN = mf.manifest()
TRAFFIC = sorted({w['traffic'] for w in MAN['workloads']})


@pytest.mark.parametrize('traffic', TRAFFIC)
def test_two_units(traffic):
    cell = bench_run.Cell(MAN, 'monkey.progressive', 2718281828)
    cell.device = 'cpu'
    cell.traffic = mf.traffic(traffic)
    shrink(cell)
    name = next(w['name'] for w in MAN['workloads']
                if w['traffic'] == traffic)
    drv = mf.driver(cell.traffic['kind'])
    st = drv.setup(cell)
    window = drv.window(st, 0.0, False, units=2)
    assert window['attempted'] == 2 and window['failed'] == 0
    window.update(setup_s=1.0, cpu_s=0.5, config=cell.config,
                  device_kind='cpu')
    for m in mf.cell_metrics(MAN, name, False):
        assert mf.reader(m['name']).read(window) > 0
    checks = drv.check(st, window, mf.limits(name))
    assert checks and all(c['value'] <= c['limit'] for c in checks.values())


@pytest.mark.parametrize('workload', ['monkey.progressive', 'monkey.inverse'])
def test_last_line_keys(tiny_run, workload):
    line = tiny_run(workload, 1618033988)
    assert list(line) == ['correct', 'attempted', 'failed', 'metrics',
                          'device', 'checks']
    assert set(line['device']) == {'platform', 'kind', 'count',
                                   'memory_peak_bytes'}
    assert line['device']['count'] == 1
    names = {m['name'] for m in mf.cell_metrics(MAN, workload, False)}
    assert set(line['metrics']) == names
    for m in line['metrics'].values():
        assert set(m) == {'value', 'unit'} and m['value'] > 0
    for c in line['checks'].values():
        assert set(c) == {'value', 'limit'}
