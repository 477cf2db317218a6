'''BENCHMARK.json parses, keeps to the manifest's form, and every
configuration, traffic mix, limit file, driver and metric it names is
found by name.'''

import json
import re

import pytest

from perfbench.harness import manifest as mf

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.\-]{1,16}$')
SOURCES = {'device_trace', 'program_span', 'program_counter', 'host_clock'}


@pytest.fixture(scope='module')
def man():
    return mf.manifest()


def test_top_level_keys(man):
    assert set(man) == {'command', 'paths', 'run_seconds', 'configs',
                        'workloads', 'end_to_end', 'per_layer'}
    assert man['command'] == ['python3', 'perfbench/run.py']
    assert man['paths'] == ['perfbench']
    assert 1 <= man['run_seconds'] <= 51
    assert len(json.dumps(man)) < 64 * 1024


def test_names_units_and_bounds(man):
    names = [m['name'] for k in ('end_to_end', 'per_layer') for m in man[k]]
    names += [c['name'] for c in man['configs']]
    names += [w['name'] for w in man['workloads']]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    for k in ('end_to_end', 'per_layer'):
        for m in man[k]:
            assert UNIT.match(m['unit']) and m['better'] in ('lower',
                                                              'higher')
            assert m['source'] in SOURCES
    for m in man['end_to_end']:
        assert m['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= m['bound'] <= 0.25
    assert any(m['name'] == 'setup_s' for m in man['end_to_end'])


@pytest.mark.parametrize('kind', ['configs', 'workloads'])
def test_entries_found(man, kind):
    for entry in man[kind]:
        if kind == 'configs':
            entry_, cfg = mf.config(man, entry['name'])
            assert cfg['name'] == entry['name']
            assert mf.scene_family(cfg['scene']).build(cfg)['vertices'] \
                .shape[0] == 3 * cfg['faces'] or cfg['faces'] > 10000
        else:
            assert entry['chips'] in (1, 4)
            tr = mf.traffic(entry['traffic'])
            drv = mf.driver(tr['kind'])
            for fn in ('setup', 'window', 'unit', 'check'):
                assert callable(getattr(drv, fn))
            assert mf.limits(entry['name'])['compare']
            mf.config(man, entry['config'])


def test_every_metric_has_a_reader(man):
    for k in ('end_to_end', 'per_layer'):
        for m in man[k]:
            assert callable(mf.reader(m['name']).read)


def test_every_cell_reports_its_metrics(man):
    e2e = {m['name']: m for m in man['end_to_end']}
    for w in man['workloads']:
        got = {m['name'] for m in mf.cell_metrics(man, w['name'], False)}
        assert 'setup_s' in got and len(got) >= 2
        layer = mf.cell_metrics(man, w['name'], True)
        assert layer
        for m in layer:
            assert mf.reports(e2e[m['moves']], w['name'])


def test_per_layer_cells_exist(man):
    cells = {w['name'] for w in man['workloads']}
    for m in man['per_layer']:
        assert set(m.get('workloads', [])) <= cells
