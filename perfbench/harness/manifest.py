'''
What a run is made of, found by name: the workload in BENCHMARK.json, its
configuration (perfbench/configs/<config>.json and the frozen scene family
it names, perfbench/scenes/<scene>.py), its traffic mix
(perfbench/traffic/<traffic>.json, read by the driver its `kind` names,
perfbench/drivers/<kind>.py), its limits (perfbench/limits/<workload>.json)
and the readers of its metrics (perfbench/metrics/<metric>.py).  A cell,
a mix or a metric that a later change adds is a file of its own here;
nothing in this module names one.
'''

import importlib
import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
MANIFEST = ROOT / 'BENCHMARK.json'


def _json(path):
    with open(path, encoding='utf-8') as f:
        return json.load(f)


def manifest():
    '''BENCHMARK.json; raises FileNotFoundError where it is missing.'''
    return _json(MANIFEST)


def config(man, name):
    '''The configuration entry and its file's contents, by name.'''
    entry = next((c for c in man['configs'] if c['name'] == name), None)
    if entry is None:
        raise KeyError(f'no configuration {name!r} in {MANIFEST.name}')
    return entry, _json(ROOT / entry['file'])


def workload(man, name):
    entry = next((w for w in man['workloads'] if w['name'] == name), None)
    if entry is None:
        raise KeyError(f'no workload {name!r} in {MANIFEST.name}')
    return entry


def traffic(name):
    return _json(BENCH / 'traffic' / f'{name}.json')


def limits(name):
    return _json(BENCH / 'limits' / f'{name}.json')


def scene_family(name):
    return importlib.import_module(f'perfbench.scenes.{name}')


def driver(kind):
    return importlib.import_module(f'perfbench.drivers.{kind}')


def reader(metric):
    '''The module perfbench/metrics/<metric>.py (its read(window) returns
    the metric's value, or None where the window has nothing to read).'''
    path = BENCH / 'metrics' / f'{metric}.py'
    spec = importlib.util.spec_from_file_location(
        f'perfbench_metric_{metric.replace(".", "_")}', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reports(metric, workload_name):
    '''Whether a metric entry is reported in the workload.'''
    return workload_name in metric.get('workloads', [workload_name])


def cell_metrics(man, workload_name, traced):
    '''The metric entries a run of the workload reports: the end-to-end
    ones untraced; traced, the per-layer ones that list it, or that list
    no cells and move an end-to-end metric the workload reports.'''
    e2e = {m['name'] for m in man['end_to_end']
           if reports(m, workload_name)}
    if not traced:
        return [m for m in man['end_to_end'] if m['name'] in e2e]
    return [m for m in man['per_layer']
            if (workload_name in m['workloads'] if 'workloads' in m
                else m['moves'] in e2e)]
