'''
The benchmark of ptina_tpu_torch, the PyTorch/CUDA path tracer, on
NVIDIA cards.  From the root of a checkout:

    python perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

runs one cell of BENCHMARK.json: set-up (scene build, kernel builds,
warm-up of the cell's shapes), a closed-loop window of `seconds`, then
the check of what the window produced against the plain reference in
perfbench/plainref (which imports nothing of the program).  The last line
of standard output is one JSON object: correct, attempted, failed,
metrics (the cell's end-to-end metrics; with --trace 1 its per-layer
ones), device, with --trace 1 a breakdown, and last the numbers compared
with their limits, which also end standard error.  An earlier line,
{"host": ...}, carries the host's speed and CPU quota around the window.

Exits non-zero and prints no result without the cards the cell asks for,
when BENCHMARK.json is missing, or when a JAX module was loaded.
'''

import os
import time

T0 = time.perf_counter()


def _process_age():
    '''Seconds since this process started (Linux /proc; 0 elsewhere), so
    that setup_s counts the interpreter's start too.'''
    try:
        with open('/proc/self/stat', encoding='ascii') as f:
            start = int(f.read().rsplit(')', 1)[1].split()[19])
        with open('/proc/uptime', encoding='ascii') as f:
            up = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return 0.0
    return max(0.0, up - start / os.sysconf('SC_CLK_TCK'))


T0 -= _process_age()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
os.environ.setdefault('USE_FLAX', '0')
os.environ.setdefault('USE_JAX', '0')

from perfbench.harness import host, manifest as mf  # noqa: E402


def _args(argv):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


class Cell:
    '''One cell's inputs, as the drivers see them.'''

    def __init__(self, man, name, seed):
        self.name = name
        self.seed = seed
        self.workload = mf.workload(man, name)
        _, self.config = mf.config(man, self.workload['config'])
        self.traffic = mf.traffic(self.workload['traffic'])
        self.limits = mf.limits(name)
        self.inputs = mf.scene_family(self.config['scene']).build(
            self.config)


def _metrics(man, cell, window, traced):
    out = {}
    for m in mf.cell_metrics(man, cell.name, traced):
        value = mf.reader(m['name']).read(window)
        if value is not None:
            out[m['name']] = {'value': value, 'unit': m['unit']}
    return out


def main(argv=None, device='cuda'):
    '''One run.  device: 'cuda'; the harness's CPU tests pass 'cpu' to
    drive a run of the program's plain code at a test size.'''
    args = _args(argv)
    man = mf.manifest()
    cell = Cell(man, args.workload, args.seed)
    cell.device = device
    on_card = device == 'cuda'
    if on_card:
        host.require_cards(cell.workload['chips'])
    import torch
    drv = mf.driver(cell.traffic['kind'])
    state = drv.setup(cell)
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - T0
    watch = host.HostWatch()
    window = drv.window(state, args.seconds, bool(args.trace))
    watch.close()
    kind = torch.cuda.get_device_name(0) if on_card else 'cpu'
    window.update(setup_s=setup_s, cpu_s=watch.cpu_s, config=cell.config,
                  device_kind=kind)
    print(json.dumps({'host': watch.line}), flush=True)
    device = {'platform': 'gpu' if on_card else 'cpu', 'kind': kind,
              'count': cell.workload['chips']}
    breakdown = None
    if args.trace:
        from perfbench.harness.trace import profiled_segment
        busy, span, breakdown, matched = profiled_segment(
            drv.unit(state), cell.traffic['profile_seconds'])
        if not matched:
            print('perfbench: the profiled segment\'s kernel events do not '
                  'match the launch counters', file=sys.stderr)
        window.update(busy_s=busy, profiled_s=span)
        device.update(busy_s=busy, window_s=span)
    device['memory_peak_bytes'] = (torch.cuda.max_memory_allocated()
                                   if on_card else 0)
    metrics = _metrics(man, cell, window, bool(args.trace))
    checks = drv.check(state, window, cell.limits)
    found = host.forbidden_modules()
    if found:
        sys.exit(f'perfbench: JAX modules loaded in the run: {found}')
    correct = window['failed'] == 0 and all(
        c['value'] <= c['limit'] for c in checks.values())
    line = {'correct': correct, 'attempted': window['attempted'],
            'failed': window['failed'], 'metrics': metrics,
            'device': device}
    if breakdown is not None:
        line['breakdown'] = breakdown
    line['checks'] = checks
    for name, c in checks.items():
        print(f'check {name} {c["value"]!r} limit {c["limit"]!r}',
              file=sys.stderr)
    print(json.dumps(line), flush=True)


if __name__ == '__main__':
    main()
