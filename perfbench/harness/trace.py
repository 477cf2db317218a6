'''
The traced run's readings: CUDA events around each launch of the
program's hand-written kernels (the profiler loses their ctypes
launches), and a profiled segment whose device timeline merges those
events with the profiler's own kernels, for the busy share, the costliest
device operations and the idle gaps by what the host was doing.

The launch sites are the program's launch functions, found by name; a
site the program no longer has is left alone, and the readings that need
it are then missing, never zero.
'''

import importlib
import time

import torch

# (module, launch function) -> the kernel's name in the readings; each is
# also the substring its kernel's name carries in a profiler trace
LAUNCH_SITES = {
    ('ptina_tpu_torch.engine.fused', '_launch'): 'path_kernel',
    ('ptina_tpu_torch.intersect.blocked', '_launch_shade'):
        'blocked_shade_kernel',
    ('ptina_tpu_torch.intersect.blocked', '_launch_any'):
        'blocked_any_kernel',
    ('ptina_tpu_torch.intersect.dense_cast', '_launch_shade'):
        'shade_kernel',
    ('ptina_tpu_torch.intersect.dense_cast', '_launch_any'): 'any_kernel',
}

# the program's launch counters: module -> its LAUNCHES dict
COUNTERS = ('ptina_tpu_torch.engine.fused', 'ptina_tpu_torch.intersect.blocked',
            'ptina_tpu_torch.intersect.dense_cast')


def launch_counts():
    '''Every launch counter of the program, by module and key.'''
    out = {}
    for name in COUNTERS:
        for k, v in getattr(importlib.import_module(name), 'LAUNCHES',
                            {}).items():
            out[f'{name.rsplit(".", 1)[1]}.{k}'] = v
    return out


def counts_since(before):
    return {k: v - before.get(k, 0) for k, v in launch_counts().items()
            if v - before.get(k, 0)}


class KernelEvents:
    '''CUDA events around each launch of the program's kernels while
    installed (a context manager).'''

    def __init__(self):
        self.records = []  # (kernel, start event, end event)
        self._saved = []

    def _wrap(self, kernel, fn):
        def timed(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            self.records.append((kernel, start, end))
            return out
        return timed

    def __enter__(self):
        for (mod_name, fn_name), kernel in LAUNCH_SITES.items():
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, fn_name, None)
            if callable(fn):
                self._saved.append((mod, fn_name, fn))
                setattr(mod, fn_name, self._wrap(kernel, fn))
        return self

    def __exit__(self, *exc):
        for mod, fn_name, fn in reversed(self._saved):
            setattr(mod, fn_name, fn)
        self._saved = []
        return False

    def ms(self, kernels):
        '''Device ms of the launches of the named kernels, summed, and
        their count; (None, 0) where none was recorded.'''
        torch.cuda.synchronize()
        sel = [(s, e) for k, s, e in self.records if k in kernels]
        if not sel:
            return None, 0
        return sum(s.elapsed_time(e) for s, e in sel), len(sel)

    def intervals(self, anchor):
        '''(kernel, start ms, end ms) of every launch, relative to the
        anchor event's time on the device.'''
        torch.cuda.synchronize()
        return [(k, anchor.elapsed_time(s), anchor.elapsed_time(e))
                for k, s, e in self.records]


# the drivers' record_function spans, and the profiler's own host work
_ANNOTATIONS = ('perfbench.segment', 'frame', 'step')
_PROFILER_OWN = ('Activity Buffer Request',)


def _union(spans):
    '''Total length of the union of (start, end) spans.'''
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def _gaps(spans, lo, hi):
    '''The idle (start, end) spans of [lo, hi] outside the busy spans.'''
    out, at = [], lo
    for s, e in sorted(spans):
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(s, e) for s, e in out if e > s]


def _doing(host, t):
    '''The innermost host operation running at time t.'''
    inner = [h for h in host if h[0] <= t <= h[1]]
    if not inner:
        return 'host: between operations'
    return min(inner, key=lambda h: h[1] - h[0])[2][:96]


def _top(pairs, n=10):
    acc = {}
    for name, sec in pairs:
        acc[name] = acc.get(name, 0.0) + sec
    return [[k, v] for k, v in sorted(acc.items(), key=lambda kv: -kv[1])[:n]]


def profiled_segment(unit, seconds):
    '''Run unit() under the profiler, with kernel events, until `seconds`
    of wall time have passed (at least one unit).  Returns (busy_s,
    window_s, breakdown, launches matched): busy is the union of the
    profiler's device operations and the events' kernel spans over the
    segment; the breakdown holds the costliest device operations by name
    and the ten longest idle gaps, each named by the innermost host
    operation running at its middle.'''
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    before = launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with KernelEvents() as ev:
            with record_function('perfbench.segment'):
                anchor = torch.cuda.Event(enable_timing=True)
                anchor.record()
                torch.cuda._sleep(1)
                t0 = time.perf_counter()
                while True:
                    unit()
                    if time.perf_counter() - t0 >= seconds:
                        break
                torch.cuda.synchronize()
    launched = counts_since(before)
    port = ev.intervals(anchor)
    events = prof.events()
    seg = next(e for e in events if e.name == 'perfbench.segment'
               and e.device_type != torch.autograd.DeviceType.CUDA)
    lo, hi = seg.time_range.start, seg.time_range.end
    names = set(LAUNCH_SITES.values())
    dev, host = [], []
    spin = None
    for e in events:
        if getattr(e, 'is_user_annotation', False) \
                or e.name in _ANNOTATIONS:
            continue  # a record_function span, on either timeline
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if 'spin' in e.name and spin is None:
                spin = e.time_range.start
            elif not any(k in e.name for k in names):
                dev.append((e.time_range.start, e.time_range.end, e.name))
        elif e.time_range.end > e.time_range.start \
                and e.name not in _PROFILER_OWN:
            host.append((e.time_range.start, e.time_range.end, e.name))
    ops = [(n[:96], (e - s) * 1e-6) for s, e, n in dev]
    ops += [(k, (e - s) * 1e-3) for k, s, e in port]
    spans = [(s, e) for s, e, _ in dev]
    breakdown = {'device_ops': _top(ops)}
    if spin is not None:
        spans += [(spin + s * 1e3, spin + e * 1e3) for _, s, e in port]
        busy_us = _union([(max(s, lo), min(e, hi)) for s, e in spans
                          if e > lo and s < hi])
        longest = sorted(_gaps(spans, lo, hi), key=lambda g: g[0] - g[1])
        breakdown['idle_gaps'] = [[_doing(host, (s + e) / 2), (e - s) * 1e-6]
                                  for s, e in longest[:10]]
    else:  # no anchor on the timeline: the port's kernels as a sum
        busy_us = _union([(s, e) for s, e in spans]) \
            + sum(e - s for _, s, e in port) * 1e3
    matched = sum(v for k, v in launched.items()) == len(port)
    return busy_us * 1e-6, (hi - lo) * 1e-6, breakdown, matched
