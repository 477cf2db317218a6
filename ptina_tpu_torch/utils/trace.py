'''
Tracing, profiling and structured logging: the port's one recorder of
spans and counters.

Reference: ptina_tpu/utils/trace.py (log, timed, profile_trace).

  * `log(subsystem, msg)` — prefixed console logging ("[TinaScene] ...",
    the reference's style) under a global verbosity switch;
  * `span(name, **attrs)` — a context manager around one stage of the
    program: its name, an id, its parent's id, host start and end
    (time.perf_counter_ns), the attrs, and while tracing is on its time
    on the card;
  * `walk_buffer(kernel, shape, fill, device)` — the per-ray tree-walk
    counters of a kernel launch, counted into the kernel's accumulators
    on the device;
  * `add_counts(name, got)` — a program counter: an int64 vector added
    into the named device sum;
  * `summary()`, `spans()`, `reset()` — what was recorded;
  * `timed(name)` — a span that always records and, with a tensor to wait
    for (sync=, or box['sync'] inside the block), synchronises that
    tensor's CUDA device before it closes;
  * `profile_trace(dir)` — the one exporter: a torch.profiler session (CPU
    and, where there is a card, CUDA activity) that writes a Chrome trace
    holding the program's spans beside the device operations.

Turning tracing on.  Tracing is off by default: a span site costs one
flag test and records nothing, except the set-up spans (`scene.*`,
`kernels.build`, `grad.graph_capture`) and `timed` blocks, which run once
per scene build, library load, graph capture or explicit measurement
and always record their host time.
Tracing is on between `enable()` and `disable()`, and while any
torch.profiler session records (profile_trace, or the profiler of a
benchmark's traced run): no knob or environment variable.  While it is
on,
  * under a profiler session each span is also a `record_function` range
    (a user annotation), so the profiler's trace shows it on the clock of
    the device operations;
  * on a card, each span records a CUDA event on the current stream at its
    start and at its end.  Its device time is the stream time between the
    two: it adds up along the stream and counts the time the device spent
    waiting for the host.  The events go onto the host clock through one
    anchor, taken at the first span on a card after enable() or reset()
    (a synchronise, then a host time and an event together);
  * the tree-walk kernels (the path megakernel, the blocked casts) get
    their per-ray counters (walk_buffer), which the program counts on the
    device a batch of launches at a time, with no host sync and no extra
    launch of a port kernel;
  * the program's other counters (add_counts) are added into device sums
    where they are counted, with no host sync.

Reading.  `summary()` synchronises once, resolves the events and returns
the aggregates, which never drop: `traced` (spans recorded while on) and
`always` (the set-up spans and timed blocks), each {name: {count,
host_ns, self_ns, device_ns, device_count}} (self: host time minus the
host time of the span's children; device_ns None where no event was
recorded), `walks` {kernel: {casts, inner, leaves, leaf_slots}},
`counts` {name: [the sums of add_counts]}, and `recorded` / `dropped`,
the ring's counts.  `spans()` returns the ring's newest records (at
most RING_CAP; the older ones are dropped and counted).  `reset()`
clears everything.  An operator:

    from ptina_tpu_torch.utils import trace
    trace.enable()
    render(scene, film, 0, spp=8)
    print(trace.summary()['traced']['render.sample'])
    trace.disable()

or, for a timeline, `with trace.profile_trace('out'): render(...)` and
open out/trace.json in a Chrome-trace viewer.

The spans of the port, by site:

    scene.build                     scene.make_scene (always)
    scene.order / .tables /         its stages: Morton order, face tables,
      .trees / .upload                box trees, device moves (always)
    kernels.build (compiled)        utils/cuda_build.build_shared_library
                                    (always; compiled: nvcc ran)
    render.sample (route)           engine/path.render_sample
    wavefront.bounce                engine/path._bounce
    wavefront.cast (kind)           intersect/dispatch.cast_shaded /
                                    cast_shadow (kind shaded / shadow)
    world.fetch                     engine/path._world_fetch: the
                                    environment's radiance along a
                                    bounce's rays, one a bounce (a
                                    textured world's four texel gathers)
    grad.step                       diff.inverse_render_step,
                                    diff.inverse_texture_step
    grad.forward, grad.backward     diff.render_image_diff; the
                                    torch.autograd.grad of _loss_and_grad
    grad.recompute,                 engine/fused.FusedTraceDiff.backward:
      grad.inner_backward             its path_trace; its autograd.grad
    grad.shade                      engine/fused._Graphed: a shading
                                    segment of the recompute on the card
                                    (two a bounce, inside grad.recompute)
    grad.shade.replay               the segment's graph replayed (inside
                                    grad.shade)
    grad.graph_capture              a segment's forward graph (inside
                                    grad.shade) or backward graph (inside
                                    grad.inner_backward) captured (always)
    grad.material_rows              mtllib.material_rows_backward: the
                                    material fetch's backward kernel, one
                                    a bounce (inside grad.inner_backward)
    grad.texel_rows                 texture.texel_rows_backward: a texel
                                    gather's backward, four a fetch of a
                                    textured scene (inside
                                    grad.inner_backward on the card)
    grad.texel_rows.kernels         texture._texel_rows_kernel: the two
                                    launches of csrc/texel_rows.cu alone
                                    (inside grad.texel_rows, on the card)

The counters of add_counts, by name:

    texel_rows                      texture.texel_rows_backward: lanes
                                    walked, lanes with a nonzero
                                    cotangent row, distinct texels written
    world                           engine/path._world_fetch
                                    (lights.world_counts): lanes fetched,
                                    lanes whose radiance enters the result
                                    (alive and missing), distinct
                                    environment texels those lanes read,
                                    the environment's texels

A span opened on a thread with no open span of its own (autograd's device
thread, running a backward) takes as its parent the newest span still
open on another thread (the span whose call waits on that backward).
'''

import collections
import contextlib
import itertools
import os
import tempfile
import threading
import time

import torch
import torch.autograd.profiler as _profiler

__all__ = ['log', 'set_verbosity', 'span', 'enable', 'disable', 'tracing',
           'walk_buffer', 'warm_walks', 'add_counts', 'summary', 'spans',
           'reset', 'timed', 'profile_trace', 'Recorder', 'RECORDER',
           'RING_CAP', 'WALK_BATCH']

_VERBOSITY = 1

# spans the ring keeps; the aggregates never drop
RING_CAP = 65536
# unresolved device spans above which the finished ones are folded in
# (their events go back to the pool: creating a CUDA event gets slower
# the more a process holds)
_PENDING_FOLD = 128
# launches whose walk counters are counted together
WALK_BATCH = 8


def set_verbosity(level):
    '''0 = silent, 1 = info (default), 2 = debug.'''
    global _VERBOSITY
    _VERBOSITY = int(level)


def log(subsystem, msg, level=1):
    if _VERBOSITY >= level:
        print(f'[{subsystem}] {msg}')


class _Span:
    '''One open span (span() returns it; the recorder closes it).'''

    __slots__ = ('rec', 'name', 'attrs', 'always', 'id', 'parent', 't0',
                 'child_ns', 'ev0', 'rf', 'stack')

    def __init__(self, rec, name, always, attrs):
        self.rec, self.name, self.always, self.attrs = rec, name, always, \
            attrs
        self.child_ns, self.ev0, self.rf = 0, None, None

    def __enter__(self):
        self.rec._open(self)
        return self

    def __exit__(self, *exc):
        self.rec._close(self, time.perf_counter_ns())
        return False


class Recorder:
    '''The spans and walk counters of one process (RECORDER): a bounded
    ring of span records, per-name aggregates that never drop, and the
    kernels' device-side walk accumulators.'''

    def __init__(self, cap=RING_CAP):
        self._lock = threading.Lock()
        self._local = threading.local()
        self._stacks = {}  # thread ident -> that thread's open spans
        self._ids = itertools.count(1)
        self.reset(cap)

    def reset(self, cap=None):
        '''Clear every record, aggregate and counter; the next span on a
        card takes a new anchor.'''
        with self._lock:
            cap = cap if cap is not None else self.ring.maxlen
            self.ring = collections.deque(maxlen=cap)
            self.dropped = 0
            self.agg = {'traced': {}, 'always': {}}
            self.walks = {}  # kernel -> [casts possible, int64 [4] sums]
            self.counts = {}  # name -> int64 [k] device sums
            # (kernel, shape, fill, device) -> [buffer, slots used,
            # launches seen]
            self._batches = {}
            self._pending = []  # (aggregate, record, start, end event)
            self._fold_at = _PENDING_FOLD
            self._events = []  # resolved timing events, for reuse
            self.anchor = None  # (host ns, CUDA event)

    # ---- spans

    def _stack(self):
        stack = getattr(self._local, 'stack', None)
        if stack is None:
            stack = self._local.stack = []
            self._stacks[threading.get_ident()] = stack
        return stack

    def _waiting_parent(self, own):
        '''The newest span open on another thread, or None.'''
        tops = [s[-1] for s in list(self._stacks.values())
                if s and s is not own]
        return max(tops, key=lambda s: s.id) if tops else None

    def _anchored(self):
        '''The anchor, taken now if CUDA is up and none is held: on an
        idle stream, an event recorded between two host times (its CUDA
        event made beforehand, so the record is all that lies between).'''
        if self.anchor is None and torch.cuda.is_initialized():
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            torch.cuda.synchronize()
            t0 = time.perf_counter_ns()
            ev.record()
            self.anchor = ((t0 + time.perf_counter_ns()) // 2, ev)
        return self.anchor

    def _open(self, sp):
        stack = self._stack()
        sp.parent = stack[-1] if stack else self._waiting_parent(stack)
        sp.id = next(self._ids)
        profiled = _profiler._is_profiler_enabled
        if profiled:
            sp.rf = _profiler.record_function(sp.name)
            sp.rf.__enter__()
        if (_ON or profiled) and self._anchored() is not None:
            sp.ev0 = self._event()
        sp.stack = stack
        stack.append(sp)
        sp.t0 = time.perf_counter_ns()

    def _close(self, sp, t1):
        ev1 = None if sp.ev0 is None else self._event()
        if sp.rf is not None:
            sp.rf.__exit__(None, None, None)
        sp.stack.pop()
        host = t1 - sp.t0
        parent = sp.parent
        with self._lock:
            if parent is not None:
                parent.child_ns += host
            table = self.agg['always' if sp.always else 'traced']
            a = table.get(sp.name)
            if a is None:
                a = table[sp.name] = [0, 0, 0, 0, 0]
            a[0] += 1
            a[1] += host
            a[2] += host - sp.child_ns
            # id, parent id, name, host start, host end, attrs, device
            # start and end on the host clock (None until resolved)
            rec = [sp.id, parent.id if parent is not None else None,
                   sp.name, sp.t0, t1, sp.attrs, None, None]
            if len(self.ring) == self.ring.maxlen:
                self.dropped += 1
            self.ring.append(rec)
            if ev1 is not None:
                self._pending.append((a, rec, sp.ev0, ev1))
                if len(self._pending) > self._fold_at:
                    self._fold(wait=False)

    def _fold(self, wait):
        '''Resolve the pending device spans (all after a synchronise when
        wait, else those whose events have completed).'''
        if wait and self._pending:
            torch.cuda.synchronize()
        host, anchor = self.anchor
        keep = []
        for a, rec, ev0, ev1 in self._pending:
            if not wait and not (ev1.query() and ev0.query()):
                keep.append((a, rec, ev0, ev1))
                continue
            ms0, ms1 = anchor.elapsed_time(ev0), anchor.elapsed_time(ev1)
            a[3] += round((ms1 - ms0) * 1e6)
            a[4] += 1
            rec[6] = host + round(ms0 * 1e6)
            rec[7] = host + round(ms1 * 1e6)
            self._events += (ev0, ev1)
        self._pending = keep
        self._fold_at = len(keep) + _PENDING_FOLD

    def _event(self):
        '''A timing event recorded on the current stream (from the pool of
        resolved ones where it has one).'''
        ev = self._events.pop() if self._events \
            else torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    # ---- counters

    @contextlib.contextmanager
    def walk_buffer(self, kernel, shape, fill, device, every=1):
        '''walk_buffer (module function) in this recorder.'''
        key = (kernel, tuple(shape), fill, device)
        with self._lock:
            batch = self._batches.get(key)
            if batch is None:
                batch = self._batches[key] = [torch.full(
                    (WALK_BATCH,) + key[1], fill, dtype=torch.int32,
                    device=device), 0, 0]
            batch[2] += 1
            counted = (batch[2] - 1) % every == 0
            slot = batch[0][batch[1]] if counted else None
        yield slot
        if not counted:
            return
        with self._lock:
            batch[1] += 1
            if batch[1] == WALK_BATCH:
                self._flush(key, batch)

    def _flush(self, key, batch):
        '''Count a batch's used slots and refill them.'''
        used = batch[0][:batch[1]]
        if batch[1]:
            self._count(key[0], used)
            used.fill_(key[2])
        batch[1] = 0

    def _count(self, kernel, v):
        '''Fold the counters of m launches, v [m, n rays, ..., 2], into
        the kernel's accumulator.  The sums are taken per cast column in
        int32 (no widening copy of the buffer; exact while a column's rays
        visit under 2^31 nodes) and added into int64 (-casts not made,
        inner, leaves, warp maxima); the casts possible are counted on
        the host.'''
        m, n = v.shape[:2]
        v = v.reshape(m, n, -1, 2)
        k = v.shape[2]
        i32 = torch.int32
        raw = v.sum(dim=(0, 1), dtype=i32)  # [k, 2], -1 a cast not made
        gone = v[..., 0].clamp_max(0).sum(dim=(0, 1), dtype=i32)
        w = n - n % 32
        most = v[:, :w].reshape(m, w // 32, 32, k, 2).amax(2)[..., 1] \
            .clamp_min(0).sum(dim=(0, 1), dtype=i32)
        if w < n:
            most = most + v[:, w:, :, 1].amax(1).clamp_min(0).sum(
                dim=0, dtype=i32)
        got = torch.stack([gone, raw[:, 0] - gone, raw[:, 1] - gone,
                           most]).sum(dim=1, dtype=torch.int64)
        acc = self.walks.get(kernel)
        if acc is None or acc[1].device != got.device:
            self.walks[kernel] = [m * n * k, got]
        else:
            acc[0] += m * n * k
            acc[1] += got

    def add_counts(self, name, got):
        '''add_counts (module function) in this recorder.'''
        with self._lock:
            acc = self.counts.get(name)
            if acc is None or acc.device != got.device:
                self.counts[name] = got.clone()
            else:
                acc += got

    # ---- reading

    def summary(self):
        '''The aggregates and counters (module docstring); synchronises
        once to resolve the device spans.  Reading changes nothing.'''
        with self._lock:
            for key, batch in self._batches.items():
                self._flush(key, batch)
            if self._pending:
                self._fold(wait=True)
            out = {k: {name: {'count': a[0], 'host_ns': a[1],
                              'self_ns': a[2],
                              'device_ns': a[3] if a[4] else None,
                              'device_count': a[4]}
                       for name, a in table.items()}
                   for k, table in self.agg.items()}
            out['walks'] = {}
            for k, (possible, acc) in self.walks.items():
                gone, inner, leaves, most = acc.tolist()
                out['walks'][k] = {'casts': possible + gone, 'inner': inner,
                                   'leaves': leaves, 'leaf_slots': 32 * most}
            out['counts'] = {k: v.tolist() for k, v in self.counts.items()}
            out['recorded'] = len(self.ring) + self.dropped
            out['dropped'] = self.dropped
            return out

    def spans(self):
        '''The ring's records, oldest first, each a dict: id, parent,
        name, start_ns, end_ns (host), attrs, device_start_ns,
        device_end_ns (on the host clock; None without a card).'''
        self.summary()
        keys = ('id', 'parent', 'name', 'start_ns', 'end_ns', 'attrs',
                'device_start_ns', 'device_end_ns')
        with self._lock:
            return [dict(zip(keys, rec)) for rec in self.ring]


RECORDER = Recorder()
_ON = False
_OFF = contextlib.nullcontext()


def enable():
    '''Turn tracing on (module docstring).'''
    global _ON
    _ON = True


def disable():
    '''Turn enable()'s tracing off (a profiler session still turns it on
    while it records).'''
    global _ON
    _ON = False


def tracing():
    '''Whether tracing is on: enable()d, or a torch.profiler session
    recording.'''
    return _ON or _profiler._is_profiler_enabled


def span(name, always=False, **attrs):
    '''A span around a block (module docstring): recorded while tracing
    is on, and always where always=True (set-up stages).'''
    if not (always or _ON or _profiler._is_profiler_enabled):
        return _OFF
    return _Span(RECORDER, name, always, attrs)


def walk_buffer(kernel, shape, fill, device, every=1):
    '''A context manager around one launch of a tree-walk kernel while
    tracing is on: it yields the int32 counter buffer of shape `shape`,
    filled with `fill`, for the launch to fill (a slot of a batch of
    WALK_BATCH such buffers), on the first launch of this kernel and
    shape and on every `every`-th after it, and None on the others (not
    counted): [N, ..., 2] (inner nodes visited, leaves
    tested) of each ray (thread i = ray i, so 32 consecutive rays are a
    warp) and each of its casts (the middle axes: bounce and cast kind),
    -1 where the ray made no such cast.  Right after the launch that fills
    a batch's last slot, and at summary(), the recorder counts the batch
    on the device, with no host sync and no launch of a port kernel, into
    the kernel's casts made, inner nodes, leaves, and leaf slots: for each
    warp and cast, 32 x the most leaves a lane of the warp tested (100 x
    leaves / leaf slots is the share of the warp's leaf tests that did a
    lane's work).  One stream: the counting is queued behind the
    launches.'''
    return RECORDER.walk_buffer(kernel, shape, fill, device, every)


_WARMED = set()


def warm_walks(kernel, shape, fill, device):
    '''With tracing off: the first time a launch of this kernel, counter
    shape and device runs, launch walk_buffer's device operations once
    on a small batch of the same layout, into a throwaway recorder.  CUDA
    loads a kernel's module at its first launch, tens of ms each, which
    would otherwise fall into the first traced launches and read as idle
    device time there.'''
    key = (kernel, shape[1:], shape[0] % 32 > 0, fill, device)
    if key not in _WARMED:
        _WARMED.add(key)
        scratch = Recorder(cap=1)
        small = (64 + shape[0] % 32,) + tuple(shape[1:])
        for _ in range(WALK_BATCH + 1):
            with scratch.walk_buffer(kernel, small, fill, device):
                pass
        scratch.summary()


def add_counts(name, got):
    '''Add got, an int64 [k] tensor of one site's counts (tracing on),
    into the named sum on got's device, with no host sync; summary()
    reads it once as `counts`[name].'''
    RECORDER.add_counts(name, got)


def summary():
    return RECORDER.summary()


def spans():
    return RECORDER.spans()


def reset():
    RECORDER.reset()


def _wait(tensors):
    '''Synchronise every CUDA device that holds one of `tensors` (a tensor
    or a list / tuple / dict of them).'''
    if isinstance(tensors, dict):
        tensors = list(tensors.values())
    if not isinstance(tensors, (list, tuple)):
        tensors = [tensors]
    for dev in {t.device for t in tensors
                if isinstance(t, torch.Tensor) and t.is_cuda}:
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def timed(name, sync=None, quiet=False):
    '''A span that always records; pass sync=tensor(s) (or set
    box['sync'] inside the block) to include the device work queued for
    them.  Its host time is in summary()['always'][name].'''
    box = {}
    with span(name, always=True) as sp:
        try:
            yield box
        finally:
            _wait(sync if sync is not None else box.get('sync', []))
    if not quiet:
        dt = time.perf_counter_ns() - sp.t0
        log('Timing', f'{name}: {dt * 1e-6:.2f} ms', level=2)


@contextlib.contextmanager
def profile_trace(logdir=None):
    '''Profile everything inside the block and write a Chrome trace,
    `trace.json`, into logdir (default: ptina_trace under the temporary
    directory); the program's spans are in it as user annotations.'''
    from torch.profiler import profile, ProfilerActivity
    logdir = logdir or os.path.join(tempfile.gettempdir(), 'ptina_trace')
    os.makedirs(logdir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield logdir
    path = os.path.join(logdir, 'trace.json')
    prof.export_chrome_trace(path)
    log('Trace', f'profile written to {path}')
