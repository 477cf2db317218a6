'''
Tracing, profiling and structured logging.

Reference: ptina_tpu/utils/trace.py.

  * `log(subsystem, msg)` — prefixed console logging ("[TinaScene] ...",
    the reference's style) under a global verbosity switch;
  * `timed(name)` — context manager measuring wall-clock time; with a
    tensor to wait for (sync=, or box['sync']), it synchronises that
    tensor's CUDA device before reading the clock, so queued device work
    is included;
  * `profile_trace(dir)` — context manager around torch.profiler (CPU and,
    where there is a card, CUDA activity) that writes a Chrome trace.
'''

import contextlib
import os
import tempfile
import time

import torch

__all__ = ['log', 'set_verbosity', 'timed', 'profile_trace', 'timings']

_VERBOSITY = 1
timings = {}  # name -> [seconds, ...] of all `timed` blocks


def set_verbosity(level):
    '''0 = silent, 1 = info (default), 2 = debug.'''
    global _VERBOSITY
    _VERBOSITY = int(level)


def log(subsystem, msg, level=1):
    if _VERBOSITY >= level:
        print(f'[{subsystem}] {msg}')


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
    '''Measure a block; pass sync=tensor(s) (or set box['sync'] inside the
    block) to include the device work queued for them.'''
    t0 = time.perf_counter()
    box = {}
    try:
        yield box
    finally:
        _wait(sync if sync is not None else box.get('sync', []))
        dt = time.perf_counter() - t0
        timings.setdefault(name, []).append(dt)
        if not quiet:
            log('Timing', f'{name}: {dt * 1e3:.2f} ms', level=2)


@contextlib.contextmanager
def profile_trace(logdir=None):
    '''Profile everything inside the block and write a Chrome trace,
    `trace.json`, into logdir (default: ptina_trace under the temporary
    directory).'''
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
