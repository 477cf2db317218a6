'''
The machine a run stands on: the card check, the card's name and power
limit, the host's speed and CPU quota around the window, and the check
that no JAX module reached the process.
'''

import subprocess
import sys
import time

import torch

# top-level module names that must never be loaded in a run (compared
# whole: the program's own name, ptina_tpu_torch, begins with the JAX
# package's)
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'ptina_tpu')

# cgroup v2, then v1's cpu controller
CGROUPS = ('/sys/fs/cgroup', '/sys/fs/cgroup/cpu', '/sys/fs/cgroup/cpu,cpuacct')


def require_cards(count):
    '''Exit non-zero, printing no result, unless CUDA has `count` cards.'''
    if not torch.cuda.is_available():
        sys.exit('perfbench: torch.cuda.is_available() is false')
    if torch.cuda.device_count() < count:
        sys.exit(f'perfbench: the cell needs {count} cards, '
                 f'torch.cuda.device_count() is {torch.cuda.device_count()}')


def forbidden_modules():
    '''The loaded modules whose top-level name is forbidden.'''
    return sorted({m for m in list(sys.modules)
                   if m.split('.', 1)[0] in FORBIDDEN})


def card_line():
    '''"name, power limit" of the first card, as nvidia-smi reads them.'''
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            check=True, timeout=60)
    except (OSError, subprocess.SubprocessError) as e:
        return f'nvidia-smi unavailable: {e}'
    return out.stdout.strip().splitlines()[0]


def cpu_probe_ms():
    '''Wall ms of a fixed pure-Python loop: the host's speed for the
    single thread that launches the program's work.'''
    t0 = time.perf_counter()
    acc = 0
    for k in range(2_000_000):
        acc += k * k & 7
    return (time.perf_counter() - t0) * 1e3


def _read(path):
    try:
        with open(path, encoding='ascii') as f:
            return f.read().strip()
    except OSError:
        return None


def cpu_quota():
    '''The cgroup's CPU quota: v2's cpu.max, or v1's "quota period"; None
    where neither is readable.'''
    for d in CGROUPS:
        v2 = _read(f'{d}/cpu.max')
        if v2 is not None:
            return v2
        quota = _read(f'{d}/cpu.cfs_quota_us')
        if quota is not None:
            return f'{quota} {_read(f"{d}/cpu.cfs_period_us")}'
    return None


def cgroup_stat():
    '''cpu.stat's fields of this process's cgroup, {} where unreadable.'''
    text = next((t for t in (_read(f'{d}/cpu.stat') for d in CGROUPS) if t),
                '')
    out = {}
    for line in text.splitlines():
        k, _, v = line.partition(' ')
        if v.isdigit():
            out[k] = int(v)
    return out


class HostWatch:
    '''The host's evidence over a window: the CPU probe before and after,
    the cgroup's CPU quota, its throttling over the window, the process's
    CPU seconds and torch's thread count.'''

    def __init__(self):
        self.probe_before = cpu_probe_ms()
        self.stat = cgroup_stat()
        self.cpu = time.process_time()

    def close(self):
        self.cpu_s = time.process_time() - self.cpu
        stat = cgroup_stat()
        self.line = {
            'cpu_probe_ms': [self.probe_before, cpu_probe_ms()],
            'cpu_max': cpu_quota(),
            'nr_throttled': (stat.get('nr_throttled', 0)
                             - self.stat.get('nr_throttled', 0)
                             if stat else None),
            # v2 counts microseconds, v1 nanoseconds (throttled_time)
            'throttled_usec': (
                stat.get('throttled_usec', stat.get('throttled_time', 0)
                         / 1000)
                - self.stat.get('throttled_usec',
                                self.stat.get('throttled_time', 0) / 1000)
                if stat else None),
            'window_cpu_s': self.cpu_s,
            'torch_threads': torch.get_num_threads(),
            'card': card_line(),
        }
        return self
