'''
The port's multi-process runtime (ptina_tpu_torch.parallel.distributed)
on the CPU:

  * the two-process launcher (python -m ptina_tpu_torch.parallel) at 16x8
    x 2 spp over gloo: both ranks see a world of 2, each rank's band and
    the gathered film equal a one-process render bit for bit, no
    collective runs during the render, and the two-process gradient step
    equals the in-process mean of the same two bands' gradients.  Its
    timings are printed, never asserted (the JAX twin of this test,
    tests/test_distributed.py, asserts an efficiency under the suite's
    load and fails);
  * a rendezvous that one rank never completes raises within its timeout;
  * the backend rule: gloo on the CPU, nccl when every rank of the host
    owns a GPU, gloo when ranks share one; the rank's device.
'''

import json
import os
import subprocess
import sys
import time

import torch

from ptina_tpu_torch.parallel import distributed

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env():
    return dict(os.environ, OMP_NUM_THREADS='1', CUDA_VISIBLE_DEVICES='')


def test_two_process_launcher_renders_equal_bands():
    r = subprocess.run(
        [sys.executable, '-m', 'ptina_tpu_torch.parallel', '--res', '16',
         '--ny', '8', '--spp', '2', '--device', 'cpu', '--timeout', '120'],
        capture_output=True, text=True, timeout=300, cwd=ROOT, env=_env())
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    out = json.loads([line for line in r.stdout.splitlines()
                      if line.startswith('{')][-1])
    assert out['procs'] == 2 and out['world_sizes_seen'] == [2, 2]
    assert out['backend'] == 'gloo' and out['devices'] == ['cpu', 'cpu']
    assert out['band_equal'] is True and out['gathered_equal'] is True
    assert out['render_collectives'] == 0
    assert out['grad_allclose'] is True
    assert out['samples_per_s_two_process'] > 0


def test_failed_rendezvous_raises_within_its_timeout(tmp_path):
    '''Rank 0 of two, alone: the rendezvous raises after its 3 s timeout
    and the process exits non-zero, well inside the test's limit.'''
    code = ('from ptina_tpu_torch.parallel import init_distributed\n'
            f'init_distributed("file://{tmp_path}/rendezvous", 2, 0, '
            'device="cpu", timeout=3)\n')
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, '-c', code], capture_output=True,
                       text=True, timeout=120, cwd=ROOT, env=_env())
    assert r.returncode != 0
    assert time.perf_counter() - t0 < 60
    assert '[distributed] rank 0 of 2: backend gloo' in r.stdout


def test_backend_rule(monkeypatch):
    monkeypatch.delenv('LOCAL_WORLD_SIZE', raising=False)
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 4)
    assert distributed.pick_backend('cpu', 2) == 'gloo'
    assert distributed.pick_backend('cuda', 4) == 'nccl'
    assert distributed.pick_backend('cuda', 8) == 'gloo'
    monkeypatch.setenv('LOCAL_WORLD_SIZE', '2')  # 2 ranks a host, 4 hosts
    assert distributed.pick_backend('cuda', 8) == 'nccl'
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 1)
    assert distributed.pick_backend('cuda', 2) == 'gloo'  # one card, 2 ranks


def test_rank_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 1)
    monkeypatch.setenv('LOCAL_RANK', '1')
    assert distributed.rank_device('cuda') == torch.device('cuda', 0)
    assert distributed.rank_device('cuda:0') == torch.device('cuda', 0)
    assert distributed.global_mesh('cpu') == (torch.device('cpu'),)
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 2)
    assert distributed.rank_device('cuda') == torch.device('cuda', 1)
