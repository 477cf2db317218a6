'''
The multi-process runtime: joining a torch.distributed process group, and
a two-process launcher that renders a film in bands across two ranks.

Reference: ptina_tpu/parallel/distributed.py (jax.distributed) and its
launcher tools/distributed_2proc.py.  A process joins only on explicit
configuration: arguments, or torchrun's environment with WORLD_SIZE > 1
(MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE); with neither,
init_distributed is a no-op that returns False.  Nothing here learns of a
cluster by itself.

The backend rule (pick_backend), printed when a process joins:
  * gloo for ranks that render on the CPU;
  * nccl when every rank on the host owns its own GPU;
  * gloo when ranks share a GPU (two ranks on a one-card machine): NCCL
    refuses two ranks on one device.  parallel/sharding.py then reduces and
    gathers host copies.

Rendering issues no collective (parallel/sharding.py); a gradient step
issues one all_reduce (the material gradient and the loss together), and
reading a film gathers it once (sharding.gather_film).

The launcher runs two ranks on one host:

    python -m ptina_tpu_torch.parallel --res 64 --spp 2
    python -m ptina_tpu_torch.parallel --res 16 --ny 8 --device cpu

Its ranks meet through a rendezvous file in a fresh temporary directory,
with a timeout on the process group and on each rank's process.  Each
rank renders its band of cornell_box with every collective of
torch.distributed made to raise, holds its band and the gathered film to a
one-process render bit for bit, compares the two-process gradient step
with the in-process mean over the same two bands, and times both renders.
The launcher prints one JSON line (procs, the world sizes the ranks saw,
the backend, each check, samples/s) and exits 1 if a check failed.  No
efficiency is asserted.
'''

import argparse
import contextlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from datetime import timedelta

import torch
import torch.distributed as dist

__all__ = ['init_distributed', 'is_distributed', 'global_mesh',
           'pick_backend', 'rank_device']

TIMEOUT_S = 300  # the process group's timeout, rendezvous included


def pick_backend(device, world_size):
    '''The backend for ranks rendering on `device` (module docstring):
    nccl only when each of the host's ranks (LOCAL_WORLD_SIZE, else the
    world size) has a GPU of its own.'''
    if torch.device(device).type != 'cuda':
        return 'gloo'
    local = int(os.environ.get('LOCAL_WORLD_SIZE', world_size))
    return 'nccl' if local <= torch.cuda.device_count() else 'gloo'


def is_distributed():
    '''True in a process group of more than one process.'''
    return dist.is_available() and dist.is_initialized() \
        and dist.get_world_size() > 1


def init_distributed(init_method=None, world_size=None, rank=None,
                     device='cuda', timeout=TIMEOUT_S):
    '''Join a torch.distributed process group on explicit configuration
    only: init_method (with world_size and rank), or WORLD_SIZE > 1 in the
    environment (init_method 'env://', torchrun's variables).  Otherwise a
    no-op.  device: where this rank renders, which sets the backend
    (pick_backend).  timeout: seconds for the rendezvous and every
    collective; a rendezvous that does not complete raises.  Safe to call
    more than once.  Returns True if a group of more than one process is
    active.'''
    if dist.is_initialized():
        return is_distributed()
    if world_size is None and os.environ.get('WORLD_SIZE'):
        world_size = int(os.environ['WORLD_SIZE'])
    if init_method is None:
        if (world_size or 1) <= 1:
            return False
        init_method = 'env://'
    if world_size is None:
        raise ValueError('init_distributed: init_method needs world_size')
    if rank is None:
        rank = int(os.environ.get('RANK', 0))
    backend = pick_backend(device, world_size)
    print(f'[distributed] rank {rank} of {world_size}: backend {backend}, '
          f'rendering on {device}', flush=True)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=timedelta(seconds=timeout))
    return is_distributed()


def rank_device(device='cuda'):
    '''This rank's device: a CUDA device without an index becomes the GPU
    of this rank's local index (LOCAL_RANK, else the rank) modulo the GPUs
    visible; any other device as given.'''
    dev = torch.device(device)
    if dev.type != 'cuda' or dev.index is not None:
        return dev
    rank = dist.get_rank() if dist.is_initialized() else 0
    local = int(os.environ.get('LOCAL_RANK', rank))
    return torch.device('cuda', local % torch.cuda.device_count())


def global_mesh(device='cuda'):
    '''This rank's bands of the global film: a mesh of one device, this
    rank's (rank_device).  render_sharded places its band at index rank of
    world_size bands.'''
    return (rank_device(device),)


# --------------------------------------------------------------- launcher

# torch.distributed's collectives and point-to-point calls
_COLLECTIVES = ('all_reduce', 'all_gather', 'all_gather_into_tensor',
                'all_gather_object', 'all_to_all', 'all_to_all_single',
                'barrier', 'broadcast', 'broadcast_object_list', 'gather',
                'reduce', 'reduce_scatter', 'reduce_scatter_tensor',
                'scatter', 'send', 'recv', 'isend', 'irecv')


@contextlib.contextmanager
def _collectives_raise():
    '''Within the block every collective of torch.distributed raises.'''
    saved = {name: getattr(dist, name) for name in _COLLECTIVES
             if hasattr(dist, name)}

    def refuse(name):
        def call(*args, **kwargs):
            raise RuntimeError(f'torch.distributed.{name} called while '
                               f'rendering')
        return call
    try:
        for name in saved:
            setattr(dist, name, refuse(name))
        yield
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


def _sync(dev):
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)


def _median_s(fn, dev, reps=3):
    '''Median wall seconds of fn() over `reps` calls, each ending in a
    device synchronisation.'''
    times = []
    for _ in range(reps):
        _sync(dev)
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def _rank_main(args):
    '''One rank: render its band, check it, gather, step, time.'''
    from ptina_tpu_torch.engine.path import render
    from ptina_tpu_torch.film import new_film
    from ptina_tpu_torch.parallel.sharding import (
        _band_loss_grad, gather_film, render_sharded, train_step_sharded)
    from ptina_tpu_torch.scenes import cornell_box

    torch.set_num_threads(1)
    if not init_distributed(args.init, 2, args.rank, device=args.device,
                            timeout=args.timeout):
        raise RuntimeError('the process group has one process')
    mesh = global_mesh(args.device)
    dev = mesh[0]
    if dev.type == 'cuda':
        torch.cuda.set_device(dev)
    nx, ny, spp = args.res, args.ny or args.res, args.spp
    scene = cornell_box(device=dev)

    def sharded():
        with _collectives_raise():
            return render_sharded(scene, new_film(nx, ny, device=dev), 0,
                                  mesh, spp)

    def one_process():
        return render(scene, new_film(nx, ny, device=dev), 0, spp=spp)

    film, ref = sharded(), one_process()
    rows = slice(args.rank * nx // 2, (args.rank + 1) * nx // 2)
    band_equal = torch.equal(film[:, :, rows], ref[:, :, rows])
    gathered_equal = torch.equal(gather_film(film, mesh), ref)

    # the two-process gradient step against the in-process mean of the
    # same two bands' gradients (lr 1: the factors step by the gradient)
    target = torch.zeros(nx, ny, 3, device=dev)
    film0 = new_film(nx, ny, device=dev)
    stepped, loss = train_step_sharded(scene, film0, target, 0, mesh, lr=1.0)
    parts = [_band_loss_grad(scene, film0, target, 0, b * nx // 2, nx // 2,
                             (nx, ny)) for b in range(2)]
    want = scene.materials.fac - (parts[0][1] + parts[1][1]) / 2
    want_loss = ((parts[0][0] + parts[1][0]) / 2).item()
    got = stepped.materials.fac
    grad_diff = (got - want).abs().max().item()
    grad_close = bool(torch.allclose(got, want, rtol=1e-6, atol=1e-7)) \
        and abs(loss.item() - want_loss) <= 1e-6 * want_loss

    # times: both ranks render their bands together; rank 0 alone renders
    # the whole frame in one process
    dist.barrier()
    sharded_s = _median_s(sharded, dev)
    dist.barrier()
    one_s = _median_s(one_process, dev) if args.rank == 0 else None
    dist.barrier()
    print(json.dumps({
        'rank': args.rank, 'world_size': dist.get_world_size(),
        'backend': dist.get_backend(), 'device': str(dev),
        'band_equal': band_equal, 'gathered_equal': gathered_equal,
        'render_collectives': 0, 'grad_allclose': grad_close,
        'grad_max_abs_diff': grad_diff, 'grad_bit_equal': torch.equal(got,
                                                                      want),
        'loss': loss.item(), 'sharded_ms': sharded_s * 1e3,
        'one_process_ms': one_s and one_s * 1e3}), flush=True)
    dist.destroy_process_group()


def _launch(args):
    '''Start the two ranks, wait for both within the timeout, print the
    summary line.  Returns the exit code.'''
    tmp = tempfile.mkdtemp(prefix='ptina_rendezvous_')
    env = dict(os.environ, OMP_NUM_THREADS='1', LOCAL_WORLD_SIZE='2')
    base = [sys.executable, '-m', 'ptina_tpu_torch.parallel',
            '--res', str(args.res), '--ny', str(args.ny or args.res),
            '--spp', str(args.spp), '--device', args.device,
            '--timeout', str(args.timeout),
            '--init', f'file://{os.path.join(tmp, "rendezvous")}']
    procs = []
    t0 = time.perf_counter()
    try:
        for r in range(2):
            procs.append(subprocess.Popen(
                base + ['--rank', str(r)], env=dict(env, LOCAL_RANK=str(r)),
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        outs = [p.communicate(timeout=args.timeout + 60) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    wall = time.perf_counter() - t0
    for p, (out, err) in zip(procs, outs):
        if p.returncode != 0:
            sys.stderr.write(out[-4000:] + err[-4000:])
            return p.returncode or 1
    ranks = [json.loads([line for line in out.splitlines()
                         if line.startswith('{')][-1]) for out, _ in outs]
    nx, ny = args.res, args.ny or args.res
    sharded_ms = max(r['sharded_ms'] for r in ranks)
    one_ms = ranks[0]['one_process_ms']
    summary = {
        'procs': 2, 'world_sizes_seen': [r['world_size'] for r in ranks],
        'backend': ranks[0]['backend'],
        'devices': [r['device'] for r in ranks], 'res': [nx, ny],
        'spp': args.spp,
        'band_equal': all(r['band_equal'] for r in ranks),
        'gathered_equal': all(r['gathered_equal'] for r in ranks),
        'render_collectives': sum(r['render_collectives'] for r in ranks),
        'grad_allclose': all(r['grad_allclose'] for r in ranks),
        'grad_bit_equal': all(r['grad_bit_equal'] for r in ranks),
        'grad_max_abs_diff': max(r['grad_max_abs_diff'] for r in ranks),
        'sharded_ms': sharded_ms, 'one_process_ms': one_ms,
        'samples_per_s_two_process': args.spp / sharded_ms * 1e3,
        'samples_per_s_one_process': args.spp / one_ms * 1e3,
        'wall_s': wall}
    print(json.dumps(summary), flush=True)
    ok = summary['world_sizes_seen'] == [2, 2] and summary['band_equal'] \
        and summary['gathered_equal'] and summary['grad_allclose']
    return 0 if ok else 1


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--res', type=int, default=64,
                    help='film rows (and columns unless --ny)')
    ap.add_argument('--ny', type=int, default=None, help='film columns')
    ap.add_argument('--spp', type=int, default=2)
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (each rank's GPU) or 'cpu'")
    ap.add_argument('--timeout', type=int, default=TIMEOUT_S,
                    help='seconds for the rendezvous and each collective')
    ap.add_argument('--rank', type=int, default=None,
                    help='run one rank (the launcher passes it)')
    ap.add_argument('--init', default=None,
                    help='the rendezvous URL (the launcher passes it)')
    args = ap.parse_args(argv)
    if args.rank is not None:
        _rank_main(args)
        return 0
    return _launch(args)
