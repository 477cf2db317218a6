#!/usr/bin/env python3
'''
chip_compare.py — time the path megakernel, the dense scene-level casts
and the two blocked casts of this checkout against those of another
checkout of the repository (say its parent commit, unpacked with `git
archive` into a git-ignored directory), on one GPU, in turns, and check
that both give the same bits.

    python3 chip_compare.py OTHER_TREE [--rounds N]

Each turn is one worker process that imports ptina_tpu_torch from one
tree (its kernels built from that tree's csrc/ into that tree's build/);
the turns run other, this, this, other, N times over (default 1).  A
worker measures, on the card:

  * path_kernel: device ms per 512x512 sample (depth 5, sample 9) of
    fused_trace_primary on the five benchmark scenes (cornell,
    cornell_monkey, textured cornell, envlight, matball), CUDA events
    around 10 launches queued behind a spinning stream (chip_smoke.py's
    _queued_us);
  * shade_kernel / any_kernel: device ms per call of the dense route's
    dispatch.cast_shaded / cast_shadow (an entry point with one signature
    in every tree, whatever its kernels take) at 262,144 seeded random
    rays from inside the cornell box, on the five scenes and chip_smoke's
    random 2,504-face table, the same way;
  * closest_kernel / any_flat_kernel: device ms per call of the
    table-level dense_cast.cast_closest / cast_any_flat (each tree's
    default) on the same rays and the same six face tables;
  * blocked_shade_kernel / blocked_any_kernel: device ms per call at
    262,144 seeded random rays from inside cornell_highpoly's box, the
    same way.

It saves the radiance and the cast results, and the parent process
holds this tree's against the other's: the share of paths (rays) whose
outputs are equal bit for bit.  A turn that builds its tree's kernels
returns nvcc's log and its libraries' paths; the parent prints, for both
trees, ptxas's registers, stack and spills of each kernel and, where
cuobjdump is there, the instructions of one face's common path through
closest_kernel's face loop ([sass]; ptina_tpu_torch.utils.kernel_report of
this tree reads both).  Prints the card's name and power limit
and, as its last line, one JSON object: per kernel and scene each
turn's ms, the median per tree, and this / other.  Uses only entry points
both trees have.  Exits non-zero without a GPU.
'''

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

RES, DIMS, SAMPLE, REPS = 512, 32, 9, 10
N_RAYS = 262_144
SCENES = ('cornell', 'cornell_monkey', 'cornell_textured', 'envlight',
          'matball')


def _queued_ms(torch, fn, reps=REPS):
    '''Device ms per call of fn() (which must not synchronise): `reps`
    calls queued behind a torch.cuda._sleep spin of twice a dry run's
    wall time, timed with CUDA events.'''
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    dry = time.perf_counter() - t0
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(dry * 4e9) + 1_000_000)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def worker(tree, out_path):
    '''One turn: time and save the kernels of the ptina_tpu_torch in tree.'''
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch
    from ptina_tpu_torch import scenes
    from ptina_tpu_torch.engine import fused
    from ptina_tpu_torch.intersect import blocked, dense_cast, dispatch
    from ptina_tpu_torch.sampling.sobol import sobol_block
    from ptina_tpu_torch.utils.vec import V3
    import ptina_tpu_torch
    assert os.path.dirname(ptina_tpu_torch.__file__).startswith(
        os.path.abspath(tree))
    ramp = (np.linspace(0, 1, 64 * 64, dtype=np.float32).reshape(64, 64, 1)
            * np.ones((1, 1, 3), np.float32))
    make = {'cornell': lambda: scenes.cornell_box(device='cuda'),
            'cornell_monkey': lambda: scenes.cornell_monkey(device='cuda'),
            'cornell_textured': lambda: scenes.cornell_box(
                textured_image=ramp, device='cuda'),
            'envlight': lambda: scenes.envlight_scene(device='cuda'),
            'matball': lambda: scenes.matball(roughness_tex=ramp,
                                              device='cuda')}
    libs = [m.build_library() for m in (fused, blocked, dense_cast)]
    pt = sobol_block(SAMPLE, DIMS)

    def t(a, dt=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                               device='cuda')

    def rays(seed, f):
        '''Rays from inside the cornell box in random directions, a quarter
        avoiding a random face, shadow distances in [0, 6).'''
        rng = np.random.RandomState(seed)
        o = np.stack([rng.uniform(-1.9, 1.9, N_RAYS),
                      rng.uniform(0.1, 3.9, N_RAYS),
                      rng.uniform(-1.9, 1.9, N_RAYS)], 1)
        d = rng.randn(N_RAYS, 3)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        return (V3(t(o[:, 0]), t(o[:, 1]), t(o[:, 2])),
                V3(t(d[:, 0]), t(d[:, 1]), t(d[:, 2])),
                t(np.where(rng.rand(N_RAYS) < 0.25,
                           rng.randint(0, f, N_RAYS), -1), torch.int32),
                t(rng.uniform(0.0, 6.0, N_RAYS)))
    def random_table():
        '''chip_smoke.py's random 2,504-face table (its material ids have
        no materials: the casts only).'''
        rng = np.random.RandomState(3)
        tris = (rng.randn(2500, 3, 3) * 2.0).astype(np.float32)
        verts = np.concatenate([tris.reshape(-1, 3),
                                np.tile([[0.0, 0.0, 1.0]], (7500, 1)),
                                np.zeros((7500, 2))], axis=1)
        return scenes.make_scene(verts, rng.randint(-1, 4, size=2500)
                                 .astype(np.int32), device='cuda')
    ms, saved = {}, {}
    for name in SCENES + ('random_2504',):
        if name == 'random_2504':
            scene = random_table()
        else:
            scene = make[name]()
            rad = fused.fused_trace_primary(scene, pt, RES, RES)
            saved[name] = torch.stack([rad.x, rad.y, rad.z]).cpu().numpy()
            ms[f'path_kernel/{name}'] = _queued_ms(
                torch, lambda: fused.fused_trace_primary(scene, pt, RES,
                                                         RES))
        ro, rd, avoid, tmax = rays(11, scene.face_coef.shape[0])
        hit, nrm, s, tt, mtl = dispatch.cast_shaded(scene, ro, rd, avoid)
        occ = dispatch.cast_shadow(scene, ro, rd, avoid, tmax)
        saved[f'shade/{name}'] = torch.stack(
            [hit.index.float(), hit.t, hit.u, hit.v, nrm.x, nrm.y, nrm.z, s,
             tt, mtl.float()]).cpu().numpy()
        saved[f'any/{name}'] = occ[None].cpu().numpy()
        ms[f'shade_kernel/{name}'] = _queued_ms(
            torch, lambda: dispatch.cast_shaded(scene, ro, rd, avoid))
        ms[f'any_kernel/{name}'] = _queued_ms(
            torch, lambda: dispatch.cast_shadow(scene, ro, rd, avoid, tmax))
        c = scene.face_coef
        hit = dense_cast.cast_closest(ro, rd, avoid, c)
        occ = dense_cast.cast_any_flat(ro, rd, avoid, tmax, c)
        saved[f'closest/{name}'] = torch.stack(
            [hit.index.float(), hit.t, hit.u, hit.v]).cpu().numpy()
        saved[f'any_flat/{name}'] = occ[None].cpu().numpy()
        ms[f'closest_kernel/{name}'] = _queued_ms(
            torch, lambda: dense_cast.cast_closest(ro, rd, avoid, c))
        ms[f'any_flat_kernel/{name}'] = _queued_ms(
            torch, lambda: dense_cast.cast_any_flat(ro, rd, avoid, tmax, c))
    hp = scenes.cornell_highpoly(device='cuda')
    ro, rd, avoid, tmax = rays(7, hp.face_coef.shape[0])
    tables = (hp.face_coef, hp.face_attr, hp.block_bounds, hp.node_bounds)
    c, _, bb, nb = tables
    hit, attrs = blocked.blocked_cast_shade(ro, rd, avoid, *tables)
    occ = blocked.blocked_cast_any(ro, rd, avoid, tmax, c, bb, nb)
    saved['blocked_shade'] = torch.cat(
        [hit.index[None].float(), hit.t[None], hit.u[None], hit.v[None],
         attrs]).cpu().numpy()
    saved['blocked_any'] = occ[None].cpu().numpy()
    ms['blocked_shade_kernel/cornell_highpoly'] = _queued_ms(
        torch, lambda: blocked.blocked_cast_shade(ro, rd, avoid, *tables))
    ms['blocked_any_kernel/cornell_highpoly'] = _queued_ms(
        torch, lambda: blocked.blocked_cast_any(ro, rd, avoid, tmax, c, bb,
                                                nb))
    np.savez(out_path, **saved)
    print(json.dumps({'ms': ms, 'log': '\n'.join(log for _, log in libs),
                      'dense_cast_lib': libs[2][0]._name}))


def _print_build(side, got, printed):
    '''The ptxas lines of a turn that built its tree, and the [sass] line
    of its tree's closest_kernel once a tree.'''
    # imported here, not at the top: a worker imports ptina_tpu_torch from
    # its own tree
    from ptina_tpu_torch.utils.kernel_report import (face_loop_path,
                                                     ptxas_by_kernel, sass)
    for kern, info in ptxas_by_kernel(got['log']).items():
        print(f'[compare] ptxas {side} {kern}: {info}')
    if side in printed:
        return
    printed.add(side)
    path = face_loop_path(sass(got['dense_cast_lib'], 'closest_kernel'))
    if path is None:
        print(f'[sass] {side} closest_kernel face loop: not read (no '
              f'cuobjdump or no unrolled loop)')
        return
    n, counts = path
    fp = counts.get('FMUL', 0) + counts.get('FADD', 0)
    print(f'[sass] {side} closest_kernel: one face\'s common path is {n:g} '
          f'instructions, {fp:g} of them FP32: '
          + ', '.join(f'{v:g} {k}' for k, v in
                      sorted(counts.items(), key=lambda kv: -kv[1])))


def _card():
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main():
    if sys.argv[1:2] == ['--worker']:
        worker(sys.argv[2], sys.argv[3])
        return
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print('chip_compare: torch.cuda.is_available() is false',
              file=sys.stderr)
        sys.exit(2)
    other = sys.argv[1]
    rounds = int(sys.argv[sys.argv.index('--rounds') + 1]) \
        if '--rounds' in sys.argv else 1
    here = os.path.dirname(os.path.abspath(__file__))
    card = _card()
    print(f'[compare] {card}')
    turns = [('other', other), ('this', here), ('this', here),
             ('other', other)] * rounds
    ms = {'this': [], 'other': []}
    printed = set()
    with tempfile.TemporaryDirectory() as tmp:
        for k, (side, tree) in enumerate(turns):
            out = os.path.join(tmp, f'{side}_{k}.npz')
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), '--worker',
                 tree, out], capture_output=True, text=True, check=False,
                timeout=900)
            if proc.returncode:
                print(proc.stdout + proc.stderr, file=sys.stderr)
                raise SystemExit(f'the {side} turn {k} failed')
            got = json.loads(proc.stdout.strip().splitlines()[-1])
            ms[side].append(got['ms'])
            _print_build(side, got, printed)
            print(f'[compare] turn {k} {side} ({time.perf_counter() - t0:.1f}'
                  f' s): {ms[side][-1]}')
        a = np.load(os.path.join(tmp, 'this_1.npz'))
        b = np.load(os.path.join(tmp, 'other_0.npz'))
        same = {k: float((a[k] == b[k]).all(0).mean()) for k in a.files}
    print(f'[compare] {card} | share of paths (rays) equal bit for bit, '
          f'this vs other: {same}')
    res = {}
    for key in ms['this'][0]:
        mine = [m[key] for m in ms['this']]
        theirs = [m[key] for m in ms['other']]
        res[key] = {'this_ms': mine, 'other_ms': theirs,
                    'this_median': statistics.median(mine),
                    'other_median': statistics.median(theirs),
                    'ratio': statistics.median(mine)
                    / statistics.median(theirs)}
        print(f'[compare] {card} | {key}: this {res[key]["this_median"]:.4f}'
              f' ms, other {res[key]["other_median"]:.4f} ms (x'
              f'{res[key]["ratio"]:.3f}); turns this {mine}, other '
              f'{theirs}')
    print(json.dumps({'card': card, 'bit_equal_share': same, 'ms': res}))


if __name__ == '__main__':
    main()
