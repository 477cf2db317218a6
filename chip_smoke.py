#!/usr/bin/env python3
'''
chip_smoke.py — drive the PyTorch/CUDA port's main path once on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises and exits non-zero
without the final line):

  1. device   — require CUDA, print the card's name and power limit,
                disable TF32.
  2. build    — compile the cast kernels (csrc/) with nvcc for sm_90a.
  3. kernels  — each CUDA cast against its plain torch version on the
                card: the cornell (40), cornell_monkey (984) and a random
                (2,504-face) table, at 262,144 rays and a ragged count.
  4. main     — render cornell_box and cornell_monkey at 512x512, 32 spp
                through ptina_tpu_torch.engine.path.render; the kernels'
                launch counters must grow by exactly 5 x 32 per scene.
  5. golden   — 64x64 renders against tests/golden (cornell 64 spp,
                cornell_monkey 96 spp) under tests/test_parity.py's
                tolerances.
  6. timings  — each kernel and its plain version: device time per call
                from the profiler, and the per-call time a caller waits
                (CUDA-event median of 10, launch overhead included);
                samples/s of both 512^2 x 32 spp renders; the share of
                device time spent in the two kernels, the device's busy
                share of the unprofiled wall time, and the host-device
                synchronisations in one sample.

The last two lines are a {"kernels": [...]} JSON object and
{"ok": true, "device": {...}}.  Imports nothing of JAX or ptina_tpu.
'''

import json
import os
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

from ptina_tpu_torch.engine.path import render, render_sample, pixel_grid
from ptina_tpu_torch.film import new_film, film_to_image
from ptina_tpu_torch.intersect import dense_cast
from ptina_tpu_torch.io.encoding import decode_numpy_array
from ptina_tpu_torch.sampling.sobol import pixel_rotation
from ptina_tpu_torch.scene import make_scene
from ptina_tpu_torch.scenes import cornell_box, cornell_monkey
from ptina_tpu_torch.utils.vec import V3

ROOT = os.path.dirname(os.path.abspath(__file__))
DEV = 'cuda'
RES, SPP, DEPTH = 512, 32, 5
N_FULL = RES * RES
N_RAGGED = 100_003
# kernel vs plain tolerances (the packed-key t grid is 2^-12 relative;
# FMA contraction in the kernel moves a verdict only on edge-grazing rays)
MIN_AGREE = 0.9999
T_RTOL = 5e-4
UV_RTOL, UV_ATOL = 1e-3, 1e-4
ATTR_ATOL = 1e-4
KERNEL_SOURCE = 'ptina_tpu_torch/csrc/dense_cast.cu'
REPLACES = {'shade': 'ptina_tpu/intersect/pallas_cast.py:69',
            'any': 'ptina_tpu/intersect/pallas_cast.py:62'}


def card_line():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def phase_device():
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is false', file=sys.stderr)
        sys.exit(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f'[device] {card}')
    print(f'[device] torch {torch.__version__} cuda {torch.version.cuda} '
          f'python {sys.version.split()[0]} devices '
          f'{torch.cuda.device_count()}')
    return card


def phase_build():
    t0 = time.perf_counter()
    _, log = dense_cast.build_library()
    dt = time.perf_counter() - t0
    print(f'[build] dense_cast.cu -> sm_90a in {dt:.2f} s')
    for line in log.splitlines():
        if 'registers' in line or 'spill' in line or 'error' in line:
            print(f'[build] {line.strip()}')
    return dt


# ---------------------------------------------------------------- phase 3

def _random_table(rng, nf):
    tris = (rng.randn(nf, 3, 3) * 2.0).astype(np.float32)
    verts = np.concatenate([tris.reshape(-1, 3),
                            np.tile([[0.0, 0.0, 1.0]], (nf * 3, 1)),
                            np.zeros((nf * 3, 2))], axis=1)
    mtl = rng.randint(-1, 4, size=nf).astype(np.int32)
    return make_scene(verts, mtl, device=DEV)


def _rays(rng, scene, n):
    '''Rays from inside the cornell box in random directions, a quarter
    of them avoiding a random face, a few parked (origin 0, +z, tmax 0)
    and a few with tmax beyond the far clip.'''
    f = scene.face_coef.shape[0]
    o = np.stack([rng.uniform(-1.9, 1.9, n), rng.uniform(0.1, 3.9, n),
                  rng.uniform(-1.9, 1.9, n)], 1).astype(np.float32)
    d = rng.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    avoid = np.where(rng.rand(n) < 0.25, rng.randint(0, f, n), -1)
    tmax = rng.uniform(0.0, 6.0, n).astype(np.float32)
    park = rng.rand(n) < 0.01
    o[park] = 0.0
    d[park] = (0.0, 0.0, 1.0)
    tmax[park] = 0.0
    tmax[rng.rand(n) < 0.01] = 3e6

    def t(a, dt=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=DEV)
    ro = V3(t(o[:, 0]), t(o[:, 1]), t(o[:, 2]))
    rd = V3(t(d[:, 0]), t(d[:, 1]), t(d[:, 2]))
    return ro, rd, t(avoid, torch.int32), t(tmax)


def _compare(name, scene, ro, rd, avoid, tmax):
    hk, ak = dense_cast.cast_shade(ro, rd, avoid, scene.face_coef,
                                   scene.face_attr)
    hp, ap = dense_cast.cast_shade_plain(ro, rd, avoid, scene.face_coef,
                                         scene.face_attr)
    ok_k = dense_cast.cast_any(ro, rd, avoid, tmax, scene.face_coef)
    ok_p = dense_cast.cast_any_plain(ro, rd, avoid, tmax, scene.face_coef)
    torch.cuda.synchronize()
    n = ro.x.shape[0]
    same = (hk.index == hp.index) & (hk.hit == hp.hit)
    agree = same.float().mean().item()
    hitm = same & hp.hit
    t_err = (hk.t - hp.t).abs()[hitm]
    t_rel = (t_err / hp.t.abs()[hitm]).max().item() if hitm.any() else 0.0
    uv_err = torch.maximum((hk.u - hp.u).abs(), (hk.v - hp.v).abs())[hitm]
    uv_lim = UV_ATOL + UV_RTOL * torch.maximum(hp.u.abs(), hp.v.abs())[hitm]
    att_err = (ak - ap).abs()[:, same].max().item() if same.any() else 0.0
    occ_agree = (ok_k == ok_p).float().mean().item()
    shade_err = max(t_err.max().item() if hitm.any() else 0.0,
                    uv_err.max().item() if hitm.any() else 0.0, att_err)
    print(f'[kernels] {name:<16} N={n:>7} hit={hp.hit.float().mean().item():.3f}'
          f' index agree={agree:.6f} t max rel={t_rel:.2e} uv max '
          f'abs={uv_err.max().item() if hitm.any() else 0.0:.2e} attrs max '
          f'abs={att_err:.2e} occ={ok_p.float().mean().item():.3f} occ '
          f'agree={occ_agree:.6f}')
    if agree < MIN_AGREE or occ_agree < MIN_AGREE:
        raise AssertionError(f'{name}: kernel and plain disagree on more '
                             f'than {1 - MIN_AGREE:.4%} of rays')
    if t_rel > T_RTOL or att_err > ATTR_ATOL or bool((uv_err > uv_lim).any()):
        raise AssertionError(f'{name}: kernel t/u/v/attrs out of tolerance')
    return shade_err, float((ok_k != ok_p).any().item())


def phase_kernels(tables):
    rng = np.random.RandomState(20)
    errs = {'shade': 0.0, 'any': 0.0}
    print(f'[kernels] tolerances: index and occlusion equal on >= '
          f'{MIN_AGREE:.2%} of rays; where indices agree t rtol {T_RTOL}, '
          f'u/v rtol {UV_RTOL} atol {UV_ATOL}, attrs atol {ATTR_ATOL}')
    for name, scene in tables.items():
        for n in (N_FULL, N_RAGGED):
            e_sh, e_any = _compare(name, scene, *_rays(rng, scene, n))
            errs['shade'] = max(errs['shade'], e_sh)
            errs['any'] = max(errs['any'], e_any)
    return errs


# ---------------------------------------------------------------- phase 4

def phase_main(scenes):
    out = {}
    for name, scene in scenes.items():
        before = dict(dense_cast.LAUNCHES)
        film = new_film(RES, RES, device=DEV)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        film = render(scene, film, 0, spp=SPP)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        img = film_to_image(film)[..., :3]
        grew = {k: dense_cast.LAUNCHES[k] - before[k] for k in before}
        print(f'[main] {name}: {RES}x{RES} x {SPP} spp in {dt:.3f} s '
              f'(first run), mean {img.mean().item():.5f}, launches {grew}')
        if img.shape != (RES, RES, 3) or not bool(torch.isfinite(img).all()):
            raise AssertionError(f'{name}: image not finite / wrong shape')
        if bool((film[0, 3] != SPP).any()):
            raise AssertionError(f'{name}: sample count channel != {SPP}')
        for k, g in grew.items():
            if g != DEPTH * SPP:
                raise AssertionError(f'{name}: {k} launched {g} times, '
                                     f'expected {DEPTH * SPP}')
        out[name] = grew
    return out


# ---------------------------------------------------------------- phase 5

def _blur(img, k=2):
    h, w, c = img.shape
    return img.reshape(h // (2 * k), 2 * k, w // (2 * k), 2 * k, c) \
              .mean(axis=(1, 3))


def phase_golden(scenes):
    # tests/test_parity.py: (spp, mean tolerance, patch tolerance)
    cases = {'cornell': (64, 0.015, 0.05), 'cornell_monkey': (96, 0.015, 0.06)}
    for name, (spp, mean_tol, patch_tol) in cases.items():
        with open(os.path.join(ROOT, 'tests', 'golden',
                               f'{name}_64x64_512spp.txt')) as fh:
            gold = decode_numpy_array(fh.read())
        film = render(scenes[name], new_film(64, 64, device=DEV), 0, spp=spp)
        img = film_to_image(film)[..., :3].cpu().numpy()
        mean_err = abs(img.mean() - gold.mean()) / gold.mean()
        patch = (np.abs(_blur(img) - _blur(gold))
                 / (_blur(gold) + 0.05)).mean()
        print(f'[golden] {name} 64x64 {spp} spp: mean err {mean_err:.5f} '
              f'(< {mean_tol}), patch err {patch:.5f} (< {patch_tol})')
        if not (mean_err < mean_tol and patch < patch_tol):
            raise AssertionError(f'{name}: golden mismatch')


# ---------------------------------------------------------------- phase 6

def _event_ms(fn, reps=10, warm=3):
    """Median of `reps` single calls timed with CUDA events: the time a
    caller waits per call, host launch overhead included."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _dev_us(evt):
    for attr in ('self_device_time_total', 'self_cuda_time_total'):
        v = getattr(evt, attr, None)
        if v:
            return v
    return 0.0


def _device_ms(fn, reps=10):
    """Device time per call from the profiler: the summed device time of
    every kernel the call launched, over `reps` calls (launch overhead
    excluded)."""
    from torch.profiler import profile, ProfilerActivity
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(_dev_us(e) for e in prof.key_averages()) / 1e3 / reps


def _kernel_times(scene, rays):
    """{kernel: (device ms, plain device ms, call ms, plain call ms)};
    the per-call timings run plain, kernel, kernel, plain."""
    ro, rd, avoid, tmax = rays
    c, at = scene.face_coef, scene.face_attr
    calls = {
        'shade': (lambda: dense_cast.cast_shade(ro, rd, avoid, c, at),
                  lambda: dense_cast.cast_shade_plain(ro, rd, avoid, c, at)),
        'any': (lambda: dense_cast.cast_any(ro, rd, avoid, tmax, c),
                lambda: dense_cast.cast_any_plain(ro, rd, avoid, tmax, c)),
    }
    out = {}
    for k, (kern, plain) in calls.items():
        p1, k1, k2, p2 = (_event_ms(plain), _event_ms(kern), _event_ms(kern),
                          _event_ms(plain))
        out[k] = (_device_ms(kern), _device_ms(plain),
                  statistics.median([k1, k2]), statistics.median([p1, p2]))
    return out


def _profile_share(scene):
    '''Device time of the two cast kernels over two 512^2 samples, as a
    share of all device time; the device time of those two samples over
    their wall time without the profiler (median of 3 windows), so the
    profiler's own host cost does not inflate the wall; and the number of
    host-device synchronisations in one sample (sync debug mode).'''
    from torch.profiler import profile, ProfilerActivity
    film = new_film(RES, RES, device=DEV)
    ii, jj = pixel_grid(RES, RES, device=DEV)
    rot = pixel_rotation(ii, jj, 2 + 6 * DEPTH)

    def two_samples():
        for s in (1, 2):
            render_sample(scene, film, s, rot=rot)
        torch.cuda.synchronize()

    two_samples()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        two_samples()
        walls.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        two_samples()
    ka = prof.key_averages()
    total = sum(_dev_us(e) for e in ka)
    casts = sum(_dev_us(e) for e in ka
                if 'shade_kernel' in e.key or 'any_kernel' in e.key)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        torch.cuda.set_sync_debug_mode('warn')
        try:
            render_sample(scene, film, 3, rot=rot)
        finally:
            torch.cuda.set_sync_debug_mode('default')
    torch.cuda.synchronize()
    syncs = [str(w.message) for w in caught
             if 'called a synchronizing' in str(w.message)]
    return casts, total, statistics.median(walls) * 1e6, syncs


def phase_timings(card, scenes, tables):
    rng = np.random.RandomState(7)
    kt = {}
    for name in ('cornell', 'cornell_monkey'):
        rays = _rays(rng, tables[name], N_FULL)
        kt[name] = _kernel_times(tables[name], rays)
        for k, (ms, plain, call, pcall) in kt[name].items():
            print(f'[timing] {card} | {k:<5} kernel {name} {N_FULL} rays: '
                  f'device {ms:.4f} ms, plain torch {plain:.4f} ms '
                  f'(x{plain / ms:.1f}); per call with launch {call:.4f} '
                  f'ms, plain {pcall:.4f} ms')
    sps = {}
    for name, scene in scenes.items():
        runs = []
        for _ in range(3):
            film = new_film(RES, RES, device=DEV)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            render(scene, film, 0, spp=SPP)
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t0)
        dt = statistics.median(runs)
        sps[name] = SPP / dt
        cast_ms = DEPTH * sum(v[0] for v in kt[name].values())
        est = cast_ms / (1e3 * dt / SPP)
        print(f'[timing] {card} | render {name} {RES}x{RES} x {SPP} spp: '
              f'median {dt:.4f} s of 3 -> {sps[name]:.3f} samples/s '
              f'({1e3 * dt / SPP:.3f} ms/sample); casts from isolated '
              f'kernel device times {cast_ms:.3f} ms/sample = {est:.1%}')
        casts, total, wall, syncs = _profile_share(scene)
        if total > 0:
            print(f'[timing] {card} | profiler {name} 2 samples: cast '
                  f'kernels {casts / 1e3:.3f} ms of {total / 1e3:.3f} ms '
                  f'device time ({casts / total:.1%}); device busy '
                  f'{total / wall:.1%} of {wall / 1e3:.3f} ms unprofiled '
                  f'wall (median of 3)')
        else:
            print(f'[timing] {card} | profiler {name}: no device time '
                  f'recorded (see the isolated-kernel estimate above)')
        print(f'[timing] {name}: {len(syncs)} host-device synchronisations '
              f'in one sample' + (f'; first: {syncs[0]}' if syncs else ''))
    return kt, sps


def main():
    card = phase_device()
    phase_build()
    scenes = {'cornell': cornell_box(device=DEV),
              'cornell_monkey': cornell_monkey(device=DEV)}
    tables = dict(scenes)
    tables['random_2504'] = _random_table(np.random.RandomState(3), 2500)
    errs = phase_kernels(tables)

    for k in dense_cast.LAUNCHES:
        dense_cast.LAUNCHES[k] = 0
    launches = phase_main(scenes)
    total = {k: sum(g[k] for g in launches.values())
             for k in dense_cast.LAUNCHES}

    phase_golden(scenes)
    kt, _ = phase_timings(card, scenes, tables)

    kernels = [{'name': f'{k}_kernel', 'route': 'cuda',
                'source': KERNEL_SOURCE, 'replaces': REPLACES[k],
                'launches': total[k], 'max_abs_err': errs[k],
                'ms': kt['cornell'][k][0], 'plain_ms': kt['cornell'][k][1],
                'call_ms': kt['cornell'][k][2],
                'ms_monkey': kt['cornell_monkey'][k][0],
                'plain_ms_monkey': kt['cornell_monkey'][k][1],
                'call_ms_monkey': kt['cornell_monkey'][k][2]}
               for k in ('shade', 'any')]
    print(card)
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
