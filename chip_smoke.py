#!/usr/bin/env python3
'''
chip_smoke.py — drive the PyTorch/CUDA port's main path once on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

The main path has two routes, and the script drives both: the path
megakernel (one launch per sample, every megakernel-eligible scene) and
the wavefront (two cast launches per bounce).  Phases (each prints its
own lines; any failure raises and exits non-zero without the final line):

  1. device   — require CUDA, print the card's name and power limit,
                disable TF32.
  2. build    — compile both kernel libraries (csrc/dense_cast.cu and
                csrc/fused_path.cu) for sm_90a, two nvcc processes at once;
                print each kernel's ptxas registers, spills, stack and
                shared memory.
  3. kernels  — each CUDA cast against its plain torch version on the
                card: the cornell (40), cornell_monkey (984) and a random
                (2,504-face) table, at 262,144 rays and a ragged count.
                The megakernel against its plain twin (path_trace on the
                same uniforms) at 512x512, samples 0 and 7, on the five
                benchmark scenes (cornell, cornell_monkey, textured
                cornell, envlight, matball), its explicit-uniform head on
                cornell and matball, and two half frames (x0 = 0, 256)
                against the full frame, bit for bit.
  4. main     — with every launch count set to 0: the five scenes at
                512x512, 32 spp through ptina_tpu_torch.engine.path.render
                (the automatic route): 32 megakernel launches per scene
                and no cast launch.  Then, counts at 0 again, cornell and
                cornell_monkey through render_sample(fused=False): 5 x 32
                launches of each cast per scene and no megakernel launch.
  5. golden   — 64x64 renders against tests/golden (cornell 64 spp,
                cornell_monkey 96 spp) under tests/test_parity.py's
                tolerances, through both routes.
  6. timings  — each cast kernel and its plain version: device time per
                call from the profiler, and the per-call time a caller
                waits (CUDA-event median of 10, launch overhead included).
                Per scene and route: the megakernel's and its twin's
                device time per sample, samples/s of 512^2 x 32 spp
                renders (median of 3), the share of device time in the
                route's kernels, the device's busy share of the
                unprofiled wall time, and the host-device
                synchronisations in one sample.

The last two lines are a {"kernels": [...]} JSON object and
{"ok": true, "device": {...}}.  Imports nothing of JAX or ptina_tpu.
'''

import json
import os
import re
import statistics
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ptina_tpu_torch.camera import camera_rays
from ptina_tpu_torch.engine import fused
from ptina_tpu_torch.engine.path import render, render_sample, pixel_grid
from ptina_tpu_torch.film import new_film, film_to_image
from ptina_tpu_torch.intersect import dense_cast
from ptina_tpu_torch.io.encoding import decode_numpy_array
from ptina_tpu_torch.sampling.sobol import (pixel_rotation, sample_dims,
                                            sobol_block)
from ptina_tpu_torch.scene import make_scene
from ptina_tpu_torch.scenes import (cornell_box, cornell_monkey,
                                    envlight_scene, matball)
from ptina_tpu_torch.utils.vec import V3

ROOT = os.path.dirname(os.path.abspath(__file__))
DEV = 'cuda'
RES, SPP, DEPTH = 512, 32, 5
DIMS = 2 + 6 * DEPTH
N_FULL = RES * RES
N_RAGGED = 100_003
# kernel vs plain tolerances (the packed-key t grid is 2^-12 relative;
# FMA contraction in the kernel moves a verdict only on edge-grazing rays)
MIN_AGREE = 0.9999
T_RTOL = 5e-4
UV_RTOL, UV_ATOL = 1e-3, 1e-4
ATTR_ATOL = 1e-4
# megakernel vs its twin (tests/test_fused.py's tolerances): the share of
# paths that must agree, and per scene (absolute 1e-3 and means within
# 2e-3 relative) or (2e-2 relative to max(|ref|, 0.05), means within 1e-2)
PATH_AGREE = 0.95
KERNEL_SOURCE = 'ptina_tpu_torch/csrc/dense_cast.cu'
PATH_SOURCE = 'ptina_tpu_torch/csrc/fused_path.cu'
REPLACES = {'shade': 'ptina_tpu/intersect/pallas_cast.py:69',
            'any': 'ptina_tpu/intersect/pallas_cast.py:62',
            'path': 'ptina_tpu/engine/fused.py:648'}


def _bench_texture():
    '''The reference benchmark's 64x64 grey ramp (bench.py:149-151).'''
    return (np.linspace(0, 1, 64 * 64, dtype=np.float32)
            .reshape(64, 64, 1) * np.ones((1, 1, 3), np.float32))


# the five megakernel-eligible benchmark scenes (bench.py:224-256):
# name -> (scene function, compared relative to max(|ref|, 0.05)?)
SCENES = {
    'cornell': (lambda: cornell_box(device=DEV), False),
    'cornell_monkey': (lambda: cornell_monkey(device=DEV), False),
    'cornell_textured': (lambda: cornell_box(
        textured_image=_bench_texture(), device=DEV), True),
    'envlight': (lambda: envlight_scene(device=DEV), True),
    'matball': (lambda: matball(roughness_tex=_bench_texture(),
                                device=DEV), True),
}
WAVEFRONT_SCENES = ('cornell', 'cornell_monkey')


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


def _ptxas(log):
    '''{kernel: ptxas resource line} from an nvcc -Xptxas -v log.'''
    out, name = {}, None
    for line in log.splitlines():
        if 'entry function' in line:
            name = next((k for k in ('shade_kernel', 'any_kernel',
                                     'path_kernel') if k in line), None)
            if name:
                out[name] = ''
        elif name and ('stack frame' in line or 'registers' in line):
            out[name] += '; ' * bool(out[name]) + line.split(':')[-1].strip()
    return out


def phase_build():
    '''Both libraries, one nvcc each, started together.'''
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as ex:
        jobs = [ex.submit(m.build_library) for m in (dense_cast, fused)]
        logs = [j.result()[1] for j in jobs]
    dt = time.perf_counter() - t0
    print(f'[build] dense_cast.cu + fused_path.cu -> sm_90a, two nvcc in '
          f'parallel, {dt:.2f} s')
    res = {}
    for log in logs:
        if 'error' in log:
            print(f'[build] {log}')
        res.update(_ptxas(log))
    for name, info in res.items():
        print(f'[build] ptxas {name}: {info}')
        m = re.search(r'(\d+) bytes spill stores', info)
        if m and int(m.group(1)):
            print(f'[build] NOTE {name} spills {m.group(1)} bytes to local '
                  f'memory')
    return res


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


def _stack(v):
    return torch.stack([v.x, v.y, v.z])


def _hold(name, what, k, p, relative):
    '''Megakernel radiance k against its twin p ([3, N] each) under the
    scene's tolerance; returns the max abs error.'''
    if k.shape != p.shape:
        raise AssertionError(f'{name} {what}: shapes {k.shape} {p.shape}')
    finite = bool(torch.isfinite(k).all())
    d = (k - p).abs().amax(0)
    if relative:
        lim = 2e-2
        agree = ((k - p).abs() / torch.clamp_min(p.abs(), 0.05)).amax(0) < lim
        mean_lim = 1e-2
    else:
        lim = 1e-3
        agree = d < lim
        mean_lim = 2e-3
    share = agree.float().mean().item()
    km, pm = k.mean().item(), p.mean().item()
    mean_err = abs(km - pm) / max(pm, 1e-6)
    exact = (d == 0).float().mean().item()
    print(f'[kernels] path_kernel {name:<16} {what:<12} N={k.shape[1]} '
          f'bit-equal {exact:.4f}, within {"rel" if relative else "abs"} '
          f'{lim:g} {share:.4f} (>= {PATH_AGREE}), mean {km:.6f} vs '
          f'{pm:.6f} (rel err {mean_err:.2e} < {mean_lim:g}), max abs err '
          f'{d.max().item():.3e}')
    if not finite or share < PATH_AGREE or not mean_err < mean_lim:
        raise AssertionError(f'{name} {what}: megakernel and twin disagree')
    return d.max().item()


def phase_megakernel(scenes):
    '''The megakernel against its plain twin on every scene: both heads,
    and the half-frame composition.'''
    err = 0.0
    print(f'[kernels] path_kernel tolerances: >= {PATH_AGREE:.0%} of paths '
          f'within 1e-3 abs and means within 2e-3 (cornell, '
          f'cornell_monkey), or within 2e-2 of max(|ref|, 0.05) and means '
          f'within 1e-2 (the others)')
    for name, scene in scenes.items():
        relative = SCENES[name][1]
        if not fused.fused_eligible(scene):
            raise AssertionError(f'{name}: not eligible for the megakernel')
        for sample in (0, 7):
            pt = sobol_block(sample, DIMS)
            k = _stack(fused.fused_trace_primary(scene, pt, RES, RES))
            p = _stack(fused.fused_trace_primary_plain(scene, pt, RES, RES))
            err = max(err, _hold(name, f'primary s{sample}', k, p, relative))
        pt = sobol_block(3, DIMS)
        full = _stack(fused.fused_trace_primary(scene, pt, RES, RES))
        halves = [_stack(fused.fused_trace_primary(
            scene, pt, RES // 2, RES, x0=x0, fnx=RES, fny=RES))
            for x0 in (0, RES // 2)]
        same = torch.equal(full, torch.cat(halves, dim=1))
        print(f'[kernels] path_kernel {name:<16} half frames x0=0, '
              f'{RES // 2} == full frame bit for bit: {same}')
        if not same:
            raise AssertionError(f'{name}: half frames differ')
        if name in ('cornell', 'matball'):
            ii, jj = pixel_grid(RES, RES, device=DEV)
            u = sample_dims(11, ii, jj, DIMS)
            x = (ii.to(torch.float32) + u[0]) / RES * 2.0 - 1.0
            y = (jj.to(torch.float32) + u[1]) / RES * 2.0 - 1.0
            ro, rd = camera_rays(scene.cam_v2w, x, y)
            k = _stack(fused.fused_trace_uniforms(scene, ro, rd, u))
            p = _stack(fused.fused_trace_uniforms_plain(scene, ro, rd, u))
            err = max(err, _hold(name, 'uniforms', k, p, relative))
    torch.cuda.synchronize()
    return err


# ---------------------------------------------------------------- phase 4

def _zero_counts():
    for d in (dense_cast.LAUNCHES, fused.LAUNCHES):
        for k in d:
            d[k] = 0


def _counts():
    return {**dense_cast.LAUNCHES, **fused.LAUNCHES}


def _render_wavefront(scene, film, start, spp):
    '''render() on the wavefront route: render_sample(fused=False).'''
    _, _, nx, ny = film.shape
    ii, jj = pixel_grid(nx, ny, device=film.device)
    rot = pixel_rotation(ii, jj, DIMS)
    for s in range(spp):
        render_sample(scene, film, start + s, fused=False, rot=rot)
    return film


def _check_image(name, film, spp):
    img = film_to_image(film)[..., :3]
    if img.shape != (RES, RES, 3) or not bool(torch.isfinite(img).all()):
        raise AssertionError(f'{name}: image not finite / wrong shape')
    if bool((film[0, 3] != spp).any()):
        raise AssertionError(f'{name}: sample count channel != {spp}')
    return img.mean().item()


def phase_main(scenes):
    '''Both routes of the main path, each with every count at 0 just
    before it and read just after.  Returns (megakernel route counts,
    wavefront route counts).'''
    _zero_counts()
    for name, scene in scenes.items():
        before = _counts()
        film = new_film(RES, RES, device=DEV)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        film = render(scene, film, 0, spp=SPP)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        grew = {k: v - before[k] for k, v in _counts().items()}
        print(f'[main] megakernel route {name}: {RES}x{RES} x {SPP} spp in '
              f'{dt:.3f} s (first run), mean '
              f'{_check_image(name, film, SPP):.5f}, launches {grew}')
        want = {'path': SPP, 'shade': 0, 'any': 0}
        if grew != want:
            raise AssertionError(f'{name}: launches {grew}, expected {want}')
    mega = _counts()
    _zero_counts()
    for name in WAVEFRONT_SCENES:
        before = _counts()
        film = new_film(RES, RES, device=DEV)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        film = _render_wavefront(scenes[name], film, 0, SPP)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        grew = {k: v - before[k] for k, v in _counts().items()}
        print(f'[main] wavefront route {name}: {RES}x{RES} x {SPP} spp in '
              f'{dt:.3f} s (first run), mean '
              f'{_check_image(name, film, SPP):.5f}, launches {grew}')
        want = {'path': 0, 'shade': DEPTH * SPP, 'any': DEPTH * SPP}
        if grew != want:
            raise AssertionError(f'{name}: launches {grew}, expected {want}')
    return mega, _counts()


# ---------------------------------------------------------------- phase 5

def _blur(img, k=2):
    h, w, c = img.shape
    return img.reshape(h // (2 * k), 2 * k, w // (2 * k), 2 * k, c) \
              .mean(axis=(1, 3))


def phase_golden(scenes):
    # tests/test_parity.py: (spp, mean tolerance, patch tolerance)
    cases = {'cornell': (64, 0.015, 0.05), 'cornell_monkey': (96, 0.015, 0.06)}
    routes = {'megakernel': lambda sc, f, n: render(sc, f, 0, spp=n),
              'wavefront': lambda sc, f, n: _render_wavefront(sc, f, 0, n)}
    for name, (spp, mean_tol, patch_tol) in cases.items():
        with open(os.path.join(ROOT, 'tests', 'golden',
                               f'{name}_64x64_512spp.txt')) as fh:
            gold = decode_numpy_array(fh.read())
        for route, run in routes.items():
            before = fused.LAUNCHES['path']
            film = run(scenes[name], new_film(64, 64, device=DEV), spp)
            if (fused.LAUNCHES['path'] > before) != (route == 'megakernel'):
                raise AssertionError(f'{name}: {route} took the wrong route')
            img = film_to_image(film)[..., :3].cpu().numpy()
            mean_err = abs(img.mean() - gold.mean()) / gold.mean()
            patch = (np.abs(_blur(img) - _blur(gold))
                     / (_blur(gold) + 0.05)).mean()
            print(f'[golden] {name} 64x64 {spp} spp, {route}: mean err '
                  f'{mean_err:.5f} (< {mean_tol}), patch err {patch:.5f} '
                  f'(< {patch_tol})')
            if not (mean_err < mean_tol and patch < patch_tol):
                raise AssertionError(f'{name} ({route}): golden mismatch')


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


def _queued_us(work):
    '''Device time of work() (which must not synchronise) in us, with no
    host gap in it: the stream first spins (torch.cuda._sleep) for twice
    the wall time of a dry run of work(), so the host has enqueued all of
    it before the first event is reached.  CUDA events only: in a full run
    the profiler's trace lost megakernel launches (PERF.md), which this
    measure cannot.  For work of a few launches only: hundreds of small
    launches (the wavefront) fill the launch queue during the spin, and
    the host gaps come back.'''
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    work()
    torch.cuda.synchronize()
    dry = time.perf_counter() - t0
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(dry * 4e9) + 1_000_000)  # >= 2 x dry at <= 2 GHz
    a.record()
    work()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) * 1e3


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


def _profile_share(scene, use_fused):
    '''On one route (render_sample's fused flag), over two 512^2 samples:
    the device time of the route's kernels as a share of all device time
    (profiler, CUDA activity only), with the route launches the trace
    holds against the launches made; the device time of the two samples
    over their wall time without the profiler (median of 3 windows), the
    busy share, where the device time is the profiler's on the wavefront
    (hundreds of launches, too many for _queued_us; the trace rarely loses
    one of its cast launches) and _queued_us's on the megakernel route
    (three launches a sample, whose megakernel launches the trace does
    lose); and the number of host-device synchronisations in one sample
    (sync debug mode).'''
    from torch.profiler import profile, ProfilerActivity
    film = new_film(RES, RES, device=DEV)
    ii, jj = pixel_grid(RES, RES, device=DEV)
    rot = pixel_rotation(ii, jj, DIMS)
    names = ('path_kernel',) if use_fused else ('shade_kernel', 'any_kernel')

    def samples():
        for s in (1, 2):
            render_sample(scene, film, s, fused=use_fused, rot=rot)

    def two_samples():
        samples()
        torch.cuda.synchronize()

    two_samples()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        two_samples()
        walls.append(time.perf_counter() - t0)
    before = sum(_counts().values())
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        two_samples()
    launched = sum(_counts().values()) - before
    ka = prof.key_averages()
    traced = sum(_dev_us(e) for e in ka)
    kern = sum(_dev_us(e) for e in ka if any(n in e.key for n in names))
    recorded = sum(e.count for e in ka if any(n in e.key for n in names))
    busy = _queued_us(samples) if use_fused else traced
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        torch.cuda.set_sync_debug_mode('warn')
        try:
            render_sample(scene, film, 3, fused=use_fused, rot=rot)
        finally:
            torch.cuda.set_sync_debug_mode('default')
    torch.cuda.synchronize()
    syncs = [str(w.message) for w in caught
             if 'called a synchronizing' in str(w.message)]
    return dict(kern=kern, traced=traced, recorded=recorded,
                launched=launched, busy=busy,
                wall=statistics.median(walls) * 1e6, syncs=syncs)


def _path_times(scene):
    '''(megakernel device ms per sample, twin device ms per sample,
    megakernel per-call ms with launch) at 512^2, sample 9: the kernel's
    by CUDA events over 10 launches behind a spinning stream (_queued_us),
    the twin's from the profiler over 3 calls.'''
    pt = sobol_block(9, DIMS)

    def kern():
        return fused.fused_trace_primary(scene, pt, RES, RES)

    def kern10():
        for _ in range(10):
            kern()

    def twin():
        return fused.fused_trace_primary_plain(scene, pt, RES, RES)
    kern()
    return _queued_us(kern10) / 1e4, _device_ms(twin, reps=3), _event_ms(kern)


def _sps(run):
    '''Median wall time of 3 renders of 512^2 x SPP, and samples/s.'''
    runs = []
    for _ in range(3):
        film = new_film(RES, RES, device=DEV)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(film)
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
    dt = statistics.median(runs)
    return dt, SPP / dt


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
    pk = {}
    for name, scene in scenes.items():
        pk[name] = _path_times(scene)
        ms, plain, call = pk[name]
        print(f'[timing] {card} | path_kernel {name} {RES}x{RES}, depth '
              f'{DEPTH}: device {ms:.4f} ms/sample, plain twin (wavefront, '
              f'CUDA casts) {plain:.4f} ms/sample (x{plain / ms:.1f}); per '
              f'call with launch {call:.4f} ms')
    for name, scene in scenes.items():
        routes = {'megakernel': (True, lambda f: render(scene, f, 0,
                                                        spp=SPP))}
        routes['wavefront'] = (False, lambda f: _render_wavefront(
            scene, f, 0, SPP))
        for route, (use_fused, run) in routes.items():
            dt, sps = _sps(run)
            print(f'[timing] {card} | render {name} {route} {RES}x{RES} x '
                  f'{SPP} spp: median {dt:.4f} s of 3 -> {sps:.3f} '
                  f'samples/s ({1e3 * dt / SPP:.3f} ms/sample)')
            r = _profile_share(scene, use_fused)
            print(f'[timing] {card} | {name} {route} 2 samples: device '
                  f'{r["busy"] / 1e3:.3f} ms '
                  f'({"events" if use_fused else "profiler"}), busy '
                  f'{r["busy"] / r["wall"]:.1%} of {r["wall"] / 1e3:.3f} ms '
                  f'unprofiled wall (median of 3); profiler trace: route '
                  f'kernels {r["kern"] / 1e3:.3f} ms of '
                  f'{r["traced"] / 1e3:.3f} ms, {r["recorded"]} of '
                  f'{r["launched"]} route launches'
                  + ('' if r['recorded'] == r['launched']
                     else ' -- TRACE INCOMPLETE'))
            print(f'[timing] {name} {route}: {len(r["syncs"])} host-device '
                  f'synchronisations in one sample'
                  + (f'; first: {r["syncs"][0]}' if r['syncs'] else ''))
    return kt, pk


def main():
    card = phase_device()
    ptxas = phase_build()
    scenes = {name: make() for name, (make, _) in SCENES.items()}
    tables = {k: scenes[k] for k in WAVEFRONT_SCENES}
    tables['random_2504'] = _random_table(np.random.RandomState(3), 2500)
    errs = phase_kernels(tables)
    errs['path'] = phase_megakernel(scenes)

    mega, wave = phase_main(scenes)
    phase_golden(scenes)
    kt, pk = phase_timings(card, scenes, tables)

    kernels = [{'name': f'{k}_kernel', 'route': 'cuda',
                'source': KERNEL_SOURCE, 'replaces': REPLACES[k],
                'launches': wave[k], 'max_abs_err': errs[k],
                'ms': kt['cornell'][k][0], 'plain_ms': kt['cornell'][k][1],
                'call_ms': kt['cornell'][k][2],
                'ms_monkey': kt['cornell_monkey'][k][0],
                'plain_ms_monkey': kt['cornell_monkey'][k][1],
                'call_ms_monkey': kt['cornell_monkey'][k][2]}
               for k in ('shade', 'any')]
    kernels.append({
        'name': 'path_kernel', 'route': 'cuda', 'source': PATH_SOURCE,
        'replaces': REPLACES['path'], 'launches': mega['path'],
        'max_abs_err': errs['path'], 'ms': pk['cornell'][0],
        'plain_ms': pk['cornell'][1], 'call_ms': pk['cornell'][2],
        'ms_by_scene': {k: v[0] for k, v in pk.items()},
        'plain_ms_by_scene': {k: v[1] for k, v in pk.items()},
        'ptxas': ptxas.get('path_kernel', '')})
    print(card)
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
