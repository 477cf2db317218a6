#!/usr/bin/env python3
'''
chip_smoke.py — drive the PyTorch/CUDA port's main path once on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

The main path has three routes, and the script drives each: the path
megakernel (one launch per sample, every megakernel-eligible scene), the
wavefront with the dense casts (two cast launches per bounce, each
walking the scene's box tree), and the wavefront with the blocked casts
on the big scene (cornell_highpoly, 101,782 faces, whose two casts walk a
box tree over 32-face leaves); beside them the table-level entry point
intersect.cast_closest / cast_any, whose flat kernels test every face.
Phases (each prints its own lines; any failure raises and exits non-zero
without the final line):

  1. device   — require CUDA, print the card's name and power limit,
                disable TF32; count the lanes where CUDA's torch.sqrt
                and the port's mathutils.sqrt (on the card and on the
                host) differ from the float64 root rounded to float32,
                on 2^20 float32 values (normal, subnormal, [0.01, 100]
                and the special values): [sqrt], 0 each or exit non-zero.
  2. build    — compile the three kernel libraries (csrc/dense_cast.cu,
                csrc/fused_path.cu and csrc/blocked_cast.cu) for sm_90a,
                three nvcc processes at once; print each kernel's ptxas
                registers, spills, stack and shared memory, and, where
                cuobjdump is there, the instructions of one face's common
                path in closest_kernel's loop ([sass]).
  3. kernels  — each dense CUDA cast (the tree shade and any, the flat
                closest and any_flat) against its plain torch version on
                the card: the five benchmark scenes (cornell and textured
                cornell, 40 faces; cornell_monkey, 968; envlight and
                matball, 2,216) and a random 2,504-face table, at 262,144
                rays and a ragged count, and the tree casts on the
                wavefront's own rays (every bounce's closest and shadow
                cast of a 512x512 sample of each scene).  The two blocked
                casts against theirs on cornell_highpoly (101,888 faces in
                199 blocks) at the same counts, and on its own 512x512
                camera rays (the first bounce of the main path).  The
                flat casts (closest_kernel, any_flat_kernel) bit for bit
                against their plain versions on the six tables at both
                counts.  The
                megakernel against its plain twin (path_trace on the same
                uniforms) at 512x512, samples 0 and 7 at depth 5 and
                sample 0 at depth 8, on the five scenes, its
                explicit-uniform head on cornell and matball, two half
                frames (x0 = 0, 256) against the full frame, bit for bit,
                and its explicit-ray head (fused_trace) on the five
                scenes against its twin at the primary head's gate and
                bit for bit against fused_trace_primary fed the same
                camera rays and wanghash2(i, j).
  4. main     — each route with every launch count set to 0 just before
                it and read just after: the five scenes at 512x512, 32 spp
                through ptina_tpu_torch.engine.path.render (the automatic
                route): 32 megakernel launches per scene and no cast
                launch; the five through render_sample(fused=False): 5 x
                32 launches of each tree cast per scene and no flat one;
                cornell_monkey at depth 8 through each dense route;
                cornell_highpoly at 512x512, 8 spp through render (the
                automatic route takes the blocked wavefront): 5 x 8
                launches of each blocked cast and nothing else; the
                table-level cast_closest / cast_any on cornell_monkey's
                faces: one launch of each flat kernel; fused_trace on the
                five scenes' camera rays: one path launch each and nothing
                else; blocked_cast_closest on cornell_highpoly's camera
                rays: one blocked_shade launch, its Hit equal to
                blocked_cast_shade's bit for bit.
  5. capacity — cornell_highpoly(nu=640, nv=240) (305,942 faces, 598
                blocks): the 32-ray float64 oracle of root bench.py:183-214
                (ptina_tpu_torch.bench.oracle_agreement; >= 31 of 32
                agree, t within 2e-3 relative), and a 256x256 x 2 spp
                render.
  6. golden   — 64x64 renders against tests/golden (cornell 64 spp,
                cornell_monkey 96 spp) under tests/test_parity.py's
                tolerances, through both dense routes; cornell_monkey
                also built with accel='blocked', through the blocked
                casts.
  7. timings  — each cast kernel and its plain version: device time per
                call (CUDA events around calls queued behind a spinning
                stream), and the per-call time a caller waits (CUDA-event
                median, launch overhead included): the dense casts at
                262,144 random rays on the six tables (the flat ones
                beside their no-contraction ceiling: their needed FP32
                operations as instructions at 33.5e12 a second), the
                blocked casts on cornell_highpoly, and the explicit-ray
                head beside the primary head at 512^2.  Each kernel's
                bound: the least time the card could take for its work on
                those inputs, the larger of its FP32 operations over 67
                TFLOP/s and its bytes over 3.35 TB/s, and beside it its
                no-contraction ceiling (the same operations as
                instructions at 33.5e12 a second).  Every kernel needs the
                sign test's 29 operations on each pair its rays need and
                7 more on each of them that passes the test (both counted
                with the plain arithmetic, plucker.pair_side's, on the
                same rays).  A flat cast needs every ray against every
                face (closest) or a ray's faces up to its first occluder
                (any_flat).  A tree kernel's pairs are the live faces of
                the leaves of its box tree a ray must enter (the slab
                test of blocked.leaf_pairs): on the timed rays, and for
                the megakernel and the dense tree casts on the rays of
                each bounce of the twin (path_trace's lanes), beside the
                all-faces count; for the megakernel also the pairs the
                same rays need on trees over index and Morton order.
                Beside each bound the tree nodes and leaves the kernels
                visit (their own counters: dense_cast_visits,
                blocked_cast_visits, fused_trace_visits; per cast, and a
                warp's slowest ray).  Per scene and route: the
                megakernel's and its twin's device time per sample,
                samples/s of 512^2 renders (32 spp; 8 on
                cornell_highpoly; median of 3), the share of device time
                in the route's kernels, the device's busy share of the
                unprofiled wall time, and the host-device
                synchronisations in one sample.
  8. engines  — the other engines and the worker, each with every count
                at 0 just before it and read just after, at the reference
                benchmark's settings: render_preview on matball (the 64x64
                ramp) and cornell_highpoly at 512^2 x 1 spp (exactly one
                shade / blocked_shade launch a sample; AOV passes finite
                and equal to the same preview through the plain casts on
                >= 99.99% of pixels); render_brute on cornell at 512^2 x
                32 spp (5 shade launches a sample, no occlusion cast; mean
                within 8% of the path render); MLT on cornell_monkey at
                bench.py:154-170's cell (512^2 film, 2^17 chains, rounds of
                4 steps, 1 warm-up and 4 timed: one path_kernel launch a
                step, no cast; mutations/s; one step's replay through the
                kernel against path_trace, bit for bit on >= 99.99% of
                chains; the step's device time split into replay,
                proposals and splat; busy share; 0 host-device
                synchronisations a step) and Kelemen's brightness on
                cornell at 64^2 within 5% of the path render; the worker
                at 512^2 ('path', 'brute', 'mlt', render_preview; its path
                image equal to render's bit for bit; save_state /
                load_state resuming bit for bit); cornell_highpoly built
                with accel='dense' through the brute route against the
                blocked route at 64^2 x 1 spp.
  9. grad     — the gradients (ptina_tpu_torch.diff) at 512^2, depth 5,
                1 spp a call, each call with every count at 0 just before
                it and read just after: material_grad on cornell_monkey
                through the pair (engine/fused.fused_trace_diff: 1 path, 5
                shade and 5 any launches) and the wavefront (5 + 5):
                losses within 2e-3, gradients allclose(rtol=0.05, atol=1e-4
                max|g|), the white wall's basecolor red against a central
                difference (5%); texture_grad on matball (the 64x64
                roughness ramp) through the pair: finite, channels 1-3
                zero, a share of channel 0 strictly between 0 and 1
                nonzero, the highest-gradient texel against a central
                difference; the light color (cornell) and world factor
                (envlight) in the image mean against central differences;
                material_grad on cornell_highpoly (the blocked wavefront, 5
                blocked_shade + 5 blocked_any) finite and one factor
                against its difference; 4 inverse_render_steps on cornell
                toward a darker wall (the loss falls; fac - lr g bit for
                bit).  Per gradient call: wall ms of its forward and
                backward, device ms (profiler; path_kernel by CUDA
                events), busy share and peak memory.
 10. scale    — the scale-out path, each item with every count at 0 just
                before it and read just after: render(spp=32, spb=8) and
                spb=1 on the five scenes at 512^2 (equal films bit for
                bit, 32 path launches each); parallel.render_sharded on a
                mesh of 4 x the card at 512^2, no collective of
                torch.distributed allowed while it renders: cornell_monkey
                x 8 spp on the megakernel (4 x 8 path launches) and on the
                wavefront (fused=False; 5 x 4 x 8 of each tree cast) and
                cornell_highpoly x 2 spp on the blocked route (5 x 4 x 2
                of each blocked cast), each equal to the one-band render
                bit for bit, samples/s of both; train_step_sharded on
                cornell_monkey at 512^2, 4 bands (5 x 4 of each tree
                cast): the gradient allclose(rtol=1e-3) to the one-band
                wavefront material_grad, two steps lower the loss, the
                step's wall and device ms; the two-process launcher
                (python -m ptina_tpu_torch.parallel, two ranks on the card
                over gloo, 256^2 x 4 spp): the bands and the gathered film
                equal a one-process render bit for bit, no collective
                while rendering, the gradient all-reduce equal to the
                in-process mean, wall and samples/s; lbvh_build on the
                card over cornell_monkey's, envlight's and
                cornell_highpoly's live faces (build ms, invariants) and
                lbvh_traverse on 65,536 random rays of the first two
                against brute (the same face on > 97%, t within 1e-4),
                beside one closest_kernel launch on the same rays.
 11. frontends — the scene front-ends feeding the worker at 512^2, each
                item with every count at 0 just before it and read just
                after, its assets written at run time under build/:
                (a) cornell_monkey as a glTF asset (five primitives
                under TRS and `matrix` nodes, uint16 / uint32 indices,
                one byteStride view), once .gltf with a data-URI buffer
                and once .glb, through io.readgltf and the worker at 32
                spp: 32 path launches and no cast each, both images and
                that of the worker fed compose_multiple_meshes of the
                same primitives equal bit for bit, the megakernel against
                its twin on the loaded scene; (b) matball as a GLB with
                its roughness ramp an 8-bit PNG encoded here (io._png)
                and bound as the metallicRoughness texture: the ramp
                decodes as encoded, 32 path launches on a scene with a
                texture atlas, the megakernel against its twin; (c)
                cornell_highpoly as a GLB through the worker at 8 spp:
                40 blocked_shade + 40 blocked_any launches, the composed
                arrays' image bit for bit; (d) readply of binary and
                ASCII PLYs of cornell_highpoly, and writeobj of
                cornell_monkey into worker.load_model(path) with
                obj_mtlids' ids: arrays exact; (e) the Blender engine's
                calls without bpy through DaemonModule(worker): the sync
                (principled_to_material, light_to_pool_entry,
                world_background, sync_worker) of a two-object scene,
                the final render (32 x render(), one render_preview(),
                the three RENDER_PASSES), its Combined pass equal to the
                same calls on this thread bit for bit, a daemon-thread
                error raised here, and the ViewportRefiner ladder from
                1/8 of 512^2 through viewport_pass; (f) the six examples
                (python -m ptina_tpu_torch.examples.<name>) as
                subprocesses at once: exit 0, smoke_render 512 32
                monkey's printed mean equal to this process's render,
                their PNGs decoded.  Prints the readers' seconds, the
                time from load to the first image, samples/s and the
                viewport rungs' ms.
 12. bench    — the port's benchmark, python -m ptina_tpu_torch.bench, as
                a subprocess (its own timeout; it reuses the libraries
                phase 2 built): exit 0 and exactly its eight metric lines,
                in ptina_tpu_torch.bench.CONFIGS order (root bench.py's
                metrics with the prefix torch_), each with a finite
                positive value, unit, vs_baseline, device, route and the
                timed window's launches equal to the route's
                (expected_launches); its lines echoed as [bench] lines,
                each value beside this script's number for the same cell
                (the timings phase's median of 3, phase 8's MLT rate).
                Then, in this process, one bench window (bench.time_render)
                per megakernel configuration and the device time of the
                same frames, each queued behind a spinning stream and
                timed with CUDA events: the window's busy share; and one
                window of cornell_highpoly, its host counters beside the
                subprocess line's (bench.host_since); a CPU probe (a fixed
                Python loop) at the phase's start and end, and before
                the timings phase's highpoly route.

The last two lines are a {"kernels": [...]} JSON object (per kernel:
launches on the main path and per sample, its largest error against its
plain version, its time, its plain version's time, its bound and what
sets it, and library_ms, null: no single PyTorch call computes a ray-face
closest hit, occlusion or path; launches_grad_* its launches in one
gradient call of phase 9; launches_scale its launches in each item of
phase 10; launches_frontends its launches in each item of phase 11;
launches_bench / launches_bench_all its launches in each bench line's
timed window / in all of that metric's work, where it has any) and
{"ok": true, "device": {...}}.
Imports nothing of JAX or ptina_tpu.
'''

import base64
import contextlib
import json
import math
import os
import re
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ptina_tpu_torch import intersect, worker
from ptina_tpu_torch.bench import (CONFIGS as BENCH_CONFIGS, bench_texture,
                                   card_line, check_launches,
                                   expected_launches, oracle_agreement,
                                   time_render)
from ptina_tpu_torch.blender import (PRINCIPLED_SOCKETS, RENDER_PASSES,
                                     ViewportRefiner, light_to_pool_entry,
                                     principled_to_material, sync_worker,
                                     viewport_pass, world_background)
from ptina_tpu_torch.camera import camera_rays
from ptina_tpu_torch.diff import (_loss_and_grad, inverse_render_step,
                                  material_grad, render_image_diff,
                                  texture_grad)
from ptina_tpu_torch.engine import fused, mlt
from ptina_tpu_torch.engine.brute import render_brute
from ptina_tpu_torch.engine.mlt import mlt_init, mlt_step, render_mlt
from ptina_tpu_torch.engine.path import (render, render_sample, pixel_grid,
                                         path_trace)
from ptina_tpu_torch.engine.preview import render_preview
from ptina_tpu_torch.film import (new_film, film_to_image, film_splat,
                                  PASS_ALBEDO, PASS_NORMAL)
from ptina_tpu_torch.intersect import blocked, brute, dense_cast, dispatch
from ptina_tpu_torch.intersect.lbvh import lbvh_build, lbvh_traverse
from ptina_tpu_torch.intersect.plucker import (face_chunk, pair_hits,
                                            pair_side, ray_features)
from ptina_tpu_torch.io import _png as png_codec, matrix as gl_matrix
from ptina_tpu_torch.io.encoding import decode_numpy_array
from ptina_tpu_torch.io.multimesh import compose_multiple_meshes
from ptina_tpu_torch.io.readgltf import readgltf
from ptina_tpu_torch.io.readobj import obj_mtlids, readply, writeobj
from ptina_tpu_torch.parallel import (make_mesh, render_sharded,
                                      train_step_sharded)
from ptina_tpu_torch.parallel.distributed import _collectives_raise
from ptina_tpu_torch.sampling import wanghash2
from ptina_tpu_torch.sampling.sobol import (pixel_rotation, sample_dims,
                                            sobol_block)
from ptina_tpu_torch.scene import (make_scene, compute_node_bounds,
                                   morton_face_order, with_tensor)
from ptina_tpu_torch.scenes import (cornell_box, cornell_monkey,
                                    cornell_highpoly, envlight_scene,
                                    matball, BENCH_CAMERA, _cornell_shell,
                                    _cornell_boxes, _mesh_to_vertices,
                                    _materials, _ceiling_light, _blob_parts,
                                    _quad, _uv_sphere, _sphere_smooth_normals,
                                    _sphere_uvs, _CORNELL_MATERIALS_SPEC)
from ptina_tpu_torch.utils.daemon import DaemonModule
from ptina_tpu_torch.utils.mathutils import INF, sqrt as port_sqrt
from ptina_tpu_torch.utils.kernel_report import (ptxas_by_kernel, sass,
                                                 face_loop_path)
from ptina_tpu_torch.utils.trace import set_verbosity
from ptina_tpu_torch.utils.vec import V3

ROOT = os.path.dirname(os.path.abspath(__file__))
DEV = 'cuda'
RES, SPP, DEPTH = 512, 32, 5
DIMS = 2 + 6 * DEPTH
# a depth above the 5 of the first slices: a 50-dimension Sobol point
DEEP = 8
DEEP_SPP = 4
N_FULL = RES * RES
N_RAGGED = 100_003
# the big scene: the reference benchmark's highpoly cell is 512^2 x 8 spp
# (bench.py:232-234); its capacity check 256^2 x 2 spp (bench.py:216)
HIGHPOLY_SPP = 8
CAPACITY_RES, CAPACITY_SPP = 256, 2
# the other engines at the reference benchmark's settings: brute 32 spp;
# MLT's cell (bench.py:154-170): 2^17 chains, rounds of 4 steps, one
# warm-up round and 4 timed; Kelemen's brightness check
# (tests/test_mlt_quant.py) on cornell at 64^2
BRUTE_SPP = 32
MLT_CHAINS, MLT_STEPS, MLT_ROUNDS = 2 ** 17, 4, 4
KELEMEN_CHAINS, KELEMEN_STEPS, KELEMEN_PATH_SPP = 2 ** 16, 128, 256
# the gradients: inverse_render_step's steps and rate (the reference's
# default rate is 0.1; at 1.0 four steps move the loss visibly)
INVERSE_STEPS, INVERSE_LR = 4, 1.0
# the scale-out phase: film bands on a mesh of 4 x the card (8 spp; 2 on
# cornell_highpoly), render's samples per group, the two-process launcher
# (256^2 x 4 spp), the LBVH oracle's random rays
SCALE_BANDS, SCALE_SPP, SCALE_HIGHPOLY_SPP, SCALE_SPB = 4, 8, 2, 8
TWO_PROC_RES, TWO_PROC_SPP = 256, 4
LBVH_RAYS = 65_536
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
# the bound's peaks (NVIDIA's H100 SXM data sheet, at a 700 W limit):
# FP32 outside the tensor cores, and HBM3
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# FP32 operations of one ray-face pair (csrc/plucker.cuh), for every
# kernel: the sign test (face_side: U and V 6 products + 5 sums each, B
# 3 + 2, W 2), which every pair the rays need takes, and face_t (An 3 +
# 3, An * B 1), which only a pair that passes the sign test takes; the
# reciprocal and product of t only for valid pairs, not counted
FLOPS_SIDE = 29
FLOPS_T = 7
# the card's FP32 instruction rate: 67 TFLOP/s counts a fused multiply-add
# as two operations; the kernels are built without contraction
# (--fmad=false), so each operation is one instruction, and a kernel's
# needed operations over this rate are its no-contraction ceiling
PEAK_FP32_INSTR = PEAK_FLOPS / 2
# the [sqrt] check's float32 values
SQRT_VALUES = 1 << 20
KERNEL_SOURCE = 'ptina_tpu_torch/csrc/dense_cast.cu'
PATH_SOURCE = 'ptina_tpu_torch/csrc/fused_path.cu'
BLOCKED_SOURCE = 'ptina_tpu_torch/csrc/blocked_cast.cu'
REPLACES = {'shade': 'ptina_tpu/intersect/pallas_cast.py:69',
            'any': 'ptina_tpu/intersect/pallas_cast.py:62',
            'closest': 'ptina_tpu/intersect/pallas_cast.py:51',
            'any_flat': 'ptina_tpu/intersect/pallas_cast.py:62',
            'path': 'ptina_tpu/engine/fused.py:648',
            'blocked_shade': 'ptina_tpu/intersect/blocked.py:388',
            'blocked_any': 'ptina_tpu/intersect/blocked.py:462'}
# the five megakernel-eligible benchmark scenes (bench.py:224-256):
# name -> (scene function, compared relative to max(|ref|, 0.05)?)
SCENES = {
    'cornell': (lambda: cornell_box(device=DEV), False),
    'cornell_monkey': (lambda: cornell_monkey(device=DEV), False),
    'cornell_textured': (lambda: cornell_box(
        textured_image=bench_texture(), device=DEV), True),
    'envlight': (lambda: envlight_scene(device=DEV), True),
    'matball': (lambda: matball(roughness_tex=bench_texture(),
                                device=DEV), True),
}
WAVEFRONT_SCENES = tuple(SCENES)
# the dense scenes whose tree has inner nodes: the wavefront-ray bound
TREE_SCENES = ('cornell_monkey', 'envlight', 'matball')


def _tree(scene):
    '''The box tree of a blocked scene, as one phrase.'''
    p = scene.node_bounds.shape[0] // 2
    leaves = -(-scene.face_coef.shape[0] // blocked.LEAF_FACES)
    return (f'a box tree of {leaves} leaves of {blocked.LEAF_FACES} faces '
            f'(depth {p.bit_length() - 1})')


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


def _sqrt_values(n):
    '''n float32 values from a seed: a quarter positive normals over every
    exponent, a quarter subnormals, a quarter in [0.01, 100] (where the
    shading and the face tables live), then the special values (0, -0, a
    negative, the infinities, NaN, 1 +- ulp, the largest finite float)
    and standard normals.'''
    rng = np.random.default_rng(13)
    q = n // 4

    def bits(lo, hi):
        return rng.integers(lo, hi, q, dtype=np.int64).astype(
            np.uint32).view(np.float32)
    one, big = np.float32(1.0), np.finfo(np.float32).max
    special = np.array([0.0, -0.0, -1.0, -np.inf, np.inf, np.nan, big, one,
                        np.nextafter(one, np.float32(2.0)),
                        np.nextafter(one, np.float32(0.0))], np.float32)
    rest = rng.standard_normal(n - 3 * q - special.size).astype(np.float32)
    return np.concatenate([bits(0x00800000, 0x7f800000),
                           bits(1, 0x00800000),
                           rng.uniform(0.01, 100.0, q).astype(np.float32),
                           special, rest])


def phase_sqrt(card):
    '''[sqrt]: the lanes where CUDA's torch.sqrt and the port's
    mathutils.sqrt, on the card and on the host, differ from the float64
    root rounded to float32 (numpy's, on the host; a NaN lane agrees with
    any NaN).  Raises unless every count is 0: the kernels' sqrtf, their
    plain twins on the card and the CPU tests all assume IEEE roots.'''
    x = _sqrt_values(SQRT_VALUES)
    with np.errstate(invalid='ignore'):
        want = np.sqrt(x.astype(np.float64)).astype(np.float32)
    xd = torch.from_numpy(x).to(DEV)
    got = {'torch.sqrt on the card': torch.sqrt(xd).cpu().numpy(),
           'mathutils.sqrt on the card': port_sqrt(xd).cpu().numpy(),
           'mathutils.sqrt on the host': port_sqrt(torch.from_numpy(x))
           .numpy()}
    nan = np.isnan(want)
    bad = {k: int(np.where(nan, ~np.isnan(v),
                           v.view(np.int32) != want.view(np.int32)).sum())
           for k, v in got.items()}
    print(f'[sqrt] {card} | {x.size} float32 values, lanes that differ '
          f'from the float64 root rounded to float32: '
          + ', '.join(f'{k} {v}' for k, v in bad.items()))
    if any(bad.values()):
        raise AssertionError(f'square roots not correctly rounded: {bad}')


def phase_build():
    '''The three libraries, one nvcc each, started together.'''
    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as ex:
        jobs = [ex.submit(m.build_library)
                for m in (dense_cast, fused, blocked)]
        logs = [j.result()[1] for j in jobs]
    dt = time.perf_counter() - t0
    print(f'[build] dense_cast.cu + fused_path.cu + blocked_cast.cu -> '
          f'sm_90a, three nvcc in parallel, {dt:.2f} s')
    res = {}
    for log in logs:
        if 'error' in log:
            print(f'[build] {log}')
        res.update(ptxas_by_kernel(log))
    for name, info in res.items():
        print(f'[build] ptxas {name}: {info}')
        m = re.search(r'(\d+) bytes spill stores', info)
        if m and int(m.group(1)):
            print(f'[build] NOTE {name} spills {m.group(1)} bytes to local '
                  f'memory')
    return res


def _print_face_path(card):
    '''The [sass] line of closest_kernel's face loop
    (kernel_report.face_loop_path); returns its instructions a face (None
    where not read).'''
    lib = dense_cast.build_library()[0]
    got = face_loop_path(sass(lib._name, 'closest_kernel'))
    if got is None:
        print('[sass] closest_kernel face loop: not read (no cuobjdump or '
              'no unrolled loop)')
        return None
    n, counts = got
    fp = counts.get('FMUL', 0) + counts.get('FADD', 0)
    print(f'[sass] {card} | closest_kernel, 2 rays a thread: one face\'s '
          f'common path is {n:g} instructions ({n / 2:g} a pair), {fp:g} of '
          f'them FP32: ' + ', '.join(f'{v:g} {k}' for k, v in
                                     sorted(counts.items(),
                                            key=lambda kv: -kv[1])))
    return n


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


def _hold_hits(hk, hp):
    '''A kernel's Hit against its plain version's: (share of rays whose
    hit and index agree, t max abs error, t max relative error, u/v max
    abs error, whether u/v exceed their limit, and the agreeing rays),
    over the rays whose indices agree.'''
    same = (hk.index == hp.index) & (hk.hit == hp.hit)
    hitm = same & hp.hit
    if not hitm.any():
        return same.float().mean().item(), 0.0, 0.0, 0.0, False, same
    t_err = (hk.t - hp.t).abs()[hitm]
    t_rel = (t_err / hp.t.abs()[hitm]).max().item()
    uv_err = torch.maximum((hk.u - hp.u).abs(), (hk.v - hp.v).abs())[hitm]
    uv_lim = UV_ATOL + UV_RTOL * torch.maximum(hp.u.abs(), hp.v.abs())[hitm]
    return (same.float().mean().item(), t_err.max().item(), t_rel,
            uv_err.max().item(), bool((uv_err > uv_lim).any()), same)


def _hold_casts(name, n, shade, occ, closest=None, flat=None):
    '''Hold each cast kernel's result against its plain version's:
    shade = ((Hit, attrs) kernel, (Hit, attrs) plain), occ = (kernel,
    plain) bits, closest = (kernel Hit, plain Hit) or None, flat = the
    flat occlusion kernel's bits or None (against occ's plain bits).
    Prints one line, raises out of tolerance, returns {kernel:
    {'max_abs_err': the largest absolute error of t, u, v and attrs (of
    the occlusion bits for 'any' and 'any_flat'), 't_max_rel': t's
    largest relative error}}.'''
    (hk, ak), (hp, ap) = shade
    agree, t_abs, t_rel, uv_err, uv_bad, same = _hold_hits(hk, hp)
    att_err = (ak - ap).abs()[:, same].max().item() if same.any() else 0.0
    occ_agree = (occ[0] == occ[1]).float().mean().item()
    errs = {'shade': {'max_abs_err': max(t_abs, uv_err, att_err),
                      't_max_rel': t_rel},
            'any': {'max_abs_err': float((occ[0] != occ[1]).any().item())}}
    line = (f'[kernels] {name:<16} N={n:>7} hit={hp.hit.float().mean().item():.3f}'
            f' index agree={agree:.6f} t max rel={t_rel:.2e} uv max '
            f'abs={uv_err:.2e} attrs max abs={att_err:.2e} '
            f'occ={occ[1].float().mean().item():.3f} occ agree={occ_agree:.6f}')
    bad = agree < MIN_AGREE or occ_agree < MIN_AGREE or t_rel > T_RTOL \
        or att_err > ATTR_ATOL or uv_bad
    if closest is not None:
        c_agree, c_abs, c_rel, c_uv, c_bad, _ = _hold_hits(*closest)
        errs['closest'] = {'max_abs_err': max(c_abs, c_uv),
                           't_max_rel': c_rel}
        line += (f'; closest index agree={c_agree:.6f} t max rel='
                 f'{c_rel:.2e} uv max abs={c_uv:.2e}')
        bad = bad or c_agree < MIN_AGREE or c_rel > T_RTOL or c_bad
    if flat is not None:
        f_agree = (flat == occ[1]).float().mean().item()
        errs['any_flat'] = {'max_abs_err': float((flat != occ[1]).any()
                                                 .item())}
        line += f'; any_flat agree={f_agree:.6f}'
        bad = bad or f_agree < MIN_AGREE
    print(line)
    if bad:
        raise AssertionError(f'{name}: kernel and plain disagree beyond '
                             f'tolerance')
    return errs


def _dense_tree(scene):
    '''The dense casts' box tree: (fused_coef, fused_nodes, fused_order).'''
    return scene.fused_coef, scene.fused_nodes, scene.fused_order


def _compare(name, scene, ro, rd, avoid, tmax, flat=True):
    '''The dense casts against their plain versions: the two tree casts
    and, with flat, the two flat ones.'''
    c, at, tree = scene.face_coef, scene.face_attr, _dense_tree(scene)
    shade = (dense_cast.cast_shade(ro, rd, avoid, c, at, *tree),
             dense_cast.cast_shade_plain(ro, rd, avoid, c, at, *tree))
    occ = (dense_cast.cast_any(ro, rd, avoid, tmax, c, *tree),
           dense_cast.cast_any_plain(ro, rd, avoid, tmax, c, *tree))
    closest = any_flat = None
    if flat:
        closest = (dense_cast.cast_closest(ro, rd, avoid, c),
                   dense_cast.cast_closest_plain(ro, rd, avoid, c))
        any_flat = dense_cast.cast_any_flat(ro, rd, avoid, tmax, c)
        _hold_flat_bits(name, ro, rd, avoid, tmax, c, closest[1], occ[1])
    torch.cuda.synchronize()
    return _hold_casts(name, ro.x.shape[0], shade, occ, closest, any_flat)


def _hold_flat_bits(name, ro, rd, avoid, tmax, c, hp, op):
    '''The flat kernels against their plain versions' Hit hp and
    occlusion op: equal bit for bit, or raise.'''
    hk = dense_cast.cast_closest(ro, rd, avoid, c)
    ok = dense_cast.cast_any_flat(ro, rd, avoid, tmax, c)
    torch.cuda.synchronize()
    same = [k for k in ('hit', 'index', 't', 'u', 'v')
            if torch.equal(getattr(hk, k), getattr(hp, k))]
    print(f'[kernels] {name:<16} N={ro.x.shape[0]:>7} closest_kernel / '
          f'any_flat_kernel: bit for bit with the plain versions: Hit '
          f'fields {same}, occlusion {torch.equal(ok, op)}')
    if len(same) != 5 or not torch.equal(ok, op):
        raise AssertionError(f'{name}: a flat kernel differs from its plain '
                             f'version')


def _lanes(scene, dims=DIMS):
    '''The casts of one 512x512 wavefront sample (sample 9): path_trace's
    lanes of the megakernel's twin.'''
    lanes = []
    fused.fused_trace_primary_plain(scene, sobol_block(9, dims), RES, RES,
                                    lanes=lanes)
    return lanes


def _wavefront_batches(lanes):
    '''(label, cast, made, (ro, rd, avoid, tmax)) of every cast batch in
    lanes: each bounce's closest cast ('shade'; avoid the last hit, an
    original face id; tmax 5 for the occlusion kernel) and its shadow
    cast ('any'); made: the paths that make the cast (the rest are
    parked).'''
    out = []
    for b, lane in enumerate(lanes):
        out.append((f'b{b} closest', 'shade', lane['alive'],
                    (lane['ro'], lane['rd'], lane['avoid'],
                     torch.full_like(lane['ro'].x, 5.0))))
        out.append((f'b{b} shadow', 'any', lane['shadow'],
                    (lane['ro_sh'], lane['rd_sh'], lane['hit'].index,
                     lane['tmax'])))
    return out


def _compare_blocked(name, scene, ro, rd, avoid, tmax):
    '''The two blocked casts against their plain versions.'''
    c, at, bb, nb = (scene.face_coef, scene.face_attr, scene.block_bounds,
                     scene.node_bounds)
    shade = (blocked.blocked_cast_shade(ro, rd, avoid, c, at, bb, nb),
             blocked.blocked_cast_shade_plain(ro, rd, avoid, c, at, bb, nb))
    occ = (blocked.blocked_cast_any(ro, rd, avoid, tmax, c, bb, nb),
           blocked.blocked_cast_any_plain(ro, rd, avoid, tmax, c, bb, nb))
    torch.cuda.synchronize()
    errs = _hold_casts(name, ro.x.shape[0], shade, occ)
    return {'blocked_' + k: e for k, e in errs.items()}


def _camera_rays_tmax(rng, scene):
    '''The first bounce's casts on the main path: one pixel-centre camera
    ray per pixel of the 512^2 film, no avoid, and shadow distances
    uniform in [0, 10) (the camera rays hit at t 3.9 to 7.8).'''
    ro, rd, avoid = _camera_batch(scene, RES)
    tmax = torch.as_tensor(rng.uniform(0.0, 10.0, N_FULL), dtype=torch.float32,
                           device=DEV)
    return ro, rd, avoid, tmax


def phase_kernels(tables, highpoly):
    rng = np.random.RandomState(20)
    errs = {}
    print(f'[kernels] tolerances: index and occlusion equal on >= '
          f'{MIN_AGREE:.2%} of rays; where indices agree t rtol {T_RTOL}, '
          f'u/v rtol {UV_RTOL} atol {UV_ATOL}, attrs atol {ATTR_ATOL}')
    runs = [(_compare, name, scene, _rays(rng, scene, n))
            for name, scene in tables.items() for n in (N_FULL, N_RAGGED)]
    # the tree casts on the wavefront's own rays
    for name in WAVEFRONT_SCENES:
        for label, _, _, rays in _wavefront_batches(_lanes(tables[name])):
            runs.append((lambda *a: _compare(*a, flat=False),
                         f'{name} {label}', tables[name], rays))
    runs += [(_compare_blocked, 'cornell_highpoly', highpoly,
              _rays(rng, highpoly, n)) for n in (N_FULL, N_RAGGED)]
    runs.append((_compare_blocked, 'highpoly camera', highpoly,
                 _camera_rays_tmax(rng, highpoly)))
    for compare, name, scene, rays in runs:
        for k, e in compare(name, scene, *rays).items():
            errs[k] = {m: max(errs.get(k, {}).get(m, 0.0), v)
                       for m, v in e.items()}
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
    '''The megakernel against its plain twin on every scene: its three
    heads, and the half-frame composition.  Returns the max abs errors
    (primary and explicit-uniform heads, explicit-ray head).'''
    err = rays_err = 0.0
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
        pt = sobol_block(0, 2 + 6 * DEEP)
        k = _stack(fused.fused_trace_primary(scene, pt, RES, RES))
        p = _stack(fused.fused_trace_primary_plain(scene, pt, RES, RES))
        err = max(err, _hold(name, f'depth {DEEP} s0', k, p, relative))
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
        rays_err = max(rays_err, _hold_rays_head(name, scene, relative))
    torch.cuda.synchronize()
    return err, rays_err


def _primary_inputs(scene, sample, res=RES, dims=DIMS):
    '''The explicit-ray head's inputs that match fused_trace_primary's
    sample: (ro, rd, Sobol point, base), the camera rays with the lens
    jitter of rows 0-1 and base = wanghash2(i, j), as the primary head
    makes them in the kernel (the NDC division by a power-of-two res is
    exact in either form).'''
    pt = sobol_block(sample, dims)
    ii, jj = pixel_grid(res, res, device=DEV)
    u = torch.remainder(pt.to(DEV)[:, None] + pixel_rotation(ii, jj, dims),
                        1.0)
    x = (ii.to(torch.float32) + u[0]) / res * 2.0 - 1.0
    y = (jj.to(torch.float32) + u[1]) / res * 2.0 - 1.0
    ro, rd = camera_rays(scene.cam_v2w, x, y)
    return ro, rd, pt, wanghash2(ii, jj).to(torch.int32)


def _hold_rays_head(name, scene, relative):
    '''fused_trace (the explicit-ray head) at 512^2 against its plain twin
    at the primary head's gate, and bit for bit against
    fused_trace_primary on matched inputs.  Returns the max abs error
    against the twin.'''
    ro, rd, pt, base = _primary_inputs(scene, 0)
    k = _stack(fused.fused_trace(scene, ro, rd, pt, base))
    prim = _stack(fused.fused_trace_primary(scene, pt, RES, RES))
    p = _stack(fused.fused_trace_plain(scene, ro, rd, pt, base))
    err = _hold(name, 'rays head', k, p, relative)
    same = torch.equal(k, prim)
    print(f'[kernels] path_kernel {name:<16} rays head == primary head on '
          f'its camera rays and wanghash2(i, j), bit for bit: {same}')
    if not same:
        raise AssertionError(f'{name}: the explicit-ray head differs from '
                             f'the primary head on matched inputs')
    return err


# ---------------------------------------------------------------- phase 4

_COUNTS = (dense_cast.LAUNCHES, fused.LAUNCHES, blocked.LAUNCHES)


def _zero_counts():
    for d in _COUNTS:
        for k in d:
            d[k] = 0


def _counts():
    return {k: v for d in _COUNTS for k, v in d.items()}


def _expect(**launches):
    '''Every launch count 0 but the given ones.'''
    return {**{k: 0 for k in _counts()}, **launches}


def _render_wavefront(scene, film, start, spp, depth=DEPTH):
    '''render() on the wavefront route: render_sample(fused=False).'''
    _, _, nx, ny = film.shape
    ii, jj = pixel_grid(nx, ny, device=film.device)
    rot = pixel_rotation(ii, jj, 2 + 6 * depth)
    for s in range(spp):
        render_sample(scene, film, start + s, fused=False, max_depth=depth,
                      rot=rot)
    return film


def _check_image(name, film, spp, res=RES):
    img = film_to_image(film)[..., :3]
    if img.shape != (res, res, 3) or not bool(torch.isfinite(img).all()):
        raise AssertionError(f'{name}: image not finite / wrong shape')
    if bool((film[0, 3] != spp).any()):
        raise AssertionError(f'{name}: sample count channel != {spp}')
    return img.mean().item()


def _drive(route, name, run, spp, want, res=RES):
    '''One render of one route with the counts read around it; fails
    unless the launches are exactly `want`.  Returns the launches.'''
    before = _counts()
    film = new_film(res, res, device=DEV)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    film = run(film)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    grew = {k: v - before[k] for k, v in _counts().items()}
    print(f'[main] {route} route {name}: {res}x{res} x {spp} spp in '
          f'{dt:.3f} s (first run), mean '
          f'{_check_image(name, film, spp, res):.5f}, launches {grew}')
    if grew != want:
        raise AssertionError(f'{name}: launches {grew}, expected {want}')
    return grew


def _camera_batch(scene, res):
    '''One pixel-centre camera ray per pixel of a res^2 film, no avoid.'''
    ii, jj = pixel_grid(res, res, device=DEV)
    x = (ii.to(torch.float32) + 0.5) / res * 2.0 - 1.0
    y = (jj.to(torch.float32) + 0.5) / res * 2.0 - 1.0
    ro, rd = camera_rays(scene.cam_v2w, x, y)
    return ro, rd, torch.full((res * res,), -1, dtype=torch.int32,
                              device=DEV)


def phase_main(scenes, highpoly):
    '''Each route of the main path, with every count at 0 just before it
    and read just after.  Returns {route: counts after it}.'''
    out = {}
    _zero_counts()
    for name, scene in scenes.items():
        _drive('megakernel', name, lambda f, sc=scene: render(sc, f, 0,
                                                              spp=SPP),
               SPP, _expect(path=SPP))
    out['megakernel'] = _counts()
    _zero_counts()
    for name in WAVEFRONT_SCENES:
        _drive('wavefront', name,
               lambda f, sc=scenes[name]: _render_wavefront(sc, f, 0, SPP),
               SPP, _expect(shade=DEPTH * SPP, any=DEPTH * SPP))
    out['wavefront'] = _counts()
    # a depth above the first slices' cap through each dense route
    monkey = scenes['cornell_monkey']
    _zero_counts()
    _drive(f'megakernel depth {DEEP}', 'cornell_monkey',
           lambda f: render(monkey, f, 0, spp=DEEP_SPP, max_depth=DEEP),
           DEEP_SPP, _expect(path=DEEP_SPP))
    _zero_counts()
    _drive(f'wavefront depth {DEEP}', 'cornell_monkey',
           lambda f: _render_wavefront(monkey, f, 0, DEEP_SPP, DEEP),
           DEEP_SPP, _expect(shade=DEEP * DEEP_SPP, any=DEEP * DEEP_SPP))
    _zero_counts()
    n = DEPTH * HIGHPOLY_SPP
    _drive('blocked wavefront', 'cornell_highpoly',
           lambda f: render(highpoly, f, 0, spp=HIGHPOLY_SPP), HIGHPOLY_SPP,
           _expect(blocked_shade=n, blocked_any=n))
    out['blocked'] = _counts()
    # the table-level entry points on cornell_monkey's faces, packed per
    # call as in the reference
    ro, rd, avoid = _camera_batch(monkey, RES)
    _zero_counts()
    hit = intersect.cast_closest(ro, rd, monkey.tri_w2b, avoid)
    occ = intersect.cast_any(ro, rd, monkey.tri_w2b, avoid,
                             torch.full_like(ro.x, 3.0))
    torch.cuda.synchronize()
    grew = _counts()
    share = hit.hit.float().mean().item()
    ok = bool(torch.isfinite(hit.t).all()) and share > 0.9 \
        and bool(((hit.index >= 0) == hit.hit).all())
    print(f'[main] table-level cast_closest / cast_any, cornell_monkey '
          f'faces, {RES}x{RES} camera rays: hit {share:.4f}, occluded '
          f'before t=3 {occ.float().mean().item():.4f}, launches {grew}')
    if not ok or grew != _expect(closest=1, any_flat=1):
        raise AssertionError(f'table-level casts: hit share {share}, '
                             f'launches {grew}')
    out['table'] = grew
    out['rays_head'] = _drive_rays_head(scenes)
    out['blocked_closest'] = _drive_blocked_closest(highpoly)
    return out


def _drive_rays_head(scenes):
    '''fused_trace, the explicit-ray head, once on each scene's 512^2
    camera rays of sample 1: one path launch a call and nothing else.'''
    inputs = {name: _primary_inputs(scene, 1)
              for name, scene in scenes.items()}
    _zero_counts()
    rads = {name: fused.fused_trace(scenes[name], *args)
            for name, args in inputs.items()}
    torch.cuda.synchronize()
    grew = _counts()
    means = {name: round(_stack(r).mean().item(), 6)
             for name, r in rads.items()}
    ok = all(bool(torch.isfinite(_stack(r)).all()) for r in rads.values())
    print(f'[main] explicit-ray head fused_trace, {RES}x{RES} camera rays '
          f'and wanghash2(i, j), sample 1: mean radiance {means}, launches '
          f'{grew}')
    if not ok or grew != _expect(path=len(scenes)):
        raise AssertionError(f'fused_trace: finite {ok}, launches {grew}')
    return grew


def _drive_blocked_closest(highpoly):
    '''blocked_cast_closest on cornell_highpoly's 512^2 camera rays: one
    blocked_shade launch and nothing else, and the shade pass's hit bit
    for bit.'''
    ro, rd, avoid = _camera_batch(highpoly, RES)
    tables = (highpoly.face_coef, highpoly.face_attr, highpoly.block_bounds,
              highpoly.node_bounds)
    _zero_counts()
    hit = blocked.blocked_cast_closest(ro, rd, avoid, *tables)
    torch.cuda.synchronize()
    grew = _counts()
    ref, _ = blocked.blocked_cast_shade(ro, rd, avoid, *tables)
    torch.cuda.synchronize()
    same = [k for k in ('hit', 'index', 't', 'u', 'v')
            if torch.equal(getattr(hit, k), getattr(ref, k))]
    share = hit.hit.float().mean().item()
    print(f'[main] blocked_cast_closest, cornell_highpoly, {RES}x{RES} '
          f'camera rays: hit {share:.4f}, launches {grew}; equal to '
          f'blocked_cast_shade\'s hit bit for bit in {same}')
    if len(same) != 5 or share < 0.9 \
            or grew != _expect(blocked_shade=1):
        raise AssertionError(f'blocked_cast_closest: fields equal {same}, '
                             f'hit {share}, launches {grew}')
    return grew


# ---------------------------------------------------------------- phase 5

def phase_capacity():
    '''The reference benchmark's capacity check (bench.py:173-216): a
    ~306k-face scene, its float64 oracle and a small render.'''
    t0 = time.perf_counter()
    scene = cornell_highpoly(nu=640, nv=240, device=DEV)
    f, nb = scene.face_coef.shape[0], scene.block_bounds.shape[0]
    print(f'[capacity] cornell_highpoly(nu=640, nv=240): {int(scene.nfaces)} '
          f'faces, {f} padded, {nb} blocks, {_tree(scene)}, built in '
          f'{time.perf_counter() - t0:.2f} s')
    agree = oracle_agreement(scene)
    print(f'[capacity] 32 rays against the float64 oracle: {agree}/32 agree '
          f'(t within 2e-3 relative; >= 31)')
    if agree < 31:
        raise AssertionError(f'capacity oracle: {agree}/32')
    _zero_counts()
    n = DEPTH * CAPACITY_SPP
    _drive('blocked wavefront', 'cornell_highpoly 640x240',
           lambda fl: render(scene, fl, 0, spp=CAPACITY_SPP), CAPACITY_SPP,
           _expect(blocked_shade=n, blocked_any=n), res=CAPACITY_RES)

# ---------------------------------------------------------------- phase 6

def _blur(img, k=2):
    h, w, c = img.shape
    return img.reshape(h // (2 * k), 2 * k, w // (2 * k), 2 * k, c) \
              .mean(axis=(1, 3))


def phase_golden(scenes):
    '''The stored goldens through every route that can render them: the
    megakernel and the dense wavefront, and for cornell_monkey the blocked
    casts (the scene rebuilt with accel='blocked': Morton order, 2 blocks;
    the only stored image the blocked route can be held to).'''
    # tests/test_parity.py: (spp, mean tolerance, patch tolerance)
    cases = {'cornell': (64, 0.015, 0.05), 'cornell_monkey': (96, 0.015, 0.06)}
    dense = lambda sc, f, n: _render_wavefront(sc, f, 0, n)
    auto = lambda sc, f, n: render(sc, f, 0, spp=n)
    monkey_blocked = cornell_monkey(device=DEV, accel='blocked')
    # (scene, route, run, the launch count the route must raise)
    runs = [(name, route, run, key) for name in cases
            for route, run, key in (('megakernel', auto, 'path'),
                                    ('wavefront', dense, 'shade'))]
    runs.append(('cornell_monkey', 'blocked wavefront', auto,
                  'blocked_shade'))
    for name, route, run, key in runs:
        spp, mean_tol, patch_tol = cases[name]
        with open(os.path.join(ROOT, 'tests', 'golden',
                               f'{name}_64x64_512spp.txt')) as fh:
            gold = decode_numpy_array(fh.read())
        scene = monkey_blocked if route == 'blocked wavefront' \
            else scenes[name]
        before = _counts()
        film = run(scene, new_film(64, 64, device=DEV), spp)
        grew = {k for k, v in _counts().items() if v > before[k]}
        if key not in grew or grew & {'path', 'shade', 'blocked_shade'} \
                != {key}:
            raise AssertionError(f'{name}: {route} took the wrong route '
                                 f'({sorted(grew)})')
        img = film_to_image(film)[..., :3].cpu().numpy()
        mean_err = abs(img.mean() - gold.mean()) / gold.mean()
        patch = (np.abs(_blur(img) - _blur(gold))
                 / (_blur(gold) + 0.05)).mean()
        print(f'[golden] {name} 64x64 {spp} spp, {route}: mean err '
              f'{mean_err:.5f} (< {mean_tol}), patch err {patch:.5f} '
              f'(< {patch_tol})')
        if not (mean_err < mean_tol and patch < patch_tol):
            raise AssertionError(f'{name} ({route}): golden mismatch')


# ---------------------------------------------------------------- phase 7

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


def _profile(work, complete, tries=3):
    '''key_averages() of a CUDA-only profiler trace of work().  The trace
    can come back short or empty (PERF.md; a full run once read 0 ms of
    device time for ten dense cast launches), so it is taken again, up to
    `tries` times, until complete(key_averages) holds; the last one is
    returned either way.'''
    from torch.profiler import profile, ProfilerActivity
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            work()
            torch.cuda.synchronize()
        ka = prof.key_averages()
        if complete(ka):
            break
    return ka


def _device_ms(fn, reps=10):
    """Device time per call: `reps` calls queued behind a spinning stream
    and timed with CUDA events (_queued_us).  For the casts and their
    plain versions, which never synchronise and keep the device busier
    than the host, so no host gap enters the window."""
    return _queued_us(lambda: [fn() for _ in range(reps)]) / 1e3 / reps


def _profiled_ms(fn, reps=3):
    """Device time per call from the profiler: the summed device time of
    every kernel `reps` calls launched, host gaps excluded.  For host-bound
    work (the megakernel's wavefront twin), which _device_ms would time
    with its gaps; and that is the fallback, printed as such, when every
    trace comes back empty."""
    fn()
    ka = _profile(lambda: [fn() for _ in range(reps)],
                  lambda k: sum(_dev_us(e) for e in k) > 0)
    us = sum(_dev_us(e) for e in ka)
    if us > 0:
        return us / 1e3 / reps
    print('[timing] NOTE the profiler trace came back empty 3 times; '
          'timed with CUDA events instead (host gaps included)')
    return _device_ms(fn, reps)


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


def _time_calls(calls, plain_reps=10):
    """{kernel: (device ms, plain device ms, call ms, plain call ms)} for
    calls = {kernel: (kernel call, plain call)}; the per-call timings run
    plain, kernel, kernel, plain.  plain_reps bounds the plain version's
    repetitions (the blocked plain casts take seconds a call)."""
    out = {}
    pw = min(3, plain_reps)
    for k, (kern, plain) in calls.items():
        p1, k1, k2, p2 = (_event_ms(plain, plain_reps, pw), _event_ms(kern),
                          _event_ms(kern), _event_ms(plain, plain_reps, pw))
        out[k] = (_device_ms(kern), _device_ms(plain, plain_reps),
                  statistics.median([k1, k2]), statistics.median([p1, p2]))
    return out


def _kernel_times(scene, rays, flat):
    """The dense casts' times at these rays: the two tree casts and, with
    flat, the two flat ones (_time_calls; plain versions 3 calls)."""
    ro, rd, avoid, tmax = rays
    c, at, tree = scene.face_coef, scene.face_attr, _dense_tree(scene)
    calls = {
        'shade': (lambda: dense_cast.cast_shade(ro, rd, avoid, c, at, *tree),
                  lambda: dense_cast.cast_shade_plain(ro, rd, avoid, c, at,
                                                      *tree)),
        'any': (lambda: dense_cast.cast_any(ro, rd, avoid, tmax, c, *tree),
                lambda: dense_cast.cast_any_plain(ro, rd, avoid, tmax, c,
                                                  *tree))}
    if flat:
        calls['closest'] = (
            lambda: dense_cast.cast_closest(ro, rd, avoid, c),
            lambda: dense_cast.cast_closest_plain(ro, rd, avoid, c))
        calls['any_flat'] = (
            lambda: dense_cast.cast_any_flat(ro, rd, avoid, tmax, c),
            lambda: dense_cast.cast_any_plain(ro, rd, avoid, tmax, c))
    return _time_calls(calls, plain_reps=3)


def _blocked_times(scene, rays):
    ro, rd, avoid, tmax = rays
    tables = (scene.face_coef, scene.face_attr, scene.block_bounds,
              scene.node_bounds)
    c, _, bb, nb = tables
    return _time_calls({
        'blocked_shade': (
            lambda: blocked.blocked_cast_shade(ro, rd, avoid, *tables),
            lambda: blocked.blocked_cast_shade_plain(ro, rd, avoid,
                                                     *tables)),
        'blocked_any': (
            lambda: blocked.blocked_cast_any(ro, rd, avoid, tmax, c, bb, nb),
            lambda: blocked.blocked_cast_any_plain(ro, rd, avoid, tmax, c,
                                                   bb, nb)),
    }, plain_reps=1)


def _bound(flops, nbytes):
    '''(bound ms, 'operations' or 'bytes'): the larger of the FP32
    operations over the FP32 peak and the bytes over the memory rate.'''
    ops_ms, bytes_ms = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (ops_ms, 'operations') if ops_ms >= bytes_ms \
        else (bytes_ms, 'bytes')


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def _flat_pairs(scene, rays):
    """The pair work the flat casts need on these rays, counted with the
    plain version's arithmetic (plucker.pair_side, pair_hits): {kernel:
    (pairs, of them passing the sign test)}.  The closest cast needs every
    ray against every live face; the occlusion cast a ray's faces in table
    order up to its first occluder (a face other than avoid hit at t <
    min(tmax, INF)), every face where it has none, and none where tmax <=
    0 (t > 0 on every valid pair)."""
    ro, rd, avoid, tmax = rays
    n, nf = ro.x.shape[0], int(scene.nfaces)
    coef = scene.face_coef[:nf]
    p = ray_features(ro, rd)
    fc = face_chunk(n, nf)
    first = torch.full((n,), nf, dtype=torch.int64, device=DEV)
    passing = 0
    for base in range(0, nf, fc):
        c = coef[base:base + fc]
        passing += int((pair_side(p, rd, c)[0] >= 0).sum())
        valid, ts, _ = pair_hits(p, ro, rd, c, base, avoid)
        occ = valid & (ts < INF) & (ts < tmax[:, None])
        at = base + occ.int().argmax(1).long()
        first = torch.where(occ.any(1) & (at < first), at, first)
    need = torch.where(tmax > 0, torch.clamp(first + 1, max=nf), 0)
    any_passing = 0
    for base in range(0, nf, fc):
        c = coef[base:base + fc]
        fids = base + torch.arange(c.shape[0], device=DEV)
        any_passing += int(((pair_side(p, rd, c)[0] >= 0)
                            & (fids[None, :] < need[:, None])).sum())
    return {'closest': (n * nf, passing),
            'any_flat': (int(need.sum()), any_passing)}


def _work(total, passing):
    """FP32 operations of `total` needed pairs, `passing` of them past the
    sign test."""
    return FLOPS_SIDE * total + FLOPS_T * passing


def _ceiling(ops):
    """The no-contraction ceiling of `ops` FP32 operations, ms."""
    return ops / PEAK_FP32_INSTR * 1e3


def _flat_bounds(scene, rays):
    """{flat dense kernel: (bound ms, bound_by), 'ceiling': {flat dense
    kernel: ms}, 'pairs': _flat_pairs} at these rays: the needed pairs'
    FP32 operations (_work), each input read once, each output written
    once; the ceiling is the same operations as instructions
    (_ceiling).  Also the tree casts' all-faces bounds, kept for the
    record (every face for every ray, the closest cast's pairs):
    {'shade': ms, 'any': ms}."""
    ro, rd, avoid, tmax = rays
    n, nf = ro.x.shape[0], int(scene.nfaces)
    pairs = _flat_pairs(scene, rays)
    ops = {k: _work(*v) for k, v in pairs.items()}
    rays_b = _nbytes(ro.x, ro.y, ro.z, rd.x, rd.y, rd.z, avoid)
    coef_b = 64 * nf
    hit_b = n * (4 + 4 + 1 + 4 + 4)  # t, index, hit, u, v
    flat = {'closest': _bound(ops['closest'], rays_b + coef_b + hit_b),
            'any_flat': _bound(ops['any_flat'],
                               rays_b + _nbytes(tmax) + coef_b + n),
            'ceiling': {k: _ceiling(v) for k, v in ops.items()},
            'pairs': pairs}
    flops = ops['closest']
    all_faces = {'shade': _bound(flops, rays_b + coef_b + 72 * nf + hit_b
                                 + 24 * n)[0],
                 'any': _bound(flops, rays_b + _nbytes(tmax) + coef_b
                               + n)[0]}
    return flat, all_faces


def _rows_dot(c, rows):
    '''plucker._dot_rows on gathered pairs: sum_k rows[k] x c[..., k],
    left to right, rows [M, 1] and c [M, L, K] -> [M, L].'''
    acc = rows[0] * c[..., 0]
    for k in range(1, len(rows)):
        acc = acc + rows[k] * c[..., k]
    return acc


def _leaf_work(ro, rd, nf, ray, leaf, coef):
    '''For (ray, leaf) entries ([M] each): ([M] live faces of the leaf,
    [M] of them whose pair with the ray passes the sign test, or None
    without coef).  coef holds the faces in the tree's slot order (leaf
    l's are rows LEAF_FACES * l onward, live below nf); the sign test is
    plucker.pair_side's arithmetic on the gathered pairs.'''
    lf = blocked.LEAF_FACES
    live = torch.clamp(nf - lf * leaf.long(), 0, lf)
    if coef is None:
        return live, None
    feats = ray_features(ro, rd)
    dirs = (rd.x, rd.y, rd.z)
    passing = torch.zeros_like(live)
    step = 1 << 15
    for s in range(0, ray.numel(), step):
        r, sl = ray[s:s + step], slice(s, s + step)
        slot = leaf[sl, None].long() * lf + torch.arange(lf, device=DEV)
        c = coef[torch.clamp_max(slot, coef.shape[0] - 1)]  # [m, lf, 16]
        p = [f[r][:, None] for f in feats]
        u = _rows_dot(c[..., 0:6], p)
        v = _rows_dot(c[..., 6:12], p)
        b = _rows_dot(c[..., 12:15], [d[r][:, None] for d in dirs])
        w = b - u - v
        bi = b.view(torch.int32)
        side = ((u.view(torch.int32) ^ bi) | (v.view(torch.int32) ^ bi)
                | (w.view(torch.int32) ^ bi))
        passing[sl] = ((side >= 0) & (slot < nf)).sum(1)
    return live, passing


def _tree_work(ro, rd, nodes, nf, t_stop, inclusive, coef=None):
    '''blocked.leaf_pairs, and with coef (the faces in the tree's slot
    order) also how many of those pairs pass the sign test: ([N] pairs,
    [N] passing or None).'''
    if coef is None:
        return blocked.leaf_pairs(ro, rd, nodes, nf, t_stop, inclusive), None
    p = nodes.shape[0] // 2
    n = ro.x.shape[0]
    pairs = torch.zeros(n, dtype=torch.int64, device=DEV)
    passing = torch.zeros_like(pairs)
    step = max(1, (1 << 22) // p)
    for s in range(0, n, step):
        sl = slice(s, s + step)
        e = blocked.box_entries(V3(ro.x[sl], ro.y[sl], ro.z[sl]),
                                V3(rd.x[sl], rd.y[sl], rd.z[sl]), nodes[p:])
        ts = t_stop[sl, None]
        enters = torch.isfinite(e) & ((e <= ts) if inclusive else (e < ts))
        ray, leaf = enters.nonzero(as_tuple=True)
        ray = ray + s
        live, ok = _leaf_work(ro, rd, nf, ray, leaf, coef)
        pairs.index_add_(0, ray, live)
        passing.index_add_(0, ray, ok)
    return pairs, passing


def _cast_work(ro, rd, ro_sh, rd_sh, hit, occ, occluder, tmax, nodes, nf,
               slot, coef=None):
    '''The pairs two casts need on a box tree, ((closest pairs, passing),
    (shadow pairs, passing)), [N] each (passing None without coef): the
    closest cast the live faces of every leaf the ray enters at or before
    its hit; the shadow ray, where occ, its nearest occluder's leaf (slot:
    each face id's slot in the tree), else every leaf it enters before
    min(tmax, INF).'''
    inf = torch.full_like(hit.t, float('inf'))
    closest = _tree_work(ro, rd, nodes, nf, torch.where(hit.hit, hit.t, inf),
                         True, coef)
    leaf = slot[torch.clamp_min(occluder, 0).long()] // blocked.LEAF_FACES
    n = ro_sh.x.shape[0]
    own = _leaf_work(ro_sh, rd_sh, nf, torch.arange(n, device=DEV), leaf,
                     coef)
    clear = _tree_work(ro_sh, rd_sh, nodes, nf, torch.clamp_max(tmax, 1e6),
                       False, coef)
    shadow = tuple(None if b is None else torch.where(occ, a, b)
                   for a, b in zip(own, clear))
    return closest, shadow


def _tree_pairs(scene, ro, rd, avoid, tmax):
    """The pair tests the dense tree casts need on these rays, over
    fused_nodes (_cast_work with the shade kernel's hit as the nearest
    occluder): ((closest pairs, passing), (shadow pairs, passing)), [N]
    int64 each."""
    hit, _ = dense_cast.cast_shade(ro, rd, avoid, scene.face_coef,
                                   scene.face_attr, *_dense_tree(scene))
    slot = torch.argsort(scene.fused_order.long())  # of each face id
    return _cast_work(ro, rd, ro, rd, hit, hit.hit & (hit.t < tmax),
                      hit.index, tmax, scene.fused_nodes, int(scene.nfaces),
                      slot, scene.fused_coef)


def _visits_line(vis):
    """(inner nodes, leaves, a warp's slowest leaves) means of [N, 2]
    walk counters, warps of 32 consecutive rays."""
    v = vis.float()
    n = v.shape[0] // 32 * 32
    return (v[:, 0].mean().item(), v[:, 1].mean().item(),
            v[:n, 1].reshape(-1, 32).amax(1).mean().item())


def _bound_line(card, what, n, total, passing, b, ceil, tail=''):
    print(f'[bound] {card} | {what}: needs {total / n:.2f} pairs a ray '
          f'({total} in all, {passing} of them pass the sign test) -> '
          f'{b[0]:.5f} ms by {b[1]}, no-contraction ceiling {ceil:.5f} ms'
          f'{tail}')


def _dense_bounds(card, name, scene, rays, lanes, all_faces):
    """The tree casts' bounds at the timed rays: ({tree cast: (bound ms,
    bound_by)}, {cast: ceiling ms}, {cast: (pairs, passing)}, {cast:
    visits line}), from the pairs they need (_tree_pairs), the bytes each
    input read once and each output written once; printed beside the
    all-faces bound (all_faces, from _flat_bounds), the tree nodes and
    leaves the kernels visit (dense_cast_visits), and, given the
    wavefront's lanes, the pairs and visits of its own casts."""
    ro, rd, avoid, tmax = rays
    n, nf = ro.x.shape[0], int(scene.nfaces)
    c, at, tree = scene.face_coef, scene.face_attr, _dense_tree(scene)
    closest, shadow = _tree_pairs(scene, ro, rd, avoid, tmax)
    vis = dense_cast.dense_cast_visits(ro, rd, avoid, tmax, c, at, *tree)
    rays_b = _nbytes(ro.x, ro.y, ro.z, rd.x, rd.y, rd.z, avoid)
    tree_b = _nbytes(*tree)
    out, ceil, pairs, visits = {}, {}, {}, {}
    for k, work, nbytes, v in (
            ('shade', closest, rays_b + 136 * nf + tree_b + n * (17 + 24),
             vis[0]),
            ('any', shadow, rays_b + _nbytes(tmax) + tree_b + n, vis[1])):
        pairs[k] = tuple(int(x.sum()) for x in work)
        ops = _work(*pairs[k])
        out[k], ceil[k] = _bound(ops, nbytes), _ceiling(ops)
        visits[k] = _visits_line(v)
        _bound_line(card, f'{k}_kernel {name} {n} random rays', n,
                    *pairs[k], out[k], ceil[k],
                    f' [all {nf} faces: {all_faces[k]:.5f} ms]')
        print(f'[visits] {card} | {k}_kernel {name} {n} random rays: '
              f'{visits[k][0]:.2f} inner nodes, {visits[k][1]:.3f} leaves '
              f'({blocked.LEAF_FACES * visits[k][1]:.1f} face slots) a '
              f'ray, a warp\'s slowest ray {visits[k][2]:.2f} leaves')
    if lanes is None:
        return out, ceil, pairs, visits
    casts = {'shade': [0, 0, 0, 0.0, 0.0], 'any': [0, 0, 0, 0.0, 0.0]}
    for _, k, made, wrays in _wavefront_batches(lanes):
        work = _tree_pairs(scene, *wrays)[k != 'shade']
        v = dense_cast.dense_cast_visits(*wrays, c, at, *tree)[k != 'shade']
        v = v.float()
        casts[k][0] += int(made.sum())
        casts[k][1] += int(work[0][made].sum())
        casts[k][2] += int(work[1][made].sum())
        casts[k][3] += v[made, 0].sum().item()
        casts[k][4] += v[made, 1].sum().item()
    for k, (m, total, passing, inner, leaves) in casts.items():
        print(f'[bound] {card} | {k}_kernel {name} wavefront {RES}x{RES} '
              f'sample 9, {m} casts in {DEPTH} bounces: needs '
              f'{total / m:.2f} pairs a cast ({passing / m:.3f} passing '
              f'the sign test) [all {nf} faces]; the kernel visits '
              f'{inner / m:.2f} inner nodes and {leaves / m:.3f} leaves a '
              f'cast ({blocked.LEAF_FACES * leaves / m:.1f} face slots)')
    return out, ceil, pairs, visits


def _blocked_bounds(card, scene, rays):
    '''{blocked kernel: (bound ms, bound_by), 'ceiling': {kernel: ms},
    'pairs': {kernel: (pairs, passing)}} at these rays, from the pairs
    they need on the scene's tree (_cast_work with the shade kernel's
    hit as the nearest occluder; the faces are in tree order already).
    Prints them beside the tree nodes and leaves the kernels visit (their
    own counters).'''
    ro, rd, avoid, tmax = rays
    tables = (scene.face_coef, scene.face_attr, scene.block_bounds,
              scene.node_bounds)
    c, at, bb, nb = tables
    nf, n = int(scene.nfaces), ro.x.shape[0]
    hit, _ = blocked.blocked_cast_shade(ro, rd, avoid, *tables)
    occ = blocked.blocked_cast_any(ro, rd, avoid, tmax, c, bb, nb)
    slot = torch.arange(c.shape[0], device=DEV)
    shade, any_ = _cast_work(ro, rd, ro, rd, hit, occ, hit.index, tmax, nb,
                             nf, slot, c)
    vis = blocked.blocked_cast_visits(ro, rd, avoid, tmax, *tables)
    rays_b = _nbytes(ro.x, ro.y, ro.z, rd.x, rd.y, rd.z, avoid)
    tree_b = _nbytes(nb)
    out = {'ceiling': {}, 'pairs': {}}
    for k, work, nbytes, v in (
            ('blocked_shade', shade,
             rays_b + 136 * nf + tree_b + n * (17 + 24), vis[0]),
            ('blocked_any', any_,
             rays_b + _nbytes(tmax) + 64 * nf + tree_b + n, vis[1])):
        out['pairs'][k] = tuple(int(x.sum()) for x in work)
        ops = _work(*out['pairs'][k])
        out[k], out['ceiling'][k] = _bound(ops, nbytes), _ceiling(ops)
        v = v.float().mean(0)
        _bound_line(card, f'{k:<13} cornell_highpoly {n} rays', n,
                    *out['pairs'][k], out[k], out['ceiling'][k],
                    f'; the kernel visits {v[0].item():.2f} inner nodes '
                    f'and {v[1].item():.3f} leaves a ray '
                    f'({blocked.LEAF_FACES * v[1].item():.1f} face slots)')
    return out


def _occluders(scene, lanes):
    '''Per bounce, the nearest face each shadow ray meets (its path's hit
    face excluded), from the closest cast's plain version.'''
    return [dense_cast.cast_closest_plain(lane['ro_sh'], lane['rd_sh'],
                                          lane['hit'].index,
                                          scene.face_coef).index
            for lane in lanes]


def _needed_pairs(scene, lanes, occluders, nodes, order, side=False):
    '''The pair tests the megakernel's casts need on a box tree (nodes,
    over the faces in `order`, a numpy permutation), per bounce on the
    twin's rays (path_trace's lanes), by _cast_work: [((closest pairs,
    passing), (shadow pairs, passing))] totals over the live lanes; the
    passing counts (the sign test) only with side, else None.'''
    nf = int(scene.nfaces)
    coef = scene.face_coef[torch.as_tensor(order, device=DEV)] \
        if side else None
    slot = torch.as_tensor(np.argsort(order), device=DEV)  # of each face id
    out = []
    for lane, occluder in zip(lanes, occluders):
        closest, shadow = _cast_work(
            lane['ro'], lane['rd'], lane['ro_sh'], lane['rd_sh'],
            lane['hit'], lane['occ'], occluder, lane['tmax'], nodes, nf,
            slot, coef)
        out.append(tuple(
            tuple(None if x is None else int(x[live].sum()) for x in work)
            for work, live in ((closest, lane['alive']),
                               (shadow, lane['shadow']))))
    return out


def _all_faces_passing(scene, lanes):
    '''Of every live face against every cast of these lanes (the closest
    casts of the live paths and the shadow rays), the pairs that pass the
    sign test (plucker.pair_side).'''
    nf = int(scene.nfaces)
    coef = scene.face_coef[:nf]
    passing = 0
    for lane in lanes:
        for ro, rd, live in ((lane['ro'], lane['rd'], lane['alive']),
                             (lane['ro_sh'], lane['rd_sh'], lane['shadow'])):
            p, fc = ray_features(ro, rd), face_chunk(ro.x.shape[0], nf)
            for base in range(0, nf, fc):
                side = pair_side(p, rd, coef[base:base + fc])[0]
                passing += int(((side >= 0) & live[:, None]).sum())
    return passing


def _path_bound(card, name, scene):
    '''((bound ms, bound_by), all-faces bound ms, ceiling ms, (pairs,
    passing)) of the megakernel's sample 9 at 512^2.  The bound counts
    the pairs these paths need on the scene's tree (_needed_pairs, the
    twin's rays on the same uniforms) and the bytes of the face, tree
    and texture tables and the radiance rows; the all-faces bound, kept
    for the record, every live face for every cast.  Prints both, beside
    the pairs the same rays would need on trees over index order and
    plain Morton order.'''
    lanes = []
    fused.fused_trace_primary_plain(scene, sobol_block(9, DIMS), RES, RES,
                                    lanes=lanes)
    alive = [int(lane['alive'].sum()) for lane in lanes]
    shadow = [int(lane['shadow'].sum()) for lane in lanes]
    nf, f = int(scene.nfaces), scene.face_coef.shape[0]
    occluders = _occluders(scene, lanes)
    needed = _needed_pairs(scene, lanes, occluders, scene.fused_nodes,
                           scene.fused_order.cpu().numpy(), side=True)
    pairs = sum(c[0] + s[0] for c, s in needed)
    passing = sum(c[1] + s[1] for c, s in needed)
    ops = _work(pairs, passing)
    tree_b = _nbytes(scene.fused_nodes, scene.fused_order) + 64 * nf
    b = _bound(ops, 136 * nf + tree_b + _nbytes(scene.textures.data)
               + 12 * N_FULL)
    casts = sum(alive) + sum(shadow)
    all_faces = _bound(_work(nf * casts, _all_faces_passing(scene, lanes)),
                       136 * nf + _nbytes(scene.textures.data)
                       + 12 * N_FULL)[0]
    print(f'[bound] {card} | path_kernel {name} {RES}x{RES}: paths per '
          f'bounce {alive}, shadow rays {shadow}; needs {pairs} pairs, '
          f'{passing} of them pass the sign test ({pairs / casts:.2f} a '
          f'cast; per bounce (closest pairs, passing) / (shadow pairs, '
          f'passing) {needed}) -> {b[0]:.5f} ms by {b[1]}, no-contraction '
          f'ceiling {_ceiling(ops):.5f} ms [all {nf} faces every cast: '
          f'{all_faces:.5f} ms]')
    pos = scene.tri_pos.cpu().numpy()
    pad = np.arange(nf, f)
    closest_n = sum(c[0] for c, _ in needed)
    shadow_n = sum(s[0] for _, s in needed)
    for order_name, order in (
            ('index', np.arange(f)),
            ('Morton', np.concatenate([morton_face_order(pos[:nf]), pad]))):
        nodes = torch.as_tensor(compute_node_bounds(pos[order], nf),
                                device=DEV)
        other = _needed_pairs(scene, lanes, occluders, nodes, order)
        oc, os_ = sum(c[0] for c, _ in other), sum(s[0] for _, s in other)
        print(f'[bound] {card} | path_kernel {name}: the same rays on a '
              f'tree over {order_name} order need {(oc + os_) / casts:.2f}'
              f' pairs a cast (closest {oc / sum(alive):.2f}, shadow '
              f'{os_ / max(sum(shadow), 1):.2f}; the scene\'s order: '
              f'closest {closest_n / sum(alive):.2f}, shadow '
              f'{shadow_n / max(sum(shadow), 1):.2f})')
    return b, all_faces, _ceiling(ops), (pairs, passing)


def _path_visits(card, name, scene):
    '''The megakernel's own tree-walk counters at 512^2, sample 9
    (fused_trace_visits): inner nodes and leaves per closest and per
    shadow cast, and the leaves of the slowest ray of each warp of 32
    paths.  Returns {cast: (inner, leaves, warp's slowest leaves)}.'''
    _, vis = fused.fused_trace_visits(scene, sobol_block(9, DIMS), RES, RES)
    out = {}
    for c, cast in enumerate(('closest', 'shadow')):
        v = vis[:, :, c]  # [N, depth, 2]
        made = v[..., 0] >= 0
        slowest = v[..., 1].reshape(-1, 32, DEPTH).amax(1)  # [warps, depth]
        warp_made = made.reshape(-1, 32, DEPTH).any(1)
        out[cast] = (v[..., 0][made].float().mean().item(),
                     v[..., 1][made].float().mean().item(),
                     slowest[warp_made].float().mean().item())
    print(f'[visits] {card} | path_kernel {name} {RES}x{RES}: per closest '
          f'cast {out["closest"][0]:.2f} inner nodes, {out["closest"][1]:.3f}'
          f' leaves ({blocked.LEAF_FACES * out["closest"][1]:.1f} face '
          f'slots), a warp\'s slowest ray {out["closest"][2]:.2f} leaves; '
          f'per shadow cast {out["shadow"][0]:.2f} inner nodes, '
          f'{out["shadow"][1]:.3f} leaves, a warp\'s slowest '
          f'{out["shadow"][2]:.2f}')
    return out


def _profile_share(scene, use_fused, names=None):
    '''On one route (render_sample's fused flag), over two 512^2 samples:
    the device time of the route's kernels as a share of all device time
    (profiler, CUDA activity only), with the route launches the trace
    holds against the launches made; the device time of the two samples
    over their wall time without the profiler (median of 3 windows), the
    busy share, where the device time is the profiler's on the wavefront
    (hundreds of launches, too many for _queued_us; the trace is taken
    again, up to 3 times, while it lacks route launches) and _queued_us's
    on the megakernel route (three launches a sample, whose megakernel
    launches the trace does lose); and the number of host-device
    synchronisations in one sample (sync debug mode).'''
    film = new_film(RES, RES, device=DEV)
    ii, jj = pixel_grid(RES, RES, device=DEV)
    rot = pixel_rotation(ii, jj, DIMS)
    names = names or (('path_kernel',) if use_fused
                      else ('shade_kernel', 'any_kernel'))

    def samples():
        for s in (1, 2):
            render_sample(scene, film, s, fused=use_fused, rot=rot)

    def two_samples():
        samples()
        torch.cuda.synchronize()

    before = sum(_counts().values())
    two_samples()
    launched = sum(_counts().values()) - before
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        two_samples()
        walls.append(time.perf_counter() - t0)

    def route_launches(ka):
        return sum(e.count for e in ka if any(n in e.key for n in names))
    ka = _profile(samples, lambda k: route_launches(k) == launched)
    traced = sum(_dev_us(e) for e in ka)
    kern = sum(_dev_us(e) for e in ka if any(n in e.key for n in names))
    recorded = route_launches(ka)
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
    the twin's from the profiler over 3 calls (_profiled_ms).'''
    pt = sobol_block(9, DIMS)

    def kern():
        return fused.fused_trace_primary(scene, pt, RES, RES)

    def kern10():
        for _ in range(10):
            kern()

    def twin():
        return fused.fused_trace_primary_plain(scene, pt, RES, RES)
    kern()
    return _queued_us(kern10) / 1e4, _profiled_ms(twin), _event_ms(kern)


def _sps(run, spp=SPP):
    '''Median wall time of 3 renders of 512^2 x spp, and samples/s.'''
    runs = []
    for _ in range(3):
        film = new_film(RES, RES, device=DEV)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(film)
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
    dt = statistics.median(runs)
    return dt, spp / dt


def _print_route(card, name, route, scene, spp, run, use_fused, names=None):
    '''samples/s, busy share and synchronisations of one scene's route;
    returns the samples/s.'''
    dt, sps = _sps(run, spp)
    print(f'[timing] {card} | render {name} {route} {RES}x{RES} x '
          f'{spp} spp: median {dt:.4f} s of 3 -> {sps:.3f} '
          f'samples/s ({1e3 * dt / spp:.3f} ms/sample)')
    r = _profile_share(scene, use_fused, names)
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
    return sps


def _print_kernel_times(card, name, n, times):
    for k, (ms, plain, call, pcall) in times.items():
        print(f'[timing] {card} | {k:<13} kernel {name} {n} rays: '
              f'device {ms:.4f} ms, plain torch {plain:.4f} ms '
              f'(x{plain / ms:.1f}); per call with launch {call:.4f} '
              f'ms, plain {pcall:.4f} ms')


def _flat_times(card, name, scene, rays, times, bounds):
    '''The [bound] lines of the flat kernels: the needed pairs, the
    FMA-counted bound and the no-contraction ceiling beside the kernel's
    time.'''
    n, nf = rays[0].x.shape[0], int(scene.nfaces)
    for k in ('closest', 'any_flat'):
        ms = times[k][0]
        b, by = bounds[k]
        ceil = bounds['ceiling'][k]
        total, passing = bounds['pairs'][k]
        print(f'[bound] {card} | {k}_kernel {name} {n} rays x {nf} faces: '
              f'{total} pairs needed ({total / (n * nf):.4f} of all), '
              f'{passing} of them pass the sign test ({passing / total:.4f}'
              f'); FMA-counted bound {b:.5f} ms (by {by}), no-contraction '
              f'ceiling ({FLOPS_SIDE} FP32 instructions a pair, {FLOPS_T} '
              f'more a passing one, at {PEAK_FP32_INSTR:.3g}/s) {ceil:.5f} '
              f'ms; kernel {ms:.4f} ms ({b / ms:.1%} of the bound, '
              f'{ceil / ms:.1%} of the ceiling)')


def _rays_head_ms(scene):
    '''fused_trace's device ms a sample at 512^2 (sample 9's inputs), as
    _path_times times the primary head.'''
    ro, rd, pt, base = _primary_inputs(scene, 9)

    def kern10():
        for _ in range(10):
            fused.fused_trace(scene, ro, rd, pt, base)
    kern10()
    return _queued_us(kern10) / 1e4


def phase_timings(card, scenes, tables, highpoly):
    '''The kernels' times and bounds, and the routes' samples/s.  Returns
    (kernel times {table: {kernel: times}}, megakernel times {scene:
    times}, bounds {table or 'path...': ...}, the rays head's ms {scene:
    ms}, samples/s {(scene, route): median of 3}); a table's bounds hold
    its kernels' needed-pairs bounds, their no-contraction ceilings
    ('ceiling') and their needed and passing pairs ('pairs'), and a dense
    table's also the tree casts' all-faces bounds ('all_faces') and visits
    ('visits').'''
    rng = np.random.RandomState(7)
    kt, bounds = {}, {}
    # the two cornells first, then highpoly, then the rest: the earlier
    # PRs' rays
    order = ['cornell', 'cornell_monkey', 'cornell_highpoly'] + [
        k for k in tables if k not in ('cornell', 'cornell_monkey')]
    for name in order:
        if name == 'cornell_highpoly':
            rays = _rays(rng, highpoly, N_FULL)
            kt[name] = _blocked_times(highpoly, rays)
            _print_kernel_times(card, name, N_FULL, kt[name])
            bounds[name] = _blocked_bounds(card, highpoly, rays)
            continue
        rays = _rays(rng, tables[name], N_FULL)
        kt[name] = _kernel_times(tables[name], rays, True)
        _print_kernel_times(card, name, N_FULL, kt[name])
        lanes = _lanes(tables[name]) if name in TREE_SCENES else None
        flat_b, all_faces = _flat_bounds(tables[name], rays)
        tree, ceil, pairs, visits = _dense_bounds(card, name, tables[name],
                                                  rays, lanes, all_faces)
        flat_b['ceiling'].update(ceil)
        flat_b['pairs'].update(pairs)
        bounds[name] = {**tree, **flat_b, 'all_faces': all_faces,
                        'visits': visits}
        _flat_times(card, name, tables[name], rays, kt[name], bounds[name])
    path_bounds = {name: _path_bound(card, name, scene)
                   for name, scene in scenes.items()}
    bounds['path'] = {k: v[0] for k, v in path_bounds.items()}
    bounds['path_all_faces'] = {k: v[1] for k, v in path_bounds.items()}
    bounds['path_ceiling'] = {k: v[2] for k, v in path_bounds.items()}
    bounds['path_pairs'] = {k: v[3] for k, v in path_bounds.items()}
    bounds['path_visits'] = {name: _path_visits(card, name, scene)
                             for name, scene in scenes.items()}
    pk, rays_head = {}, {}
    for name, scene in scenes.items():
        pk[name] = _path_times(scene)
        rays_head[name] = _rays_head_ms(scene)
        ms, plain, call = pk[name]
        print(f'[timing] {card} | path_kernel {name} {RES}x{RES}, depth '
              f'{DEPTH}: device {ms:.4f} ms/sample, plain twin (wavefront, '
              f'CUDA casts) {plain:.4f} ms/sample (x{plain / ms:.1f}); per '
              f'call with launch {call:.4f} ms; explicit-ray head '
              f'(fused_trace) {rays_head[name]:.4f} ms/sample')
    sps = {}
    for name, scene in scenes.items():
        sps[name, 'megakernel'] = _print_route(
            card, name, 'megakernel', scene, SPP,
            lambda f, sc=scene: render(sc, f, 0, spp=SPP), True)
        sps[name, 'wavefront'] = _print_route(
            card, name, 'wavefront', scene, SPP,
            lambda f, sc=scene: _render_wavefront(sc, f, 0, SPP), False)
    print(f'[timing] host: {_host_facts()}')
    sps['cornell_highpoly', 'blocked wavefront'] = _print_route(
        card, 'cornell_highpoly', 'blocked wavefront', highpoly,
        HIGHPOLY_SPP, lambda f: render(highpoly, f, 0, spp=HIGHPOLY_SPP),
        False, ('blocked_shade_kernel', 'blocked_any_kernel'))
    return kt, pk, bounds, rays_head, sps


# ---------------------------------------------------------------- phase 8

@contextlib.contextmanager
def _plain_casts():
    '''Inside the block dispatch.cast_shaded calls the scene-level shade
    wrappers' plain versions, so an engine's output through the CUDA
    casts can be held against the same engine through the plain casts.'''
    saved = dense_cast.cast_shade, blocked.blocked_cast_shade
    dense_cast.cast_shade = dense_cast.cast_shade_plain
    blocked.blocked_cast_shade = blocked.blocked_cast_shade_plain
    try:
        yield
    finally:
        dense_cast.cast_shade, blocked.blocked_cast_shade = saved


def _launched(run):
    '''run() with every count at 0 just before it and read just after:
    (its result, the counts).'''
    _zero_counts()
    out = run()
    torch.cuda.synchronize()
    return out, _counts()


def _need(what, grew, want):
    if grew != want:
        raise AssertionError(f'{what}: launches {grew}, expected {want}')


def _close_share(got, ref, rtol=1e-3):
    '''Share of pixels (rows of the last axis) within rtol * (1 + |ref|):
    tests/test_torch_render.py's contract-vs-brute allowance.'''
    return ((got - ref).abs() <= rtol * (1.0 + ref.abs())).all(-1) \
        .float().mean().item()


def _split_ms(work, names, reps=3):
    '''Device ms per call of work() from the profiler (CUDA activity):
    (the kernels whose names contain one of `names`, all kernels, the
    three costliest kernels' names and ms).'''
    work()
    torch.cuda.synchronize()
    ka = _profile(lambda: [work() for _ in range(reps)],
                  lambda k: sum(_dev_us(e) for e in k) > 0)
    kern = sum(_dev_us(e) for e in ka if any(n in e.key for n in names))
    total = sum(_dev_us(e) for e in ka)
    top = sorted(((e.key[:40], _dev_us(e) / 1e3 / reps) for e in ka),
                 key=lambda kv: -kv[1])[:3]
    return kern / 1e3 / reps, total / 1e3 / reps, top


def _syncs(work):
    '''Host-device synchronisations work() makes (sync debug mode).'''
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        torch.cuda.set_sync_debug_mode('warn')
        try:
            work()
        finally:
            torch.cuda.set_sync_debug_mode('default')
    torch.cuda.synchronize()
    return [str(w.message) for w in caught
            if 'called a synchronizing' in str(w.message)]


def _preview(card, name, scene, key):
    '''render_preview at 512^2, 1 spp: exactly one `key` launch, finite
    AOV passes, the CUDA casts against the plain casts on >= MIN_AGREE of
    pixels; its time.  Returns (launches, device ms, call ms).'''
    film, grew = _launched(lambda: render_preview(
        scene, new_film(RES, RES, device=DEV), 0, spp=1))
    _need(f'preview {name}', grew, _expect(**{key: 1}))
    with _plain_casts():
        plain = render_preview(scene, new_film(RES, RES, device=DEV), 0, spp=1)
    shares = []
    for p in (PASS_ALBEDO, PASS_NORMAL):
        img, ref = film_to_image(film, p), film_to_image(plain, p)
        if not bool(torch.isfinite(img).all()) or bool(film[p, 3].ne(1).any()):
            raise AssertionError(f'preview {name}: pass {p} not finite or '
                                 f'not one sample a pixel')
        shares.append(((img - ref).abs() <= ATTR_ATOL).all(-1).float()
                      .mean().item())
    if bool(film[0].any()) or min(shares) < MIN_AGREE:
        raise AssertionError(f'preview {name}: combined pass touched or '
                             f'CUDA vs plain casts {shares}')
    f = new_film(RES, RES, device=DEV)
    kern, dev, top = _split_ms(lambda: render_preview(scene, f, 0, spp=1),
                               (key + '_kernel',))
    call = _event_ms(lambda: render_preview(scene, f, 0, spp=1))
    hit = (film_to_image(film, PASS_NORMAL)[..., :3].abs().sum(-1) > 0) \
        .float().mean().item()
    made = {k: v for k, v in grew.items() if v}
    print(f'[engines] {card} | preview {name} {RES}x{RES} x 1 spp: launches '
          f'{made}, hit {hit:.4f}; albedo / normal equal to the plain casts\' within '
          f'{ATTR_ATOL} on {shares[0]:.6f} / {shares[1]:.6f} of pixels (>= '
          f'{MIN_AGREE}); device {dev:.4f} ms a sample ({key}_kernel '
          f'{kern:.4f} ms; costliest {top}), per call with launches '
          f'{call:.4f} ms')
    return grew[key], dev, call


def _uniforms_bound(card, scene, ro, rd, x):
    '''The explicit-uniform head's bound on MLT's replay (as _path_bound
    for the primary head): the pairs these chains' paths need on the
    scene's tree (path_trace's lanes on the same uniforms, _needed_pairs),
    and the bytes of the face, tree and texture tables, the rays, the
    uniform rows it reads (2 .. D-1) and the radiance rows it writes.'''
    lanes = []
    path_trace(scene, ro, rd, x, lanes=lanes)
    nf, c = int(scene.nfaces), x.shape[1]
    needed = _needed_pairs(scene, lanes, _occluders(scene, lanes),
                           scene.fused_nodes, scene.fused_order.cpu().numpy(),
                           side=True)
    pairs = sum(a[0] + b[0] for a, b in needed)
    passing = sum(a[1] + b[1] for a, b in needed)
    nbytes = (136 * nf + _nbytes(scene.fused_nodes, scene.fused_order)
              + 64 * nf + _nbytes(scene.textures.data)
              + 4 * c * (6 + x.shape[0] - 2) + 12 * c)
    ops = _work(pairs, passing)
    b = _bound(ops, nbytes)
    print(f'[bound] {card} | path_kernel uniforms head, MLT replay on '
          f'cornell_monkey, {c} chains: needs {pairs} pairs, {passing} of '
          f'them pass the sign test (per bounce (closest pairs, passing) / '
          f'(shadow pairs, passing) {needed}) -> {b[0]:.5f} ms by {b[1]}, '
          f'no-contraction ceiling {_ceiling(ops):.5f} ms')
    return b, _ceiling(ops)


def _mlt(card, scene):
    '''The reference benchmark's MLT cell (bench.py:154-170) on
    cornell_monkey: 512^2 film, 2^17 chains, one warm-up round and
    MLT_ROUNDS timed rounds of MLT_STEPS steps.'''
    gen = torch.Generator(device=DEV).manual_seed(1)
    state = mlt_init(MLT_CHAINS, generator=gen, device=DEV)
    film = new_film(RES, RES, device=DEV)
    (state, film), grew = _launched(
        lambda: render_mlt(scene, state, film, steps=MLT_STEPS))
    _need('MLT warm-up round', grew, _expect(path=MLT_STEPS))
    launches = grew['path']
    rounds = []
    _zero_counts()
    for _ in range(MLT_ROUNDS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, film = render_mlt(scene, state, film, steps=MLT_STEPS)
        torch.cuda.synchronize()
        rounds.append(time.perf_counter() - t0)
    _need('MLT timed rounds', _counts(), _expect(path=MLT_ROUNDS * MLT_STEPS))
    img = film_to_image(film)[..., :3]
    if not bool(torch.isfinite(img).all()) or int(state.step) \
            != (MLT_ROUNDS + 1) * MLT_STEPS:
        raise AssertionError('MLT: film not finite or steps lost')
    mps = MLT_STEPS * MLT_CHAINS / statistics.median(rounds)
    step_wall = statistics.median(rounds) / MLT_STEPS * 1e3
    # one step's proposals replayed through the kernel and through
    # path_trace (the wavefront on the CUDA casts), from the same state
    x_new, _, _ = mlt._propose(state, mlt.LSP, mlt.SIGMA)
    ro, rd = camera_rays(scene.cam_v2w, x_new[0] * 2.0 - 1.0,
                         x_new[1] * 2.0 - 1.0)
    k = _stack(fused.fused_trace_uniforms(scene, ro, rd, x_new))
    p = _stack(path_trace(scene, ro, rd, x_new))
    bit = (k == p).all(0).float().mean().item()
    if bit < MIN_AGREE or not bool(torch.isfinite(k).all()):
        raise AssertionError(f'MLT replay: kernel = path_trace bit for bit '
                             f'on {bit} of chains')
    # where a step's device time goes: the replay (one path_kernel launch)
    # against the proposals (hash_uniform, normaldist) and the splat
    rep = _device_ms(lambda: fused.fused_trace_uniforms(scene, ro, rd, x_new),
                     reps=3)
    rep_call = _event_ms(lambda: fused.fused_trace_uniforms(scene, ro, rd,
                                                            x_new))
    rep_plain = _profiled_ms(lambda: path_trace(scene, ro, rd, x_new))
    prop = _device_ms(lambda: mlt._propose(state, mlt.LSP, mlt.SIGMA), reps=3)
    xi = torch.floor(torch.cat([x_new[0], state.x[0]]) * RES).long()
    yi = torch.floor(torch.cat([x_new[1], state.x[1]]) * RES).long()
    w = torch.rand(4, 2 * MLT_CHAINS, generator=gen, device=DEV)
    splat_film = new_film(RES, RES, device=DEV)
    splat = _device_ms(lambda: film_splat(splat_film, 0, xi, yi, *w), reps=3)
    step_dev = _device_ms(lambda: mlt_step(scene, state, film), reps=3)
    syncs = _syncs(lambda: mlt_step(scene, state, film))
    bound, ceiling = _uniforms_bound(card, scene, ro, rd, x_new)
    print(f'[engines] {card} | MLT cornell_monkey {RES}x{RES} film, '
          f'{MLT_CHAINS} chains, {MLT_STEPS} steps a round: launches a '
          f'round {grew["path"]} path_kernel and no cast; {mps:.1f} '
          f'mutations/s (median of {MLT_ROUNDS} rounds: '
          f'{", ".join(f"{r * 1e3:.3f}" for r in rounds)} ms; '
          f'{MLT_ROUNDS * MLT_STEPS * MLT_CHAINS / sum(rounds):.1f} over '
          f'all, as bench.py:167); kernel = path_trace bit for bit on '
          f'{bit:.6f} of chains')
    print(f'[engines] {card} | MLT step: device {step_dev:.4f} ms of '
          f'{step_wall:.4f} ms wall (busy {step_dev / step_wall:.1%}); '
          f'replay {rep:.4f} ms (path_kernel uniforms head, per call with '
          f'launch {rep_call:.4f} ms; path_trace on the CUDA casts '
          f'{rep_plain:.4f} ms), proposals (hash_uniform, normaldist) '
          f'{prop:.4f} ms, splat of {2 * MLT_CHAINS} {splat:.4f} ms, the '
          f'rest {step_dev - rep - prop - splat:.4f} ms; {len(syncs)} '
          f'host-device synchronisations a step'
          + (f'; first: {syncs[0]}' if syncs else ''))
    if syncs:
        raise AssertionError(f'MLT step synchronises: {syncs[0]}')
    return dict(launches=launches, mps=mps, ms=rep, plain_ms=rep_plain,
                call_ms=rep_call, bound=bound, ceiling=ceiling,
                step_ms=step_dev,
                step_wall_ms=step_wall, splat_ms=splat, propose_ms=prop,
                agree=bit)


def _kelemen(card, scene):
    '''Kelemen's estimator against the path render on cornell at 64^2
    (tests/test_mlt_quant.py's check): brightness within 5%.'''
    truth = film_to_image(render(scene, new_film(64, 64, device=DEV), 0,
                                 spp=KELEMEN_PATH_SPP))[..., :3]
    gen = torch.Generator(device=DEV).manual_seed(7)
    _, film = render_mlt(scene, mlt_init(KELEMEN_CHAINS, generator=gen,
                                         device=DEV),
                         new_film(64, 64, device=DEV), steps=KELEMEN_STEPS)
    img = film_to_image(film)[..., :3]
    err = abs(img.mean().item() - truth.mean().item()) / truth.mean().item()
    print(f'[engines] MLT Kelemen cornell 64x64, {KELEMEN_CHAINS} chains x '
          f'{KELEMEN_STEPS} steps: mean {img.mean().item():.5f} against the '
          f'path render\'s {truth.mean().item():.5f} ({KELEMEN_PATH_SPP} '
          f'spp): brightness error {err:.4f} (< 0.05)')
    if not (bool(torch.isfinite(img).all()) and err < 0.05):
        raise AssertionError(f'MLT Kelemen brightness error {err}')


def _brute(card, scene):
    '''render_brute on cornell at 512^2 x 32 spp: DEPTH shade launches a
    sample and no occlusion cast; mean within 8% of the path render.'''
    film, grew = _launched(lambda: render_brute(
        scene, new_film(RES, RES, device=DEV), 0, spp=BRUTE_SPP))
    _need('brute', grew, _expect(shade=DEPTH * BRUTE_SPP))
    mean = _check_image('brute cornell', film, BRUTE_SPP)
    path_mean = _check_image('path cornell', render(
        scene, new_film(RES, RES, device=DEV), 0, spp=BRUTE_SPP), BRUTE_SPP)
    err = abs(mean - path_mean) / max(mean, path_mean)
    dt, sps = _sps(lambda f: render_brute(scene, f, 0, spp=BRUTE_SPP),
                   BRUTE_SPP)
    f = new_film(RES, RES, device=DEV)
    kern, dev, _ = _split_ms(lambda: render_brute(scene, f, 0, spp=1),
                             ('shade_kernel',))
    ms = dt / BRUTE_SPP * 1e3
    print(f'[engines] {card} | brute cornell {RES}x{RES} x {BRUTE_SPP} spp: '
          f'launches {grew["shade"]} shade ({grew["shade"] / BRUTE_SPP:g} a '
          f'sample), 0 any; mean {mean:.5f} against the path render\'s '
          f'{path_mean:.5f} (rel {err:.4f} < 0.08); median {dt:.4f} s of 3 '
          f'-> {sps:.3f} samples/s ({ms:.3f} ms/sample); device {dev:.4f} '
          f'ms a sample (profiler; shade_kernel {kern:.4f} ms), busy '
          f'{dev / ms:.1%}')
    if err >= 0.08:
        raise AssertionError(f'brute mean {mean} vs path {path_mean}')
    return grew['shade'], ms


def _worker_scene():
    '''scenes.cornell_box built through the worker's calls.'''
    shell, mtl = _cornell_shell()
    tall, short = _cornell_boxes()
    worker.set_size(RES, RES)
    worker.load_model(_mesh_to_vertices(np.concatenate([shell, tall, short])),
                      np.asarray(mtl + [0] * 24, np.int32))
    worker.load_materials(_materials())
    worker.clear_lights()
    light = _ceiling_light()
    world = np.eye(4)
    world[:3, :3], world[:3, 3] = light['axes'], light['pos']
    worker.add_light(world, light['color'], light['size'], 'AREA')
    worker.set_world_light((0.05, 0.05, 0.05, 1.0), -1)
    worker.set_camera(BENCH_CAMERA)
    worker.build_tree()


def _worker_resume(engine, ckpt):
    '''Two renders, save_state, a third; a new worker loads the file and
    renders the third: images (and MLT chains) equal bit for bit.'''
    worker.init(engine=engine)
    _worker_scene()
    worker.render()
    worker.render()
    worker.save_state(ckpt)
    worker.render()
    want, chains = worker.get_image(), worker._S.mlt_state
    worker.init()
    _worker_scene()
    if not worker.load_state(ckpt):
        raise AssertionError('worker: checkpoint not found')
    worker.render()
    same = np.array_equal(worker.get_image(), want)
    if chains is not None:
        got = worker._S.mlt_state
        same = same and all(torch.equal(a, b) for a, b in (
            (got.x, chains.x), (got.l.x, chains.l.x), (got.l.y, chains.l.y),
            (got.l.z, chains.l.z), (got.b_sum, chains.b_sum),
            (got.b_cnt, chains.b_cnt), (got.step, chains.step)))
    os.remove(ckpt)
    return same


def _worker(card, cornell):
    '''The flat worker API at 512^2 on the card: 'path', 'brute', 'mlt'
    and render_preview, each with its launches; the path image against
    engine.path.render's of scenes.cornell_box; checkpoint resumes.'''
    worker.init()
    _worker_scene()
    runs = {}
    for engine, n, want in (('path', 4, dict(path=4)),
                            ('brute', 2, dict(shade=2 * DEPTH)),
                            ('mlt', 2, dict(path=2))):
        worker.set_engine(engine)
        worker.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, grew = _launched(lambda: [worker.render() for _ in range(n)])
        runs[engine] = (time.perf_counter() - t0) / n * 1e3
        _need(f'worker {engine}', grew, _expect(**want))
        img = worker.get_image()
        if img.shape != (RES, RES, 4) or not np.isfinite(img).all():
            raise AssertionError(f'worker {engine}: image')
        if engine == 'path':
            ref = film_to_image(render(cornell, new_film(RES, RES, device=DEV),
                                       0, spp=n)).cpu().numpy()
            if not np.array_equal(img, ref):
                raise AssertionError('worker path image != render\'s')
    t0 = time.perf_counter()
    _, grew = _launched(worker.render_preview)
    runs['preview'] = (time.perf_counter() - t0) * 1e3
    _need('worker preview', grew, _expect(shade=1))
    if not np.isfinite(worker.get_image(PASS_ALBEDO)).all():
        raise AssertionError('worker preview: albedo pass')
    ckpt = os.path.join(ROOT, 'build', 'chip_smoke_worker.ckpt')
    os.makedirs(os.path.dirname(ckpt), exist_ok=True)
    resumed = {e: _worker_resume(e, ckpt) for e in ('path', 'mlt')}
    # ids without a material row (the shell with no materials loaded)
    # take the defaults in the megakernel as in its twin
    worker.init()
    worker.set_size(RES, RES)
    shell, mtl = _cornell_shell()
    worker.load_model(_mesh_to_vertices(shell), np.asarray(mtl, np.int32))
    worker.build_tree()
    pt = sobol_block(0, DIMS)
    err = _hold('worker shell', 'no materials',
                _stack(fused.fused_trace_primary(worker._S.scene, pt, RES,
                                                 RES)),
                _stack(fused.fused_trace_primary_plain(worker._S.scene, pt,
                                                       RES, RES)), False)
    print(f'[engines] {card} | worker {RES}x{RES}, ms a call (first calls, '
          f'scene build excluded): '
          + ', '.join(f'{k} {v:.3f}' for k, v in runs.items())
          + f'; path image = engine.path.render\'s of cornell_box bit for '
          f'bit; save_state / load_state resumes bit for bit: {resumed}')
    if not all(resumed.values()):
        raise AssertionError(f'worker resume: {resumed}')
    return err


def _dense_brute(card, highpoly):
    '''cornell_highpoly built with accel='dense': above MAX_DENSE_FACES it
    casts with the plain brute route (no kernel), held against the
    blocked route at 64^2 x 1 spp: the blocked casts' t lies on the 2^-12
    key grid and brute's is exact, so on a mesh of facets this small a
    few paths branch apart (98.7% of pixels agreed on the 8,214-face
    tessellation on the CPU); >= 95% of pixels and the means within 1%.'''
    t0 = time.perf_counter()
    scene = cornell_highpoly(device=DEV, accel='dense')
    built = time.perf_counter() - t0
    if dispatch.route(scene.tri_w2b.shape[0], 'dense') != 'brute':
        raise AssertionError('highpoly dense: not the brute route')
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    film, grew = _launched(lambda: render(scene, new_film(64, 64, device=DEV),
                                          0, spp=1))
    dt = time.perf_counter() - t0
    _need('highpoly dense (brute)', grew, _expect())
    ref, grew_b = _launched(lambda: render(
        highpoly, new_film(64, 64, device=DEV), 0, spp=1))
    _need('highpoly blocked', grew_b, _expect(blocked_shade=DEPTH,
                                              blocked_any=DEPTH))
    img, want = film_to_image(film)[..., :3], film_to_image(ref)[..., :3]
    share = _close_share(img, want)
    mean_err = abs(img.mean().item() - want.mean().item()) / want.mean().item()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    render(scene, new_film(64, 64, device=DEV), 0, spp=1)
    torch.cuda.synchronize()
    again = time.perf_counter() - t1
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    print(f'[engines] {card} | cornell_highpoly accel=\'dense\' '
          f'({int(scene.nfaces)} faces, built in {built:.2f} s): brute route '
          f'64x64 x 1 spp in {dt:.3f} s (first) / {again:.3f} s, no kernel '
          f'launch, peak {peak:.1f} MiB; against the blocked route {share:.4f} '
          f'of pixels within 1e-3 (1 + |ref|) (>= 0.95), means rel '
          f'{mean_err:.2e} (< 0.01)')
    if not bool(torch.isfinite(img).all()) or share < 0.95 or mean_err >= 0.01:
        raise AssertionError('highpoly dense brute vs blocked')


def phase_engines(card, scenes, highpoly):
    '''The other engines and the worker (module docstring, phase 8).
    Returns the numbers the kernels line carries.'''
    t0 = time.perf_counter()
    out = {}
    out['preview_matball'] = _preview(card, 'matball', scenes['matball'],
                                      'shade')
    out['preview_highpoly'] = _preview(card, 'cornell_highpoly', highpoly,
                                       'blocked_shade')
    out['brute'] = _brute(card, scenes['cornell'])
    out['mlt'] = _mlt(card, scenes['cornell_monkey'])
    _kelemen(card, scenes['cornell'])
    out['worker_err'] = _worker(card, scenes['cornell'])
    _dense_brute(card, highpoly)
    print(f'[engines] phase took {time.perf_counter() - t0:.1f} s')
    return out


# ---------------------------------------------------------------- phase 9

def _get(obj, path):
    for name in path:
        obj = getattr(obj, name)
    return obj


def _grad_loss(img, target):
    '''image_loss's MSE against target, or, target None, the image mean
    (tests/test_grad.py's loss).'''
    return img.mean() if target is None else torch.mean((img - target) ** 2)


def _grad_once(scene, where, target, trace):
    '''One gradient call in the scene tensor at `where` through
    render_image_diff (trace: its _trace_diff), split at the loss:
    (loss, gradient, forward wall ms, backward wall ms).'''
    leaf = _get(scene, where).detach().requires_grad_(True)
    sc = with_tensor(scene, where, leaf)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = _grad_loss(render_image_diff(sc, RES, RES, _trace_diff=trace),
                      target)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    g, = torch.autograd.grad(loss, leaf)
    torch.cuda.synchronize()
    return loss.detach(), g, (t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3


def _grad_fd(scene, where, idx, eps, target):
    '''Central difference of the loss in one entry of the tensor at
    `where`: two renders through render_image_diff's automatic route
    (the megakernel's forward on an eligible scene), losses in float64.'''
    vals = []
    with torch.no_grad():
        for e in (eps, -eps):
            t = _get(scene, where).clone()
            t[idx] += e
            img = render_image_diff(with_tensor(scene, where, t), RES, RES).double()
            vals.append(_grad_loss(img, None if target is None
                                   else target.double()).item())
    return (vals[0] - vals[1]) / (2 * eps)


def _diff_rays(scene):
    '''Sample 0's camera rays and uniforms as diff._sample_diff_fused
    makes them.'''
    ii, jj = pixel_grid(RES, RES, device=DEV)
    u = sample_dims(0, ii, jj, DIMS)
    x = (ii.to(torch.float32) + u[0]) / RES * 2.0 - 1.0
    y = (jj.to(torch.float32) + u[1]) / RES * 2.0 - 1.0
    ro, rd = camera_rays(scene.cam_v2w, x, y)
    return ro, rd, u


def _grad_timing(card, what, scene, where, target, trace, launches):
    '''A gradient call's times: the wall ms of its forward (the loss with
    autograd's graph) and backward (torch.autograd.grad), median of 3
    calls; device ms of each from the profiler (CUDA activity; the trace
    is taken again while empty), path_kernel's by CUDA events (the trace
    can lose its launch); the busy share; the peak memory the call adds
    to what was allocated before it.  Prints one [grad] line.'''
    runs = [_grad_once(scene, where, target, trace)[2:] for _ in range(3)]
    fwd = statistics.median(r[0] for r in runs)
    bwd = statistics.median(r[1] for r in runs)
    leaf = _get(scene, where).detach().requires_grad_(True)
    sc = with_tensor(scene, where, leaf)
    held = {}

    def forward():
        held['loss'] = _grad_loss(render_image_diff(sc, RES, RES,
                                                    _trace_diff=trace),
                                  target)

    def backward():
        torch.autograd.grad(held['loss'], leaf, retain_graph=True)

    def nonempty(ka):
        return sum(_dev_us(e) for e in ka) > 0
    dev = []
    for work in (forward, backward):
        ka = _profile(work, nonempty)
        dev.append(sum(_dev_us(e) for e in ka if 'path_kernel' not in e.key)
                   / 1e3)
    # the backward's three costliest kernels: (name, launches, device ms)
    top = sorted(((e.key[:48], e.count, _dev_us(e) / 1e3) for e in ka),
                 key=lambda kv: -kv[2])[:3]
    path_ms = 0.0
    if launches.get('path'):
        ro, rd, u = _diff_rays(scene)
        path_ms = _device_ms(lambda: fused.fused_trace_uniforms(scene, ro, rd,
                                                                u), reps=3)
        dev[0] += path_ms
    held.clear()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _grad_once(scene, where, target, trace)
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    busy = (dev[0] + dev[1]) / (fwd + bwd)
    made = {k: v for k, v in launches.items() if v}
    print(f'[grad] {card} | {what}: launches {made}; wall forward '
          f'{fwd:.3f} + backward {bwd:.3f} = {fwd + bwd:.3f} ms a gradient '
          f'call (median of 3); device forward {dev[0]:.4f} + backward '
          f'{dev[1]:.4f} = {dev[0] + dev[1]:.4f} ms (profiler'
          + (f'; path_kernel {path_ms:.4f} ms by CUDA events' if path_ms
             else '') + f'), busy {busy:.1%}; peak memory +{peak:.3f} GiB '
          f'over {base / 2 ** 30:.3f} GiB allocated; the backward\'s '
          f'costliest kernels (launches, ms): '
          + '; '.join(f'{k} ({n}, {ms:.3f})' for k, n, ms in top))
    return dict(launches=made, fwd_ms=fwd, bwd_ms=bwd, dev_fwd_ms=dev[0],
                dev_bwd_ms=dev[1], busy=busy, peak_gib=peak)


def _hold_fd(what, g, fd, floor):
    '''tests/test_grad.py's check: |g - fd| < 5% of max(|fd|, floor).'''
    print(f'[grad] {what}: autograd {g:.6e}, central difference {fd:.6e} '
          f'(rel {abs(g - fd) / max(abs(fd), floor):.4f} < 0.05)')
    if not abs(g - fd) < 0.05 * max(abs(fd), floor):
        raise AssertionError(f'{what}: autograd {g} vs difference {fd}')


def _grad_monkey(card, scene):
    '''material_grad on cornell_monkey through the pair (the automatic
    route) and the wavefront (render_image_diff's _trace_diff=False, through
    diff._loss_and_grad): launches, losses within
    2e-3, gradients at tests/test_grad.py:161-165's tolerances; the white
    wall's basecolor red against a central difference.'''
    zero = torch.zeros(RES, RES, 3, device=DEV)
    (lf, gf), pair = _launched(lambda: material_grad(scene, zero))
    _need('grad monkey pair', pair, _expect(path=1, shade=DEPTH, any=DEPTH))
    (lw, gw), wave = _launched(lambda: _loss_and_grad(
        scene, zero, ('materials', 'fac'), trace_diff=False))
    _need('grad monkey wavefront', wave, _expect(shade=DEPTH, any=DEPTH))
    rel = abs(lf.item() - lw.item()) / max(lw.item(), 1e-6)
    atol = 1e-4 * max(gw.abs().max().item(), 1e-6)
    close = torch.isclose(gf, gw, rtol=0.05, atol=atol)
    print(f'[grad] {card} | cornell_monkey material_grad {RES}x{RES} x 1 '
          f'spp: loss pair {lf.item():.6e}, wavefront {lw.item():.6e} (rel '
          f'{rel:.2e} < 2e-3); gradients allclose(rtol=0.05, atol='
          f'{atol:.2e}) on {close.float().mean().item():.6f} of '
          f'{gf.numel()} entries, max |g| {gw.abs().max().item():.4e}')
    if rel >= 2e-3 or not bool(torch.isfinite(gf).all()) \
            or not bool(close.all()):
        raise AssertionError('grad monkey: pair vs wavefront')
    _hold_fd(f'{card} | cornell_monkey fac[0, 0, 0] (eps 1e-2)',
             gf[0, 0, 0].item(),
             _grad_fd(scene, ('materials', 'fac'), (0, 0, 0), 1e-2, zero),
             1e-3)
    return pair, wave


def _grad_matball(card, scene):
    '''texture_grad on matball (the 64x64 roughness ramp) through the
    pair: finite, channels 1-3 zero, a share of channel 0 strictly
    between 0 and 1 nonzero, the highest-gradient texel against a
    central difference.'''
    zero = torch.zeros(RES, RES, 3, device=DEV)
    (loss, g), grew = _launched(lambda: texture_grad(scene, zero))
    _need('grad matball', grew, _expect(path=1, shade=DEPTH, any=DEPTH))
    ch0 = g[0, :, :, 0].abs()
    share = (ch0 > 0).float().mean().item()
    rest = g[..., 1:].abs().sum().item()
    xi, yi = np.unravel_index(int(ch0.argmax()), tuple(ch0.shape))
    print(f'[grad] {card} | matball texture_grad {RES}x{RES} x 1 spp: loss '
          f'{loss.item():.6e}; channel 0 nonzero on {share:.4f} of '
          f'{ch0.numel()} texels, channels 1-3 sum |g| {rest}; highest '
          f'texel ({xi}, {yi})')
    if not bool(torch.isfinite(g).all()) or rest != 0 \
            or not 0 < share < 1:
        raise AssertionError('grad matball: texture gradient')
    _hold_fd(f'{card} | matball texel ({xi}, {yi}) channel 0 (eps 1e-2)',
             g[0, xi, yi, 0].item(),
             _grad_fd(scene, ('textures', 'data'), (0, xi, yi, 0), 1e-2,
                      zero), 1e-4)
    return grew


def _grad_inverse(card, scene):
    '''inverse_render_step, 4 steps on cornell toward a target rendered
    with the white wall's basecolor at half: the loss falls from the first
    step to the last; a step is fac - lr * g bit for bit.'''
    fac = scene.materials.fac.clone()
    fac[0, 0, :3] *= 0.5
    with torch.no_grad():
        target = render_image_diff(with_tensor(scene, ('materials', 'fac'), fac),
                                   RES, RES)
    _, g = material_grad(scene, target)
    losses, times, sc = [], [], scene
    for _ in range(INVERSE_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nxt, loss = inverse_render_step(sc, target, lr=INVERSE_LR)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if not losses and not torch.equal(
                nxt.materials.fac, scene.materials.fac - INVERSE_LR * g):
            raise AssertionError('inverse_render_step: fac - lr g differs')
        losses.append(loss.item())
        sc = nxt
    print(f'[grad] {card} | cornell inverse_render_step x {INVERSE_STEPS} '
          f'(lr {INVERSE_LR}) toward the wall at half its basecolor: losses '
          f'{", ".join(f"{v:.6e}" for v in losses)}; wall '
          f'{statistics.median(times):.3f} ms a step (median); first step = '
          f'fac - lr g bit for bit; wall red '
          f'{scene.materials.fac[0, 0, 0].item():.4f}'
          f' -> {sc.materials.fac[0, 0, 0].item():.4f} (target '
          f'{fac[0, 0, 0].item():.4f})')
    if not losses[-1] < losses[0]:
        raise AssertionError(f'inverse_render_step: losses {losses}')


def phase_grad(card, scenes, highpoly):
    '''The gradients at 512^2, depth 5, 1 spp a call (module docstring,
    phase 9).  Returns the launches of the pair, the wavefront and the
    blocked route.'''
    t0 = time.perf_counter()
    zero = torch.zeros(RES, RES, 3, device=DEV)
    fac = ('materials', 'fac')
    monkey = scenes['cornell_monkey']
    pair, wave = _grad_monkey(card, monkey)
    _grad_timing(card, 'cornell_monkey material_grad, pair', monkey, fac,
                 zero, None, pair)
    _grad_timing(card, 'cornell_monkey material_grad, wavefront', monkey, fac,
                 zero, False, wave)
    matball_launches = _grad_matball(card, scenes['matball'])
    _grad_timing(card, 'matball texture_grad, pair', scenes['matball'],
                 ('textures', 'data'), zero, None, matball_launches)
    # the light color (cornell) and world factor (envlight) in the image
    # mean, as tests/test_grad.py differentiates them
    for name, where, idx, eps, floor in (
            ('cornell', ('lights', 'color'), (0, 0), 1e-1, 1e-5),
            ('envlight', ('world_fac',), (0,), 1e-2, 1e-4)):
        (_, g, _, _), grew = _launched(lambda: _grad_once(
            scenes[name], where, None, None))
        _need(f'grad {name}', grew, _expect(path=1, shade=DEPTH, any=DEPTH))
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f'grad {name}: not finite')
        _hold_fd(f'{card} | {name} {".".join(where)}{list(idx)} (eps {eps})',
                 g[idx].item(), _grad_fd(scenes[name], where, idx, eps, None),
                 floor)
        _grad_timing(card, f'{name} d mean / d {".".join(where)}, pair',
                     scenes[name], where, None, None, grew)
    (loss, g), blocked_launches = _launched(lambda: material_grad(highpoly,
                                                                  zero))
    _need('grad highpoly', blocked_launches,
          _expect(blocked_shade=DEPTH, blocked_any=DEPTH))
    if not bool(torch.isfinite(g).all()):
        raise AssertionError('grad highpoly: not finite')
    _hold_fd(f'{card} | cornell_highpoly fac[0, 0, 0] (eps 1e-2)',
             g[0, 0, 0].item(), _grad_fd(highpoly, fac, (0, 0, 0), 1e-2,
                                         zero), 1e-3)
    _grad_timing(card, 'cornell_highpoly material_grad, blocked wavefront',
                 highpoly, fac, zero, None, blocked_launches)
    _grad_inverse(card, scenes['cornell'])
    print(f'[grad] phase took {time.perf_counter() - t0:.1f} s')
    return dict(pair=pair, wavefront=wave, blocked=blocked_launches)


# ---------------------------------------------------------------- phase 10

def _same_film(what, got, ref):
    if not torch.equal(got, ref):
        d = (got - ref).abs()
        raise AssertionError(f'{what}: films differ on {int((d > 0).sum())} '
                             f'values, max {d.max().item():.3e}')


def _wall_ms(fn, reps=3):
    '''Median wall ms of `reps` calls of fn(), each ending in a device
    synchronisation.'''
    runs = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(runs)


def _scale_spb(card, scenes):
    '''render(spp=32, spb=8) and spb=1 on the five scenes at 512^2: equal
    films bit for bit, 32 path launches each render.'''
    for name, scene in scenes.items():
        films, walls = [], []
        for spb in (SCALE_SPB, 1):
            t0 = time.perf_counter()
            film, grew = _launched(lambda: render(
                scene, new_film(RES, RES, device=DEV), 0, spp=SPP, spb=spb))
            walls.append(time.perf_counter() - t0)
            _need(f'scale spb={spb} {name}', grew, _expect(path=SPP))
            films.append(film)
        _same_film(f'scale {name} spb={SCALE_SPB} vs spb=1', *films)
        print(f'[scale] {card} | render {name} {RES}x{RES} x {SPP} spp: '
              f'spb={SCALE_SPB} and spb=1 equal bit for bit, {SPP} path '
              f'launches each; wall {walls[0]:.3f} / {walls[1]:.3f} s '
              f'(first runs)')
    return {'path': SPP}


def _scale_bands(card, scenes, highpoly, mesh):
    '''render_sharded over the mesh (4 x the card) against render: monkey
    on the megakernel and the wavefront, highpoly on the blocked route,
    bit for bit, with each band's launches and no collective; samples/s of
    both.  Returns {route: launches and rates}.'''
    monkey, n = scenes['cornell_monkey'], len(mesh)
    cases = (
        ('megakernel', 'cornell_monkey', monkey, SCALE_SPP, None,
         lambda f: render(monkey, f, 0, spp=SCALE_SPP),
         _expect(path=n * SCALE_SPP)),
        ('wavefront', 'cornell_monkey', monkey, SCALE_SPP, False,
         lambda f: _render_wavefront(monkey, f, 0, SCALE_SPP),
         _expect(shade=DEPTH * n * SCALE_SPP, any=DEPTH * n * SCALE_SPP)),
        ('blocked', 'cornell_highpoly', highpoly, SCALE_HIGHPOLY_SPP, None,
         lambda f: render(highpoly, f, 0, spp=SCALE_HIGHPOLY_SPP),
         _expect(blocked_shade=DEPTH * n * SCALE_HIGHPOLY_SPP,
                 blocked_any=DEPTH * n * SCALE_HIGHPOLY_SPP)))
    out = {}
    for route, name, scene, spp, fused_route, one, want in cases:
        def sharded(f, sc=scene, spp=spp, fr=fused_route):
            with _collectives_raise():
                return render_sharded(sc, f, 0, mesh, spp=spp, fused=fr)
        ref = one(new_film(RES, RES, device=DEV))
        film, grew = _launched(lambda: sharded(new_film(RES, RES,
                                                        device=DEV)))
        _need(f'scale bands {route}', grew, want)
        _same_film(f'scale bands {route} {name}', film, ref)
        _check_image(f'bands {route}', film, spp, RES)
        ms_bands = _wall_ms(lambda: sharded(new_film(RES, RES, device=DEV)))
        ms_one = _wall_ms(lambda: one(new_film(RES, RES, device=DEV)))
        out[route] = dict(launches={k: v for k, v in grew.items() if v},
                          sps_bands=spp / ms_bands * 1e3,
                          sps_one=spp / ms_one * 1e3)
        print(f'[scale] {card} | render_sharded {name}, {route}, {n} bands '
              f'of {RES // n}x{RES} on {mesh[0]}, {spp} spp: equal to the '
              f'one-band render bit for bit, no collective; launches '
              f'{out[route]["launches"]}; {out[route]["sps_bands"]:.3f} '
              f'samples/s (median of 3: {ms_bands:.3f} ms) against render '
              f'{out[route]["sps_one"]:.3f} ({ms_one:.3f} ms)')
    return out


def _scale_grad(card, monkey, mesh):
    '''train_step_sharded on cornell_monkey at 512^2 over the mesh, toward
    the image with the white wall at half its basecolor (phase 9's
    inverse_render_step target): the gradient against the one-band
    wavefront material_grad (rtol 1e-3, tests/test_sharding.py:79), two
    steps lower the loss; the step's wall and device ms.  Returns its
    launches and times.'''
    n = len(mesh)
    fac = monkey.materials.fac.clone()
    fac[0, 0, :3] *= 0.5
    with torch.no_grad():
        target = render_image_diff(with_tensor(monkey, ('materials', 'fac'),
                                               fac), RES, RES,
                                   _trace_diff=False)
    film0 = new_film(RES, RES, device=DEV)

    def step(scene):
        return train_step_sharded(scene, film0, target, 0, mesh,
                                  lr=INVERSE_LR)
    (s1, l1), grew = _launched(lambda: step(monkey))
    grew = {k: v for k, v in grew.items() if v}
    _need('scale grad', grew, {'shade': DEPTH * n, 'any': DEPTH * n})
    _, g1 = _loss_and_grad(monkey, target, ('materials', 'fac'),
                           trace_diff=False)
    g4 = (monkey.materials.fac - s1.materials.fac) / INVERSE_LR
    atol = 1e-6 * g1.abs().max().item()
    close = torch.isclose(g4, g1, rtol=1e-3, atol=atol)
    _, l2 = step(s1)
    wall = _wall_ms(lambda: step(monkey))
    ka = _profile(lambda: step(monkey),
                  lambda k: sum(_dev_us(e) for e in k) > 0)
    dev_ms = sum(_dev_us(e) for e in ka) / 1e3
    print(f'[scale] {card} | train_step_sharded cornell_monkey {RES}x{RES}, '
          f'{n} bands, toward the wall at half its basecolor: launches '
          f'{grew}; gradient allclose(rtol=1e-3, atol='
          f'{atol:.2e}) to the one-band wavefront material_grad on '
          f'{close.float().mean().item():.6f} of {g1.numel()} entries (max '
          f'|diff| {(g4 - g1).abs().max().item():.3e}); losses '
          f'{l1.item():.6e} -> {l2.item():.6e} (lr {INVERSE_LR}); wall '
          f'{wall:.3f} ms a step (median of 3), device {dev_ms:.4f} ms '
          f'(profiler)')
    if not bool(close.all()) or not l2.item() < l1.item():
        raise AssertionError('scale grad: sharded gradient or descent')
    return dict(launches=grew, wall_ms=wall, dev_ms=dev_ms)


def _scale_two_process(card):
    '''The two-process launcher on the card (two ranks on cuda:0, gloo):
    gathered film = one-process render bit for bit, no collective while
    rendering, the gradient all-reduce = the in-process mean.'''
    cmd = [sys.executable, '-m', 'ptina_tpu_torch.parallel', '--res',
           str(TWO_PROC_RES), '--spp', str(TWO_PROC_SPP), '--device', DEV,
           '--timeout', '300']
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                       cwd=ROOT)
    lines = [line for line in r.stdout.splitlines() if line.startswith('{')]
    if r.returncode != 0 or not lines:
        raise AssertionError(f'two-process launcher exit {r.returncode}:\n'
                             f'{r.stdout[-3000:]}\n{r.stderr[-3000:]}')
    out = json.loads(lines[-1])
    print(f'[scale] {card} | two processes, {TWO_PROC_RES}x{TWO_PROC_RES} x '
          f'{TWO_PROC_SPP} spp: {json.dumps(out)}')
    if out['world_sizes_seen'] != [2, 2] or not out['band_equal'] \
            or not out['gathered_equal'] or out['render_collectives'] \
            or not out['grad_allclose']:
        raise AssertionError(f'two-process launcher: {out}')
    return out


def _lbvh_invariants(name, bvh):
    '''tests/test_lbvh.py:22-44's invariants, vectorised: every face one
    leaf, every node but the root one child, parent boxes hold their
    children's.'''
    n = bvh.leaf.shape[0]
    child = bvh.child.long()
    ok = torch.equal(torch.sort(bvh.leaf.long())[0],
                     torch.arange(n, device=DEV))
    want = torch.cat([torch.arange(n, device=DEV),
                      torch.arange(n + 1, 2 * n - 1, device=DEV)])
    ok &= torch.equal(torch.sort(child.reshape(-1))[0], want)
    for c in (child[:, 0], child[:, 1]):
        leaf = (c < n)[:, None]
        li, ni = c.clamp(max=n - 1), (c - n).clamp(min=0)
        cmin = torch.where(leaf, bvh.leaf_bmin[li], bvh.bmin[ni])
        cmax = torch.where(leaf, bvh.leaf_bmax[li], bvh.bmax[ni])
        ok &= bool((bvh.bmin <= cmin).all()) \
            and bool((bvh.bmax >= cmax).all())
    if not ok:
        raise AssertionError(f'lbvh {name}: build invariants')


def _scale_lbvh(card, scenes, highpoly):
    '''lbvh_build on the card over the live faces of cornell_monkey,
    envlight and cornell_highpoly (build ms, invariants); lbvh_traverse on
    65,536 random rays of the first two against brute.cast_closest (the
    same index on > 97%, t within rtol 1e-4 where they agree,
    tests/test_aux.py:101-105), beside the table-level
    dispatch.cast_closest (closest_kernel, launched once) on those rays.
    Returns the rows of the [scale] lines.'''
    rng = np.random.RandomState(10)
    out = {'closest': 0}
    for name, scene in (('cornell_monkey', scenes['cornell_monkey']),
                        ('envlight', scenes['envlight']),
                        ('cornell_highpoly', highpoly)):
        nf = int(scene.nfaces)
        tris = scene.tri_pos[:nf].contiguous()
        bvh = lbvh_build(tris)
        build_ms = _wall_ms(lambda: lbvh_build(tris))
        _lbvh_invariants(name, bvh)
        cpu = lbvh_build(tris.cpu())
        same_build = all(torch.equal(getattr(bvh, f).cpu(), getattr(cpu, f))
                         for f in ('leaf', 'child', 'bmin', 'bmax'))
        out[name] = dict(faces=nf, build_ms=build_ms)
        line = (f'[scale] {card} | lbvh_build {name}: {nf} faces in '
                f'{build_ms:.3f} ms (median of 3), invariants hold, equal to '
                f'the CPU build: {same_build}')
        if scene is highpoly:
            print(line)
            continue
        ro, rd, _, _ = _rays(rng, scene, LBVH_RAYS)
        ro3 = torch.stack([ro.x, ro.y, ro.z], 1)
        rd3 = torch.stack([rd.x, rd.y, rd.z], 1)
        none = torch.full((LBVH_RAYS,), -1, dtype=torch.int32, device=DEV)
        w2b = scene.tri_w2b[:nf].contiguous()
        ht = lbvh_traverse(bvh, w2b, ro3, rd3, none)
        trav_ms = _wall_ms(lambda: lbvh_traverse(bvh, w2b, ro3, rd3, none))
        hb = brute.cast_closest(ro, rd, w2b, none)
        hk, grew = _launched(lambda: intersect.cast_closest(ro, rd, w2b,
                                                            none))
        _need(f'lbvh oracle {name}', grew, _expect(closest=1))
        out['closest'] += 1
        kern_ms = _device_ms(lambda: intersect.cast_closest(ro, rd, w2b,
                                                            none))
        same = hb.index == ht.index
        agree = same.float().mean().item()
        hits = hb.hit & same
        t_ok = bool(torch.allclose(hb.t[hits], ht.t[hits], rtol=1e-4,
                                   atol=1e-4))
        kern_same = (hk.index == ht.index).float().mean().item()
        out[name].update(traverse_ms=trav_ms, closest_kernel_ms=kern_ms,
                         agree=agree)
        print(line + f'; lbvh_traverse on {LBVH_RAYS} random rays: hit '
              f'{hb.hit.float().mean().item():.4f}, the same face as brute '
              f'on {agree:.6f} (> 0.97), t within rtol 1e-4 where they '
              f'agree: {t_ok}; {trav_ms:.3f} ms wall (median of 3) against '
              f'closest_kernel {kern_ms:.4f} ms device (the same face as '
              f'lbvh_traverse on {kern_same:.6f})')
        if not agree > 0.97 or not t_ok:
            raise AssertionError(f'lbvh {name}: traversal vs brute')
    return out


def phase_scale(card, scenes, highpoly):
    '''Phase 10 (module docstring): spb, film bands, the sharded gradient
    step, the two-process launcher, the LBVH oracle; each item with every
    count at 0 just before it and read just after.'''
    t0 = time.perf_counter()
    mesh = make_mesh([DEV] * SCALE_BANDS)
    out = {'spb': _scale_spb(card, scenes)}
    out['bands'] = _scale_bands(card, scenes, highpoly, mesh)
    out['grad'] = _scale_grad(card, scenes['cornell_monkey'], mesh)
    out['two_process'] = _scale_two_process(card)
    out['lbvh'] = _scale_lbvh(card, scenes, highpoly)
    print(f'[scale] phase took {time.perf_counter() - t0:.1f} s')
    return out


# ---------------------------------------------------------------- phase 11

# the front-ends at the main path's width: the glTF monkey and matball at
# 512^2 x 32 spp, the highpoly GLB at 512^2 x 8 spp (the blocked route's
# cell), the Blender engine's final render at 512^2 x 32 spp and its
# viewport ladder from 1/8 of 512^2
FRONT_SPP = 32
EXAMPLE_TIMEOUT = 600
EXAMPLES = ('smoke_render', 'coverage', 'matball', 'metropolis', 'objloader',
            'interactive')
# the smoke render the verify notes start the system with, at the main
# path's width
SMOKE_ARGS = (str(RES), str(SPP), 'monkey')
_GL_COMPONENT = {np.dtype(np.float32): 0x1406, np.dtype(np.uint8): 0x1401,
                 np.dtype(np.uint16): 0x1403, np.dtype(np.uint32): 0x1405}
_GL_TYPE = {1: 'SCALAR', 2: 'VEC2', 3: 'VEC3'}


def write_gltf(path, meshes, nodes, materials=(), images=(), mode='gltf'):
    '''Write a glTF 2.0 asset.  meshes: one list of primitive dicts a
    mesh, each with 'position' [V, 3] float32 and optionally 'normal' [V,
    3], 'texcoord' [V, 2], 'indices' [K] (uint8 / 16 / 32), 'material'
    and 'interleave' (the vertex attributes in one byteStride view).
    nodes: glTF node dicts (the roots are the nodes no node lists as a
    child).  materials: glTF material dicts; images: PNG bytes, each one
    texture.  mode: 'gltf' (the buffer as a data URI), 'external' (a
    .bin file beside it) or 'glb'.'''
    blob, views, accessors = bytearray(), [], []

    def view(data, stride=None):
        blob.extend(b'\0' * (-len(blob) % 4))
        views.append({'buffer': 0, 'byteOffset': len(blob),
                      'byteLength': len(data)})
        if stride:
            views[-1]['byteStride'] = stride
        blob.extend(data)
        return len(views) - 1

    def accessor(v, arr, offset=0):
        arr = arr.reshape(arr.shape[0], -1)
        accessors.append({'bufferView': v, 'byteOffset': offset,
                          'componentType': _GL_COMPONENT[arr.dtype],
                          'count': arr.shape[0],
                          'type': _GL_TYPE[arr.shape[1]]})
        return len(accessors) - 1

    gl_meshes = []
    for prims in meshes:
        out = []
        for p in prims:
            cols = [(name, np.ascontiguousarray(p[key], np.float32))
                    for name, key in (('POSITION', 'position'),
                                      ('NORMAL', 'normal'),
                                      ('TEXCOORD_0', 'texcoord'))
                    if p.get(key) is not None]
            attrs = {}
            if p.get('interleave'):
                rows = np.concatenate([a for _, a in cols], axis=1)
                v, off = view(rows.tobytes(), stride=rows.shape[1] * 4), 0
                for name, a in cols:
                    attrs[name] = accessor(v, a, off)
                    off += a.shape[1] * 4
            else:
                for name, a in cols:
                    attrs[name] = accessor(view(a.tobytes()), a)
            pos = accessors[attrs['POSITION']]
            pos['min'] = cols[0][1].min(0).tolist()
            pos['max'] = cols[0][1].max(0).tolist()
            prim = {'attributes': attrs}
            if p.get('indices') is not None:
                idx = np.ascontiguousarray(p['indices'])
                prim['indices'] = accessor(view(idx.tobytes()), idx)
            if p.get('material') is not None:
                prim['material'] = int(p['material'])
            out.append(prim)
        gl_meshes.append({'primitives': out})
    children = {c for n in nodes for c in n.get('children', ())}
    model = {'asset': {'version': '2.0'}, 'scene': 0,
             'scenes': [{'nodes': [i for i in range(len(nodes))
                                   if i not in children]}],
             'nodes': list(nodes), 'meshes': gl_meshes}
    if materials:
        model['materials'] = list(materials)
    if images:
        model['images'] = [{'bufferView': view(png), 'mimeType': 'image/png'}
                           for png in images]
        model['textures'] = [{'source': i} for i in range(len(images))]
    model.update(accessors=accessors, bufferViews=views,
                 buffers=[{'byteLength': len(blob)}])
    if mode == 'glb':
        js = json.dumps(model).encode()
        js += b' ' * (-len(js) % 4)
        blob.extend(b'\0' * (-len(blob) % 4))
        with open(path, 'wb') as f:
            f.write(struct.pack('<III', 0x46546C67, 2,
                                12 + 8 + len(js) + 8 + len(blob)))
            f.write(struct.pack('<II', len(js), 0x4E4F534A) + js)
            f.write(struct.pack('<II', len(blob), 0x004E4942) + bytes(blob))
        return
    if mode == 'external':
        bin_name = os.path.splitext(os.path.basename(path))[0] + '.bin'
        with open(os.path.join(os.path.dirname(path), bin_name), 'wb') as f:
            f.write(blob)
        model['buffers'][0]['uri'] = bin_name
    else:
        model['buffers'][0]['uri'] = ('data:application/octet-stream;base64,'
                                      + base64.b64encode(blob).decode())
    with open(path, 'w') as f:
        json.dump(model, f)


def _node_local(node):
    '''A node's local matrix, as io.readgltf computes it.'''
    if 'matrix' in node:
        return np.asarray(node['matrix'], float).reshape(4, 4).T
    local = gl_matrix.identity()
    if 'scale' in node:
        local = gl_matrix.scale(node['scale']) @ local
    if 'rotation' in node:
        local = gl_matrix.quaternion(node['rotation']) @ local
    if 'translation' in node:
        local = gl_matrix.translate(node['translation']) @ local
    return local


def mesh_worlds(nodes):
    '''[(mesh index, world matrix)] of the node hierarchy in readgltf's
    walk order, each world composed as it composes it (parent @ local).'''
    out = []

    def walk(i, world):
        world = world @ _node_local(nodes[i])
        if 'mesh' in nodes[i]:
            out.append((nodes[i]['mesh'], world))
        for c in nodes[i].get('children', ()):
            walk(c, world)
    children = {c for n in nodes for c in n.get('children', ())}
    for i in range(len(nodes)):
        if i not in children:
            walk(i, gl_matrix.identity())
    return out


def gl_primitives(verts, mtlids, world, index_dtype, interleave=False):
    '''One mesh part ([F*3, 8] vertices in the world, [F] ids) as glTF
    primitives, one a material: positions and normals taken into the
    frame of `world` (a rotation, a uniform scale and a translation), the
    vertex rows deduplicated, indices of `index_dtype`.'''
    lin = world[:3, :3]
    rot = lin / np.cbrt(np.linalg.det(lin))
    pos = np.concatenate([verts[:, :3].astype(np.float64),
                          np.ones((len(verts), 1))], 1) \
        @ np.linalg.inv(world).T
    rows = np.concatenate([pos[:, :3], verts[:, 3:6].astype(np.float64) @ rot,
                           verts[:, 6:8]], 1).astype(np.float32)
    prims = []
    for m in dict.fromkeys(mtlids.tolist()):
        corners = rows.reshape(-1, 3, 8)[mtlids == m].reshape(-1, 8)
        uniq, idx = np.unique(corners, axis=0, return_inverse=True)
        prims.append(dict(position=uniq[:, :3], normal=uniq[:, 3:6],
                          texcoord=uniq[:, 6:8],
                          indices=idx.reshape(-1).astype(index_dtype),
                          material=m, interleave=interleave))
    return prims


def composed_inputs(meshes, nodes):
    '''The (p, n, t, world, mtlid) primitives readgltf hands
    compose_multiple_meshes for the asset, in its walk order.'''
    out = []
    for mi, world in mesh_worlds(nodes):
        for p in meshes[mi]:
            f = p['indices'].astype(np.int64)
            t = p.get('texcoord')
            out.append((p['position'][f].reshape(-1, 3, 3),
                        p['normal'][f].reshape(-1, 3, 3),
                        None if t is None else t[f].reshape(-1, 3, 2),
                        world, p['material']))
    return out


def _quat(axis, deg):
    axis = np.asarray(axis, float) / np.linalg.norm(axis)
    h = np.radians(deg) / 2
    return [*(axis * np.sin(h)).tolist(), float(np.cos(h))]


def gl_materials(mats):
    '''glTF pbrMetallicRoughness of the port's cornell materials (base
    color, metallic and roughness factors), and the worker's materials
    that readgltf returns for them.'''
    gl, ours = [], []
    for mat in mats:
        base = [*np.asarray(mat[0][0], np.float64).tolist(), 1.0]
        gl.append({'pbrMetallicRoughness': {
            'baseColorFactor': base, 'metallicFactor': float(mat[1][0]),
            'roughnessFactor': float(mat[2][0])}})
        ours.append(((base, -1), (float(mat[1][0]), -1),
                     (float(mat[2][0]), -1)))
    return gl, ours


def monkey_asset():
    '''cornell_monkey as a glTF asset: the shell (three primitives, one a
    material, uint16 indices) under a TRS root, the blob (interleaved,
    one byteStride view, uint32 indices) under a `matrix` child, the box
    under a TRS grandchild.  Returns (meshes, nodes, gl materials, the
    worker's materials).'''
    nodes = [
        {'translation': [0.25, -0.5, 0.125], 'rotation': _quat((0, 1, 0), 30),
         'scale': [1.25, 1.25, 1.25], 'children': [1, 2]},
        {'mesh': 0},
        {'matrix': (gl_matrix.translate((0.0, 0.5, 0.0))
                    @ gl_matrix.quaternion(_quat((1, 0, 0), 10))).T
         .reshape(-1).tolist(), 'mesh': 1, 'children': [3]},
        {'translation': [-0.5, 0.0, 0.25], 'mesh': 2},
    ]
    worlds = dict(mesh_worlds(nodes))
    (shell, ms), (blob, mb), (box, mx) = _blob_parts()
    meshes = [gl_primitives(shell, ms, worlds[0], np.uint16),
              gl_primitives(blob, mb, worlds[1], np.uint32, interleave=True),
              gl_primitives(box, mx, worlds[2], np.uint16)]
    gl, ours = gl_materials(_materials())
    return meshes, nodes, gl, ours


def ramp_png():
    '''The benchmark's 64x64 grey ramp (bench_texture) as 8-bit RGB, in
    the film's axis order, and its PNG (rows are the second axis, as
    glTF images are stored and readgltf swaps them back).'''
    ramp = np.round(bench_texture() * 255).astype(np.uint8)
    return ramp, png_codec.encode(np.ascontiguousarray(ramp.swapaxes(0, 1)))


def matball_asset(png):
    '''scenes.matball with its roughness ramp: the ground quad and the
    2,214-triangle sphere (spherical UVs) under one node, the ramp an
    embedded PNG bound as the ball's metallicRoughness texture (metallic
    factor 0, roughness factor 1).'''
    ground = np.asarray(_quad([-6, 0, 6], [6, 0, 6], [6, 0, -6], [-6, 0, -6]),
                        np.float32)
    ball = _uv_sphere((0.0, 1.0, 0.0), 1.0, nu=48, nv=24)
    verts = np.concatenate([
        _mesh_to_vertices(ground),
        _mesh_to_vertices(ball, normals=_sphere_smooth_normals(
            ball, (0.0, 1.0, 0.0)), uvs=_sphere_uvs(ball, (0.0, 1.0, 0.0)))])
    mtlids = np.asarray([0, 0] + [1] * ball.shape[0], np.int32)
    mats = _materials()
    gl, ours = gl_materials([mats[0], mats[3]])
    gl[1]['pbrMetallicRoughness'].update(
        metallicFactor=0.0, roughnessFactor=1.0,
        metallicRoughnessTexture={'index': 0})
    ours[1] = (ours[1][0], (0.0, 0), (1.0, 0))
    meshes = [gl_primitives(verts, mtlids, np.eye(4), np.uint16)]
    return meshes, [{'mesh': 0}], gl, ours, [png]


def highpoly_asset():
    '''cornell_highpoly (101,782 faces) as three meshes of one node each,
    uint32 indices, the blob interleaved.'''
    parts = _blob_parts(320, 160)
    meshes = [gl_primitives(v, m, np.eye(4), np.uint32, interleave=i == 1)
              for i, (v, m) in enumerate(parts)]
    gl, ours = gl_materials(_materials())
    return meshes, [{'mesh': i} for i in range(3)], gl, ours


def write_ply(path, v, faces, binary):
    '''A PLY of vertex positions [V, 3] float32 and triangles [F, 3]:
    binary little-endian or ASCII, faces as uchar-counted int lists.'''
    head = (f'ply\nformat {"binary_little_endian" if binary else "ascii"} '
            f'1.0\ncomment chip_smoke\nelement vertex {len(v)}\n'
            f'property float x\nproperty float y\nproperty float z\n'
            f'element face {len(faces)}\n'
            f'property list uchar int vertex_indices\nend_header\n')
    with open(path, 'wb') as f:
        f.write(head.encode())
        if binary:
            rec = np.zeros(len(faces), [('n', 'u1'), ('i', '<i4', 3)])
            rec['n'], rec['i'] = 3, faces
            f.write(np.ascontiguousarray(v, '<f4').tobytes() + rec.tobytes())
        else:
            f.write(''.join(f'{x} {y} {z}\n' for x, y, z in v).encode())
            f.write(''.join(f'3 {a} {b} {c}\n' for a, b, c in faces).encode())


def obj_of_vertices(verts, mtlids):
    '''readobj's dict for [F*3, 8] vertices: one v / vt / vn row a corner,
    usemtl runs named m<id>.'''
    n = len(verts)
    f = np.repeat(np.arange(n, dtype=np.int32).reshape(-1, 3, 1), 3, axis=2)
    runs = [(i, f'm{m}') for i, m in enumerate(mtlids.tolist())
            if i == 0 or m != mtlids[i - 1]]
    return dict(v=verts[:, :3], vt=verts[:, 6:8], vn=verts[:, 3:6], f=f,
                usemtl=runs, mtllib=None)


def load_worker(w, verts, mtlids, mats, images=(), res=RES):
    '''The worker calls of a front-end: model, materials, images, the
    benchmark's ceiling light and world, res^2, the camera, then
    build_tree.  Returns build_tree's seconds (make_scene).'''
    w.load_model(verts, mtlids)
    w.load_materials(mats)
    w.load_images(list(images))
    w.clear_lights()
    light = _ceiling_light()
    world = np.eye(4)
    world[:3, :3], world[:3, 3] = light['axes'], light['pos']
    w.add_light(world, light['color'], light['size'], 'AREA')
    w.set_world_light((0.05, 0.05, 0.05, 1.0), -1)
    w.set_size(res, res)
    w.set_camera(BENCH_CAMERA)
    t0 = time.perf_counter()
    w.build_tree()
    return time.perf_counter() - t0


def _front_render(what, load, spp, want):
    '''worker.init, load(), then spp x worker.render(), the counts at 0
    just before and read just after; fails unless the launches are
    `want`.  Returns (image, seconds to the first image, samples/s of the
    rest, counts).'''
    _zero_counts()
    worker.init()
    t0 = time.perf_counter()
    load()
    worker.render()
    first = worker.get_image()
    t_first = time.perf_counter() - t0
    t1 = time.perf_counter()
    for _ in range(spp - 1):
        worker.render()
    img = worker.get_image()
    sps = (spp - 1) / (time.perf_counter() - t1)
    grew = _counts()
    _need(what, grew, want)
    if img.shape != (RES, RES, 4) or not np.isfinite(img).all() \
            or not np.isfinite(first).all():
        raise AssertionError(f'{what}: image not finite / wrong shape')
    return img, t_first, sps, grew


def _same_image(what, got, ref):
    if not np.array_equal(got, ref):
        d = np.abs(got - ref)
        raise AssertionError(f'{what}: images differ on {int((d > 0).sum())} '
                             f'values, max {d.max():.3e}')


def _front_gltf_monkey(card, tmp):
    '''(a): the monkey asset as .gltf (data URI) and .glb, each through
    readgltf and the worker at 512^2 x 32, against the worker fed
    compose_multiple_meshes of the same primitives.'''
    meshes, nodes, gl, mats = monkey_asset()
    paths = {m: os.path.join(tmp, f'monkey.{m}') for m in ('gltf', 'glb')}
    for mode, path in paths.items():
        write_gltf(path, meshes, nodes, gl, mode=mode)
    want = _expect(path=FRONT_SPP)
    out, read_s = {}, {}
    for mode, path in paths.items():
        def load(path=path, mode=mode):
            t0 = time.perf_counter()
            v, m, got_mats, images = readgltf(path)
            read_s[mode] = time.perf_counter() - t0
            if got_mats != mats or images:
                raise AssertionError(f'readgltf {mode}: materials / images')
            load_worker(worker, v, m, got_mats)
        out[mode] = _front_render(f'gltf monkey {mode}', load, FRONT_SPP, want)
        if mode == 'gltf':
            scene = worker._S.scene
    verts, mtlids = compose_multiple_meshes(composed_inputs(meshes, nodes))
    out['direct'] = _front_render(
        'gltf monkey direct',
        lambda: load_worker(worker, verts, mtlids, mats), FRONT_SPP, want)
    _same_image('gltf vs glb', out['gltf'][0], out['glb'][0])
    _same_image('gltf vs composed', out['gltf'][0], out['direct'][0])
    pt = sobol_block(0, DIMS)
    err = _hold('gltf monkey', 'primary s0',
                _stack(fused.fused_trace_primary(scene, pt, RES, RES)),
                _stack(fused.fused_trace_primary_plain(scene, pt, RES, RES)),
                False)
    nf = int(scene.nfaces)
    print(f'[frontends] {card} | (a) glTF cornell_monkey ({nf} faces, 5 '
          f'primitives, TRS / matrix nodes, uint16 / uint32 indices, one '
          f'byteStride view): readgltf .gltf {read_s["gltf"] * 1e3:.1f} ms, '
          f'.glb {read_s["glb"] * 1e3:.1f} ms; load -> first image '
          f'{out["gltf"][1]:.3f} s (.gltf) / {out["glb"][1]:.3f} s (.glb) / '
          f'{out["direct"][1]:.3f} s (composed arrays); {RES}x{RES} x '
          f'{FRONT_SPP} spp, {out["gltf"][2]:.1f} samples/s after the first; '
          f'.gltf = .glb = composed bit for bit, launches '
          f'{out["gltf"][3]} each')
    return dict(launches=out['gltf'][3], max_abs_err=err,
                readgltf_s=read_s, first_image_s=out['gltf'][1])


def _front_gltf_matball(card, tmp):
    '''(b): matball with its ramp an embedded PNG (metallicRoughness
    texture): the ramp decodes as encoded, the render takes path_kernel
    with a texture atlas, held against its twin.'''
    ramp, png = ramp_png()
    if not np.array_equal(png_codec.decode(png),
                          np.ascontiguousarray(ramp.swapaxes(0, 1))):
        raise AssertionError('_png: the ramp does not decode as encoded')
    meshes, nodes, gl, mats, images = matball_asset(png)
    path = os.path.join(tmp, 'matball.glb')
    write_gltf(path, meshes, nodes, gl, images, mode='glb')
    t0 = time.perf_counter()
    v, m, got_mats, imgs = readgltf(path)
    read_s = time.perf_counter() - t0
    if got_mats != mats or len(imgs) != 1 or not np.array_equal(imgs[0], ramp):
        raise AssertionError('readgltf matball: materials / ramp')
    img, t_first, sps, grew = _front_render(
        'gltf matball', lambda: load_worker(worker, v, m, got_mats, imgs),
        FRONT_SPP, _expect(path=FRONT_SPP))
    scene = worker._S.scene
    if scene.textures.data.shape[0] != 1 or not scene.materials.textured:
        raise AssertionError('gltf matball: no texture atlas in the scene')
    pt = sobol_block(0, DIMS)
    err = _hold('gltf matball', 'primary s0',
                _stack(fused.fused_trace_primary(scene, pt, RES, RES)),
                _stack(fused.fused_trace_primary_plain(scene, pt, RES, RES)),
                True)
    print(f'[frontends] {card} | (b) glTF matball ({int(scene.nfaces)} '
          f'faces, the 64x64 ramp a {len(png)}-byte PNG, bound as '
          f'metallicRoughness): readgltf {read_s * 1e3:.1f} ms, load -> '
          f'first image {t_first:.3f} s, {sps:.1f} samples/s, mean '
          f'{img[..., :3].mean():.5f}, launches {grew}')
    return dict(launches=grew, max_abs_err=err)


def _front_glb_highpoly(card, tmp):
    '''(c): cornell_highpoly as a GLB through the worker: the blocked
    route (5 x 8 launches of each blocked cast), equal to the worker fed
    the composed arrays bit for bit.'''
    meshes, nodes, gl, mats = highpoly_asset()
    path = os.path.join(tmp, 'highpoly.glb')
    write_gltf(path, meshes, nodes, gl, mode='glb')
    mb = os.path.getsize(path) / 1e6
    t0 = time.perf_counter()
    v, m, got_mats, _ = readgltf(path)
    read_s = time.perf_counter() - t0
    n = DEPTH * HIGHPOLY_SPP
    want = _expect(blocked_shade=n, blocked_any=n)
    build = {}

    def load():
        build['s'] = load_worker(worker, v, m, got_mats)
    img, t_first, sps, grew = _front_render('glb highpoly', load,
                                            HIGHPOLY_SPP, want)
    make_s = build['s']
    verts, mtlids = compose_multiple_meshes(composed_inputs(meshes, nodes))
    ref = _front_render('glb highpoly direct',
                        lambda: load_worker(worker, verts, mtlids, mats),
                        HIGHPOLY_SPP, want)[0]
    _same_image('glb highpoly vs composed', img, ref)
    print(f'[frontends] {card} | (c) GLB cornell_highpoly '
          f'({len(v) // 3} faces, {mb:.2f} MB): readgltf {read_s:.3f} s, '
          f'make_scene {make_s:.3f} s, load -> first image {t_first:.3f} s, '
          f'{RES}x{RES} x {HIGHPOLY_SPP} spp at {sps:.2f} samples/s after '
          f'the first; = composed bit for bit, launches {grew}')
    return dict(launches=grew, readgltf_s=read_s, make_scene_s=make_s,
                sps=sps)


def _front_ply_obj(card, tmp):
    '''(d): readply of binary and ASCII PLYs of cornell_highpoly; writeobj
    of cornell_monkey, then worker.load_model(path) with obj_mtlids.'''
    parts = _blob_parts(320, 160)
    corners = np.concatenate([v[:, :3] for v, _ in parts])
    v, faces = np.unique(corners, axis=0, return_inverse=True)
    faces = faces.reshape(-1, 3).astype(np.int32)
    secs = {}
    for binary in (True, False):
        kind = 'binary' if binary else 'ascii'
        path = os.path.join(tmp, f'highpoly_{kind}.ply')
        write_ply(path, v, faces, binary)
        t0 = time.perf_counter()
        obj = readply(path)
        secs[kind] = time.perf_counter() - t0
        if not (np.array_equal(obj['v'], v)
                and np.array_equal(obj['f'][:, :, 0], faces)):
            raise AssertionError(f'readply {kind}: arrays differ')
    (sv, sm), (bv, bm), (xv, xm) = _blob_parts()
    verts = np.concatenate([sv, bv, xv])
    mtlids = np.concatenate([sm, bm, xm])
    path = os.path.join(tmp, 'monkey.obj')
    obj = obj_of_vertices(verts, mtlids)
    t0 = time.perf_counter()
    writeobj(path, obj)  # v, vt, vn and f: the ids go beside the file
    secs['writeobj'] = time.perf_counter() - t0
    ids = obj_mtlids(obj, {f'm{i}': i for i in range(4)})
    t0 = time.perf_counter()
    worker.init()
    worker.load_model(path, ids)
    secs['readobj'] = time.perf_counter() - t0
    if not (np.array_equal(worker._S.vertices, verts)
            and np.array_equal(worker._S.mtlids, mtlids)):
        raise AssertionError('writeobj -> load_model: arrays differ')
    _, grew = _launched(lambda: (worker.build_tree(), worker.render()))
    _need('obj monkey render', grew, _expect(path=1))
    print(f'[frontends] {card} | (d) readply cornell_highpoly ({len(v)} '
          f'vertices, {len(faces)} faces): binary {secs["binary"]:.3f} s, '
          f'ASCII {secs["ascii"]:.3f} s, arrays exact; writeobj '
          f'cornell_monkey {secs["writeobj"]:.3f} s, load_model(path) '
          f'(readobj) {secs["readobj"]:.3f} s with obj_mtlids\' ids, '
          f'vertices and ids exact, one render: {grew}')
    return dict(secs=secs, launches=grew)


def _ceiling_lamp():
    '''The benchmark's ceiling light as a Blender AREA lamp: (world,
    color, energy in watts, size).  light_to_pool_entry takes half the
    size and gives L = P / (4 pi s^2), the benchmark's radiance.'''
    light = _ceiling_light()
    world = np.eye(4)
    world[:3, :3], world[:3, 3] = light['axes'], light['pos']
    half = light['size']
    return world, (1.0, 1.0, 1.0), \
        light['color'][0] * 4.0 * np.pi * half ** 2, 2.0 * half


# the Principled socket values of the Blender scene's two materials
BLENDER_MATERIALS = {
    name: dict(zip(PRINCIPLED_SOCKETS, ((*base, 1.0), 0.0, rough, 0.5, 0.4,
                                        0.0, 0.0, 0.4, 0.0, 0.5, 0.0, 1.45)))
    for name, (base, rough) in (('white', _CORNELL_MATERIALS_SPEC[0]),
                                ('glossy', _CORNELL_MATERIALS_SPEC[3]))}


def blender_objects(nu=59, nv=9):
    '''The Blender checks' two mesh objects, each (name, [F*3, 8]
    vertices in its own frame, world, material name): the room (the
    cornell shell and the box, identity world) and the blob (a smooth
    sphere of 2 * nu * (nv - 1) triangles, its world a translation).'''
    (sv, _), (bv, _), (xv, _) = _blob_parts(nu, nv)
    world = gl_matrix.translate((0.0, 1.3, 0.2))
    blob = bv.copy()
    blob[:, :3] -= np.float32([0.0, 1.3, 0.2])
    return [('Room', np.concatenate([sv, xv]), np.eye(4), 'white'),
            ('Blob', blob, world, 'glossy')]


def blender_scene(nu=59, nv=9):
    '''sync_worker's arguments for the Blender checks' scene, through the
    engine's helpers: the two materials (principled_to_material), no
    image, the two objects, a background (world_background) and the
    ceiling lamp (light_to_pool_entry).'''
    names = list(BLENDER_MATERIALS)
    meshes = [(v[:, 0:3].reshape(-1, 3, 3), v[:, 3:6].reshape(-1, 3, 3),
               v[:, 6:8].reshape(-1, 3, 2), world, names.index(m))
              for _, v, world, m in blender_objects(nu, nv)]
    world, color, energy, size = _ceiling_lamp()
    return ([principled_to_material(BLENDER_MATERIALS[n]) for n in names],
            [], meshes, world_background((0.05, 0.05, 0.05, 1.0), 1.0),
            [light_to_pool_entry(world, color, energy, 'AREA', size / 2)])


def final_render(w, sync, res=RES, spp=FRONT_SPP):
    '''The engine's final render on worker `w` (the module or a
    DaemonModule over it): init, sync_worker, res^2, the camera, spp x
    render() with render_preview() after the first, then every
    RENDER_PASSES image.  Returns (passes, samples/s).'''
    w.init()
    sync_worker(w, *sync)
    w.set_size(res, res)
    w.set_camera(BENCH_CAMERA)
    w.synchronize()
    t0 = time.perf_counter()
    for s in range(spp):
        w.render()
        if s == 0:
            w.render_preview()
    w.synchronize()
    sps = spp / (time.perf_counter() - t0)
    return [w.get_image(pid) for pid in range(len(RENDER_PASSES))], sps


def _front_blender(card):
    '''(e): the Blender engine's calls without bpy, through
    DaemonModule(worker): the sync, the final render (against the same
    calls on this thread), and the viewport ladder.'''
    sync = blender_scene()
    daemon = DaemonModule(worker)
    try:
        (passes, sps_d), grew = _launched(lambda: final_render(daemon, sync))
        _need('blender final render (daemon)', grew,
              _expect(path=FRONT_SPP, shade=1))
        direct, sps = final_render(worker, sync)
        _same_image('blender Combined: daemon vs this thread', passes[0],
                    direct[0])
        for (name, _, _), img in zip(RENDER_PASSES, passes):
            if img.shape != (RES, RES, 4) or not np.isfinite(img).all():
                raise AssertionError(f'blender {name} pass not finite')
        # an error on the daemon thread reaches the caller
        daemon.set_engine('no_such_engine')
        try:
            daemon.render()
        except ValueError:
            pass
        else:
            raise AssertionError('blender: a daemon-thread error was lost')
        daemon.set_engine('path')
        refiner = ViewportRefiner(start_pixel_size=8, max_samples=FRONT_SPP)
        rungs, act = [], {'redraw': True}
        _zero_counts()
        while act['redraw']:
            act = refiner.next_action((RES, RES), BENCH_CAMERA.tobytes())
            t0 = time.perf_counter()
            (w, h), buf = viewport_pass(daemon, act, BENCH_CAMERA)
            rungs.append(((w, h), (time.perf_counter() - t0) * 1e3))
            if (w, h) != (act['width'], act['height']) \
                    or not np.isfinite(buf).all() or not buf.any():
                raise AssertionError(f'blender viewport rung {len(rungs)}: '
                                     f'{(w, h)} for {act}')
        torch.cuda.synchronize()
        vp = _counts()
        _need('blender viewport', vp, _expect(path=len(rungs)))
    finally:
        daemon.stop()
    full = [ms for (wh, ms) in rungs if wh == (RES, RES)]
    print(f'[frontends] {card} | (e) Blender engine calls through '
          f'DaemonModule(worker), two objects, {RES}x{RES}: final render '
          f'{FRONT_SPP} spp + 1 preview, {grew}, {sps_d:.1f} samples/s on '
          f'the daemon thread vs {sps:.1f} on this one, Combined equal bit '
          f'for bit, {len(RENDER_PASSES)} passes finite, a daemon error '
          f'raised here; viewport {len(rungs)} rungs, {vp}: first frame '
          f'{rungs[0][1]:.2f} ms at {rungs[0][0]}, then '
          + ', '.join(f'{ms:.2f} ms at {wh}' for wh, ms in rungs[1:4])
          + f', {RES}^2 rungs median {statistics.median(full):.2f} ms')
    return dict(launches_final=grew, launches_viewport=vp, sps_daemon=sps_d,
                sps_direct=sps, first_frame_ms=rungs[0][1],
                rung_ms=[ms for _, ms in rungs])


def _front_examples(card, tmp, monkey):
    '''(f): the six examples as subprocesses at their defaults (the smoke
    render at 512^2 x 32 on monkey), all at once: exit 0, the smoke
    render's printed mean that of the same render here, the PNGs.'''
    env = dict(os.environ, TMPDIR=tmp)
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(
        [sys.executable, '-m', f'ptina_tpu_torch.examples.{name}',
         *(SMOKE_ARGS if name == 'smoke_render' else ())],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for name in EXAMPLES}
    outs = {}
    try:
        for name, p in procs.items():
            out, err = p.communicate(timeout=EXAMPLE_TIMEOUT)
            outs[name] = out
            if p.returncode != 0:
                raise AssertionError(f'example {name}: exit {p.returncode}\n'
                                     f'{out[-2000:]}\n{err[-4000:]}')
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    img = film_to_image(render(monkey, new_film(RES, RES, device=DEV), 0,
                               spp=SPP)).cpu().numpy()
    want = img[..., :3].mean()
    got = re.search(r' mean (\S+) ', outs['smoke_render']).group(1)
    if np.float32(got) != want:
        raise AssertionError(f'smoke_render printed mean {got}, here {want}')
    pngs = sorted(n for n in os.listdir(tmp) if n.endswith('.png'))
    need = {f'smoke_monkey_{RES}.png', 'coverage_cornell.png', 'matball.png',
            'metropolis_cornell.png', 'refine_f2_final.png'}
    if not need <= set(pngs):
        raise AssertionError(f'examples: PNGs {pngs}')
    for n in pngs:
        with open(os.path.join(tmp, n), 'rb') as f:
            if png_codec.decode(f.read()).ndim != 3:
                raise AssertionError(f'examples: {n}')
    print(f'[frontends] {card} | (f) examples {", ".join(EXAMPLES)}: six '
          f'processes at once, all exit 0 in {wall:.1f} s; smoke_render '
          f'{" ".join(SMOKE_ARGS)} printed mean {got} = this process\'s; '
          f'{len(pngs)} PNGs written and decoded')
    for name in EXAMPLES:
        last = [ln for ln in outs[name].splitlines() if ln.strip()][-1]
        print(f'[frontends] example {name}: {last[:160]}')
    return wall


def phase_frontends(card, scenes):
    '''Phase 11 (module docstring): the scene front-ends through the
    worker, each item with every count at 0 just before it and read just
    after.'''
    t0 = time.perf_counter()
    os.makedirs(os.path.join(ROOT, 'build'), exist_ok=True)
    set_verbosity(0)  # the worker's scene-build lines, one a viewport rung
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, 'build')) as tmp:
        out = {'gltf': _front_gltf_monkey(card, tmp),
               'textured': _front_gltf_matball(card, tmp),
               'glb_blocked': _front_glb_highpoly(card, tmp),
               'ply_obj': _front_ply_obj(card, tmp),
               'blender': _front_blender(card)}
        ex = os.path.join(tmp, 'examples')
        os.makedirs(ex)
        out['examples_s'] = _front_examples(card, ex,
                                            scenes['cornell_monkey'])
    set_verbosity(1)
    print(f'[frontends] phase took {time.perf_counter() - t0:.1f} s')
    return out


# ---------------------------------------------------------------- phase 12

BENCH_TIMEOUT = 600
# each bench metric's counterpart in this script, by CONFIGS' position:
# the timings phase's median of 3 for (scene, the metric's route), phase
# 8's MLT cell ('mlt'), or none (the capacity scene is rendered once
# there, untimed)
BENCH_TWIN = ('cornell_monkey', 'cornell_highpoly', 'cornell_textured',
              'matball', 'envlight', None, 'mlt', 'cornell')


def _bench_row_ok(row):
    v = row.get('value')
    return isinstance(v, (int, float)) and math.isfinite(v) and v > 0 \
        and all(k in row for k in ('unit', 'vs_baseline', 'device', 'route',
                                   'launches', 'samples', 'host')) \
        and row['launches'] == expected_launches(row['route'],
                                                 row['samples'])


def _cpu_probe_ms():
    '''The median of 3 timings of a fixed pure-Python loop, in ms: how
    fast the host's CPU runs this process's interpreter now.'''
    def once():
        t0 = time.perf_counter()
        sum(i * i for i in range(1_000_000))
        return (time.perf_counter() - t0) * 1e3
    return statistics.median(once() for _ in range(3))


def _host_facts():
    '''The host as this process sees it: CPUs, the ones it may run on,
    torch's threads and the CPU probe.'''
    return (f'{os.cpu_count()} CPUs, {len(os.sched_getaffinity(0))} '
            f'usable, torch threads {torch.get_num_threads()}, CPU probe '
            f'{_cpu_probe_ms():.1f} ms')


def _host_text(h):
    return (f'host cpu {h["cpu_seconds"]:.3f} s, {h["gc_collections"]} gc, '
            f'{h["device_mallocs"]} cudaMalloc')


def _bench_busy(card, cfg):
    '''One bench window of a megakernel configuration in this process and
    the device time of its frames, each frame queued behind a spin
    (_queued_us): the window's busy share.'''
    scene = cfg.scene(device=DEV)
    timed = time_render(scene, cfg.res, cfg.spp)
    check_launches(cfg.route, timed)
    film = new_film(cfg.res, cfg.res, device=DEV)
    dev_s = sum(_queued_us(lambda k=k: render(scene, film, k * cfg.spp,
                                               spp=cfg.spp))
                for k in range(timed.samples // cfg.spp)) / 1e6
    print(f'[bench] {card} | {cfg.metric} in this process: '
          f'{timed.value:.3f} {cfg.unit} over {timed.samples} in '
          f'{timed.seconds:.4f} s; its frames\' device time {dev_s:.4f} s '
          f'-> window busy {100 * dev_s / timed.seconds:.1f}%; '
          f'{_host_text(timed.host)}')


def _bench_host(card, cfg, row):
    '''One bench window of a blocked configuration in this process; its
    host counters beside the subprocess line's.'''
    timed = time_render(cfg.scene(device=DEV), cfg.res, cfg.spp)
    check_launches(cfg.route, timed)
    for who, v, n, sec, h in (
            ('bench process', row['value'], row['samples'], row['seconds'],
             row['host']),
            ('this process', timed.value, timed.samples, timed.seconds,
             timed.host)):
        print(f'[bench] {card} | {cfg.metric}, {who}: {v:.3f} {cfg.unit} '
              f'over {n} in {sec:.4f} s, {1e3 * sec / n:.1f} ms wall and '
              f'{1e3 * h["cpu_seconds"] / n:.1f} ms host CPU a sample; '
              f'{_host_text(h)}')


def phase_bench(card, sps, mlt_mps):
    '''Phase 12 (module docstring): python -m ptina_tpu_torch.bench as a
    subprocess; its eight metric lines in CONFIGS order, each beside this
    script's number for the same cell; then the megakernel windows' busy
    share and highpoly's host counters in this process.  Returns
    {metric: line}.'''
    t0 = time.perf_counter()
    print(f'[bench] host: {_host_facts()}')
    r = subprocess.run([sys.executable, '-m', 'ptina_tpu_torch.bench'],
                       cwd=ROOT, capture_output=True, text=True,
                       timeout=BENCH_TIMEOUT)
    for line in r.stdout.splitlines():
        print(f'[bench] {line}')
    if r.returncode != 0:
        raise AssertionError(f'ptina_tpu_torch.bench exit {r.returncode}:\n'
                             f'{r.stderr[-4000:]}')
    rows = [json.loads(line) for line in r.stdout.splitlines()
            if line.startswith('{')]
    names = [row.get('metric') for row in rows]
    if names != [c.metric for c in BENCH_CONFIGS]:
        raise AssertionError(f'bench metric lines {names}')
    bad = [row['metric'] for row in rows if not _bench_row_ok(row)]
    if bad:
        raise AssertionError(f'bench lines malformed or off their route: '
                             f'{bad}')
    for cfg, twin, row in zip(BENCH_CONFIGS, BENCH_TWIN, rows):
        ref = mlt_mps if twin == 'mlt' else sps.get((twin, cfg.route))
        beside = (f'this script {ref:.3f} ({row["value"] / ref:.3f}x)'
                  if ref else 'not timed in this script')
        print(f'[bench] {card} | {row["metric"]}: {row["value"]} '
              f'{row["unit"]} over {row["samples"]} in '
              f'{row["seconds"]:.4f} s, {row["route"]}; {beside}; '
              f'{_host_text(row["host"])}')
    for cfg, twin, row in zip(BENCH_CONFIGS, BENCH_TWIN, rows):
        if cfg.route == 'megakernel':
            _bench_busy(card, cfg)
        elif cfg.route == 'blocked wavefront' and twin:
            _bench_host(card, cfg, row)
    print(f'[bench] host: {_host_facts()}')
    print(f'[bench] phase took {time.perf_counter() - t0:.1f} s')
    return {row['metric']: row for row in rows}


def main():
    card = phase_device()
    phase_sqrt(card)
    ptxas = phase_build()
    face_path = _print_face_path(card)
    scenes = {name: make() for name, (make, _) in SCENES.items()}
    tables = {k: scenes[k] for k in WAVEFRONT_SCENES}
    tables['random_2504'] = _random_table(np.random.RandomState(3), 2500)
    t0 = time.perf_counter()
    highpoly = cornell_highpoly(device=DEV)
    print(f'[scene] cornell_highpoly: {int(highpoly.nfaces)} faces, '
          f'{highpoly.face_coef.shape[0]} padded, '
          f'{highpoly.block_bounds.shape[0]} blocks, {_tree(highpoly)}, '
          f'built in {time.perf_counter() - t0:.2f} s')
    errs = phase_kernels(tables, highpoly)
    path_err, rays_err = phase_megakernel(scenes)
    errs['path'] = {'max_abs_err': path_err}

    counts = phase_main(scenes, highpoly)
    phase_capacity()
    phase_golden(scenes)
    kt, pk, bounds, rays_head, sps = phase_timings(card, scenes, tables,
                                                   highpoly)
    eng = phase_engines(card, scenes, highpoly)
    grad = phase_grad(card, scenes, highpoly)
    scale = phase_scale(card, scenes, highpoly)
    front = phase_frontends(card, scenes)
    bench_rows = phase_bench(card, sps, eng['mlt']['mps'])

    # launches per sample of each kernel's route: the dense tree casts on
    # the wavefront (fused=False) scenes, the megakernel on the five, the
    # blocked casts on cornell_highpoly; the flat casts are table level
    per_sample = {
        'shade': counts['wavefront']['shade'] / (SPP * len(WAVEFRONT_SCENES)),
        'any': counts['wavefront']['any'] / (SPP * len(WAVEFRONT_SCENES)),
        'closest': 0, 'any_flat': 0,
        'path': counts['megakernel']['path'] / (SPP * len(SCENES)),
        'blocked_shade': counts['blocked']['blocked_shade'] / HIGHPOLY_SPP,
        'blocked_any': counts['blocked']['blocked_any'] / HIGHPOLY_SPP}

    # the other engines' launches: preview (one closest cast a sample),
    # brute (one a bounce), none of the occlusion casts
    pm, ph, br = eng['preview_matball'], eng['preview_highpoly'], eng['brute']
    engine_extra = {
        'shade': dict(launches_preview=pm[0], preview_ms=pm[1],
                      launches_brute=br[0],
                      launches_brute_per_sample=br[0] / BRUTE_SPP,
                      brute_ms_per_sample=br[1]),
        'any': dict(launches_preview=0, launches_brute=0),
        'blocked_shade': dict(launches_preview=ph[0], preview_ms=ph[1]),
        'blocked_any': dict(launches_preview=0)}
    # a gradient call (1 spp): the pair on cornell_monkey, the wavefront
    # (_trace_diff=False) on it, the blocked route on cornell_highpoly
    for k in ('shade', 'any'):
        engine_extra[k].update(launches_grad_pair=grad['pair'][k],
                               launches_grad_wavefront=grad['wavefront'][k])
    for k in ('blocked_shade', 'blocked_any'):
        engine_extra[k]['launches_grad_blocked'] = grad['blocked'][k]

    def scale_launches(k):
        '''Each phase-10 item's launches of kernel k.'''
        bands = {f'bands_{route}': v['launches'].get(k, 0)
                 for route, v in scale['bands'].items()}
        return {'spb_render': scale['spb'].get(k, 0), **bands,
                'grad_sharded': scale['grad']['launches'].get(k, 0),
                'lbvh_oracle': scale['lbvh']['closest'] * (k == 'closest')}

    def front_launches(k):
        '''Each phase-11 item's launches of kernel k.'''
        b = front['blender']
        return {'gltf_monkey': front['gltf']['launches'][k],
                'gltf_matball': front['textured']['launches'][k],
                'glb_highpoly': front['glb_blocked']['launches'][k],
                'obj_monkey': front['ply_obj']['launches'][k],
                'blender_final': b['launches_final'][k],
                'blender_viewport': b['launches_viewport'][k]}

    def bench_launches(k, key):
        '''Kernel k's launches in each bench line that has any: in the
        timed window (key 'launches') or in all the metric's work
        ('launches_all').'''
        return {m: row[key][k] for m, row in bench_rows.items()
                if row[key][k]}

    def entry(k, source, launches, ms, plain_ms, call_ms, bound, **extra):
        return {'name': f'{k}_kernel', 'route': 'cuda', 'source': source,
                'replaces': REPLACES[k], 'launches': launches,
                'launches_per_sample': per_sample[k],
                'launches_scale': scale_launches(k),
                'launches_frontends': front_launches(k),
                'launches_bench': bench_launches(k, 'launches'),
                'launches_bench_all': bench_launches(k, 'launches_all'),
                **errs[k], 'ms': ms,
                'plain_ms': plain_ms, 'bound_ms': bound[0],
                'bound_by': bound[1], 'library_ms': None, 'call_ms': call_ms,
                'ptxas': ptxas.get(f'{k}_kernel', ''), **extra}

    def cast_entry(k, source, launches, scene, **extra):
        return entry(k, source, launches, *kt[scene][k][:3],
                     bounds[scene][k], **extra)
    # the tree casts: cornell_monkey's numbers, and every table's
    dense = [k for k in kt if k != 'cornell_highpoly']

    def pair_keys(k):
        '''A dense kernel's times, bounds, ceilings and needed and
        passing pairs on every table.'''
        return dict(
            ms_by_scene={t: kt[t][k][0] for t in dense},
            plain_ms_by_scene={t: kt[t][k][1] for t in dense},
            call_ms_by_scene={t: kt[t][k][2] for t in dense},
            bound_ms_by_scene={t: bounds[t][k][0] for t in dense},
            ceiling_ms_by_scene={t: bounds[t]['ceiling'][k] for t in dense},
            pairs_by_scene={t: bounds[t]['pairs'][k][0] for t in dense},
            sign_pass_pairs_by_scene={t: bounds[t]['pairs'][k][1]
                                      for t in dense})
    kernels = [cast_entry(
        k, KERNEL_SOURCE, counts['wavefront'][k], 'cornell_monkey',
        bound_ms_all_faces_by_scene={t: bounds[t]['all_faces'][k]
                                     for t in dense},
        visits_by_scene={t: bounds[t]['visits'][k] for t in dense},
        **pair_keys(k), **engine_extra[k])
        for k in ('shade', 'any')]
    m = eng['mlt']
    kernels.append(entry(
        'path', PATH_SOURCE, counts['megakernel']['path'], *pk['cornell'],
        bounds['path']['cornell'],
        ms_by_scene={k: v[0] for k, v in pk.items()},
        plain_ms_by_scene={k: v[1] for k, v in pk.items()},
        bound_ms_by_scene={k: v[0] for k, v in bounds['path'].items()},
        bound_ms_all_faces_by_scene=bounds['path_all_faces'],
        ceiling_ms_by_scene=bounds['path_ceiling'],
        pairs_by_scene={k: v[0] for k, v in bounds['path_pairs'].items()},
        sign_pass_pairs_by_scene={k: v[1] for k, v in
                                  bounds['path_pairs'].items()},
        visits_per_cast_by_scene=bounds['path_visits'],
        launches_mlt=m['launches'], launches_mlt_step=m['launches'] / MLT_STEPS,
        uniforms_ms=m['ms'], uniforms_plain_ms=m['plain_ms'],
        uniforms_call_ms=m['call_ms'], uniforms_bound_ms=m['bound'][0],
        uniforms_bound_by=m['bound'][1], uniforms_ceiling_ms=m['ceiling'],
        uniforms_chains=MLT_CHAINS,
        mlt_mutations_per_s=m['mps'], mlt_step_ms=m['step_ms'],
        mlt_step_wall_ms=m['step_wall_ms'],
        max_abs_err_worker=eng['worker_err'],
        launches_grad_pair=grad['pair']['path'],
        launches_grad_wavefront=grad['wavefront']['path'],
        max_abs_err_gltf=front['gltf']['max_abs_err'],
        max_abs_err_gltf_textured=front['textured']['max_abs_err'],
        launches_rays_head=counts['rays_head']['path'],
        rays_head_ms_by_scene=rays_head,
        max_abs_err_rays_head=rays_err))
    # the flat casts: cornell's numbers (as in the first slices), and
    # every table's
    kernels += [cast_entry(
        k, KERNEL_SOURCE, counts['table'][k], 'cornell',
        ms_monkey=kt['cornell_monkey'][k][0],
        plain_ms_monkey=kt['cornell_monkey'][k][1],
        bound_ms_monkey=bounds['cornell_monkey'][k][0],
        **pair_keys(k),
        **({'sass_face_path_instructions': face_path}
           if k == 'closest' else {}))
        for k in ('closest', 'any_flat')]
    blocked_extra = {'blocked_shade': dict(
        launches_blocked_closest=counts['blocked_closest']['blocked_shade']),
        'blocked_any': {}}
    hp = bounds['cornell_highpoly']
    kernels += [cast_entry(k, BLOCKED_SOURCE, counts['blocked'][k],
                           'cornell_highpoly', ceiling_ms=hp['ceiling'][k],
                           pairs=hp['pairs'][k][0],
                           sign_pass_pairs=hp['pairs'][k][1],
                           **engine_extra[k], **blocked_extra[k])
                for k in ('blocked_shade', 'blocked_any')]
    print(card)
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
