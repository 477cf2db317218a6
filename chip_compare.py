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
    around 10 launches queued behind a spinning stream (_queued_ms);
  * shade_kernel / any_kernel: device ms per call of the dense route's
    dispatch.cast_shaded / cast_shadow (an entry point with one signature
    in every tree, whatever its kernels take) at 262,144 seeded random
    rays from inside the cornell box, on the five scenes and a random
    2,504-face table, the same way;
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
closest_kernel's face loop ([sass]; ptxas_by_kernel and face_loop_path
below read both; they need no GPU, no nvcc and no torch, and sass()
returns nothing without cuobjdump).  Prints the card's name and power
limit and, as its last line, one JSON object: per kernel and scene each
turn's ms, the median per tree, and this / other.  Uses only entry points
both trees have.  Exits non-zero without a GPU.
'''

import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

RES, DIMS, SAMPLE, REPS = 512, 32, 9, 10
N_RAYS = 262_144
SCENES = ('cornell', 'cornell_monkey', 'cornell_textured', 'envlight',
          'matball')


# kernel names as nvcc's log gives them, the longer first ('shade_kernel'
# is inside 'blocked_shade_kernel')
KERNEL_NAMES = ('blocked_shade_kernel', 'blocked_any_kernel',
                'closest_kernel', 'any_flat_kernel', 'shade_kernel',
                'any_kernel', 'path_kernel', 'material_rows_kernel',
                'texel_lanes_kernel', 'texel_keys_kernel')


def _instance(line):
    '''The label of a kernel template's instantiation in an nvcc log line
    (its mangled bool template arguments), or None: kBoxes as 'boxes' or
    'two leaves', path_kernel's kRays as 'rays head'.'''
    m = re.search(r'kernelI((?:Lb\d+E)+)E', line)
    if not m:
        return None
    words = []
    for j, v in enumerate(re.findall(r'Lb(\d+)E', m.group(1))):
        if j == 0:
            words.append('boxes' if v == '1' else 'two leaves')
        elif v == '1':
            words.append('rays head')
    return ', '.join(words) + ': '


def ptxas_by_kernel(log):
    '''{kernel: ptxas resource line} from an nvcc -Xptxas -v log (empty
    when a library was loaded, not built); the instantiations of a kernel
    template share its line, each named: the tree kernels' kBoxes
    (path_kernel, shade_kernel and any_kernel: the tree walk with box
    tests, and the one for tables of at most two leaves) and
    path_kernel's rays head.'''
    out, name = {}, None
    for line in log.splitlines():
        if 'entry function' in line:
            name = next((k for k in KERNEL_NAMES if k in line), None)
            inst = _instance(line)
            if name and inst:
                out[name] = out.get(name, '') + ('; ' if name in out else '') \
                    + inst
            elif name:
                out[name] = ''
        elif name and ('stack frame' in line or 'registers' in line):
            sep = '; ' if out[name] and not out[name].endswith(': ') else ''
            out[name] += sep + line.split(':')[-1].strip()
    return out


def sass(lib_path, kernel):
    '''[(address, instruction)] of one kernel (a substring of its mangled
    name) in cuobjdump -sass of a library; [] without cuobjdump.'''
    tool = shutil.which('cuobjdump') or '/usr/local/cuda/bin/cuobjdump'
    if not os.path.exists(tool):
        return []
    out = subprocess.run([tool, '-sass', lib_path], capture_output=True,
                         text=True, check=False, timeout=120).stdout
    code, inside = [], False
    for line in out.splitlines():
        if 'Function : ' in line:
            inside = kernel in line
        m = re.match(r'\s+/\*([0-9a-f]{4,})\*/\s+([^;]*);', line)
        if inside and m:
            code.append((int(m.group(1), 16), m.group(2).strip()))
    return code


def _branch(ins):
    '''(conditional?, target address) of a BRA instruction, else None.'''
    m = re.match(r'(@!?U?P\w+\s+)?BRA(\.\S+)?\s.*?(0x[0-9a-f]+)$', ins)
    return (bool(m.group(1)), int(m.group(3), 16)) if m else None


def _opcode(ins):
    op = ins.split()[1] if ins.startswith('@') else ins.split()[0]
    return op.split('.')[0]


def face_loop_path(code):
    '''One face's common path through a flat kernel's unrolled face loop:
    (instructions a face, {opcode: count a face}), or None where the loop
    is not found.  The loop is the innermost one (a backward BRA with no
    other inside its body) that holds the most LDS.128; each face loads
    its 16 coefficients with 4, so its faces are its LDS.128 / 4.  The
    path walks the body once from its head to its backward branch: a
    conditional forward branch inside the body is taken (it skips what a
    face guards: the hit work of a face no ray of the thread passes, the
    reciprocal of an invalid pair), one whose target lies outside the body
    is not (a rare path laid out after the loop), and an unconditional
    one is followed.  The loop's own step is shared among the faces.'''
    at = {addr: k for k, (addr, _) in enumerate(code)}
    backs = [(at[b[1]], k) for k, (addr, ins) in enumerate(code)
             if (b := _branch(ins)) and b[1] < addr and b[1] in at]
    inner = [(h, e) for h, e in backs
             if not any(h <= h2 and e2 < e for h2, e2 in backs)]

    def lds(h, e):
        return sum(ins.startswith('LDS.128') for _, ins in code[h:e + 1])
    inner = [(h, e) for h, e in inner if lds(h, e) >= 8 and lds(h, e) % 4 == 0]
    if not inner:
        return None
    h, e = max(inner, key=lambda he: lds(*he))
    faces = lds(h, e) // 4
    counts, k = {}, h
    while k <= e:
        addr, ins = code[k]
        op = _opcode(ins)
        counts[op] = counts.get(op, 0) + 1
        b = _branch(ins)
        if k == e or b is None:
            k += 1
        elif b[1] in at and h < at[b[1]] <= e:
            k = at[b[1]]
        elif b[0]:
            k += 1
        else:
            return None
    n = sum(counts.values())
    return n / faces, {op: c / faces for op, c in counts.items()}


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
        '''A random 2,504-face table (its material ids have no
        materials: the casts only).'''
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
