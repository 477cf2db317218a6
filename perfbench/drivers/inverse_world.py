'''
Environment-map recovery, closed loop: optimisation steps of the
program's diff.inverse_texture_step (the loss, its gradient in the
texture atlas, whose texture `world_tex` is the world's equirect map,
and one SGD step on it) toward a target image, the sample index
advancing each step and the loss read on the host each step; after each
step the loop clips the atlas to the traffic's `clip` range, as a
projected-gradient light fit does.  The target is the program's render
of the configuration's published environment at the traffic's
target_spp, made in set-up; the start map draws every texel from the
seed as U(start), grey in RGB, alpha 1.

Set-up, the window and the check are inverse_texture.py's, on this
scene and these bounds: set-up drives the first CHECK_STEPS steps
through the window's own call and keeps each step's loss and the atlas
after the first and the last of them; the window keeps the atlas before
and after its own last step and that step's loss; the plain reference
(perfbench/plainref) makes its own target, follows set-up's steps with
autograd through its wavefront into its atlas in float32 with TF32 off,
and takes one step of its own from the atlas the window's last step
started from; the gaps are inverse_texture.step_numbers' and
last_numbers' (each loss as the gap over the reference's, the gradients
and the change as ||got - ref|| / ||ref|| over the atlas).

The readings the cell's limits are set from (not run by the benchmark's
own runs), on the card at the cell's own size, one JSON line per seed
and side:

    python -m perfbench.drivers.inverse_world --workload envmap.inverse \
        --seeds 1 2 3 [--control-seeds 1 2] [--faults] [--units 2]

the program, the control (the reference in bfloat16) and, with
--faults, the faults planted in the reference: `half`, `row`,
`texel_shift` and `unchanged` (inverse_texture.py's).
'''

import contextlib
import math
import time

import numpy as np
import torch

from perfbench.drivers import common, inverse
from perfbench.drivers.inverse import CHECK_STEPS, START_STEPS, TARGET_START
from perfbench.drivers.inverse_texture import (_atlas, _float32_matmuls,
                                               last_numbers, step_numbers)

PATH = ('textures', 'data')


def projected(data, lo, hi):
    '''The atlas clipped to [lo, hi].'''
    return torch.clamp(data, lo, hi)


def start_map(inputs, seed, lo, hi):
    '''[H, W, 4] float32, the published environment's shape: every texel
    U(lo, hi) from the seed, grey in RGB, alpha 1.  Raises ValueError for
    a configuration with no textured world.'''
    tex = inputs.get('world_tex', -1)
    if tex < 0 or not inputs.get('images'):
        raise ValueError('inverse_world: the configuration has no textured '
                         'world to recover')
    h, w = np.asarray(inputs['images'][tex]).shape[:2]
    grey = np.random.default_rng([seed, 4]).uniform(
        lo, hi, (h, w, 1)).astype(np.float32)
    return np.concatenate([grey, grey, grey, np.ones_like(grey)], axis=2)


def program_scene(inputs, dev, images):
    '''The program's scene (ptina_tpu_torch.scene.make_scene) from the
    harness's host inputs, with the atlas of `images` and the world on
    texture world_tex.'''
    from ptina_tpu_torch.scene import make_scene
    return make_scene(inputs['vertices'], inputs['mtlids'],
                      materials=inputs['materials'], images=images,
                      lights=inputs['lights'], cam_pers=inputs['cam_pers'],
                      world_fac=inputs['world_fac'],
                      world_tex=inputs['world_tex'], device=dev)


def reference_scene(inputs, dev, images, round_to=None):
    from perfbench.plainref.scene import make_scene
    return make_scene(inputs['vertices'], inputs['mtlids'],
                      inputs['materials'], inputs['lights'],
                      inputs['cam_pers'], world_fac=inputs['world_fac'],
                      images=images, world_tex=inputs['world_tex'],
                      device=dev, round_to=round_to)


def setup(cell):
    from ptina_tpu_torch import diff
    from ptina_tpu_torch.engine.path import render
    from ptina_tpu_torch.film import new_film
    from ptina_tpu_torch.scene import with_tensor
    st = inverse.State()
    # first, so that a program without the step fails at once
    st.step, st.with_tensor = diff.inverse_texture_step, with_tensor
    st.cell, st.dev = cell, cell.device
    tr = cell.traffic
    st.res, st.lr = int(cell.config['res']), float(tr['lr'])
    st.lo, st.hi = (float(v) for v in tr['clip'])
    st.start = cell.seed % START_STEPS
    st.target_spp = int(tr['target_spp'])
    st.map0 = start_map(cell.inputs, cell.seed, *tr['start'])
    published = program_scene(cell.inputs, st.dev, cell.inputs['images'])
    film = render(published, new_film(st.res, st.res, device=st.dev),
                  TARGET_START, spp=st.target_spp)
    st.target = inverse._image(film).contiguous()
    del published, film
    st.scene = program_scene(cell.inputs, st.dev, [st.map0])
    st.tex0 = _atlas(st.scene)
    st.losses, st.k = [], 0
    for k in range(CHECK_STEPS):
        st.losses.append(_step(st))
        if k == 0:
            st.tex1 = _atlas(st.scene)
    st.texn = _atlas(st.scene)
    return st


def _step(st):
    '''One step of the loop: the program's step, then the projection.'''
    scene, loss = st.step(st.scene, st.target, st.start + st.k, spp=1,
                          lr=st.lr)
    st.scene = st.with_tensor(scene, PATH, projected(scene.textures.data,
                                                     st.lo, st.hi))
    st.k += 1
    return loss.item()


def window(st, seconds, traced, units=None):
    '''Steps until `seconds` have passed (or, given, `units` steps).'''
    from torch.profiler import record_function
    steps, failed = 0, 0
    split = inverse._Split(st.dev) if traced else None
    with common.kernel_events(traced) as ev, \
            (split or contextlib.nullcontext()):
        t0 = time.perf_counter()
        while True:
            before = st.scene.textures.data  # a step makes a new tensor
            with record_function('step'):
                loss = _step(st)
            failed += not math.isfinite(loss)
            steps += 1
            if (steps >= units if units is not None
                    else time.perf_counter() - t0 >= seconds):
                break
        elapsed = time.perf_counter() - t0
    st.last = (loss, st.start + st.k - 1, before.detach().cpu().clone(),
               _atlas(st.scene))
    out = dict(attempted=steps, failed=failed, units=steps,
               steps=steps, window_s=elapsed)
    out.update(common.kernel_readings(ev))
    if split and split.fwd:
        out['forward_ms'] = float(np.mean(split.fwd))
        out['backward_ms'] = float(np.mean(split.bwd))
    return out


def unit(st):
    def one():
        _step(st)
    return one


def reference_target(inputs, res, target_spp, dev, round_to=None):
    '''[3, res * res] the reference's own target: its render of the
    published environment, target_spp samples from TARGET_START.'''
    scene = reference_scene(inputs, dev, inputs['images'], round_to)
    tgt = common.reference_sums(scene, np.arange(res * res), res,
                                TARGET_START, target_spp, dev,
                                round_to=round_to)
    return (tgt[:3] / tgt[3]).to(dev)


def reference_step(scene, data, target, res, sample, lr, bounds, dev,
                   round_to=None, fault=None):
    '''One step of the reference's loop on the scene's atlas from data:
    (loss, atlas after the SGD step and the projection onto bounds, (lo,
    hi)).  fault: None, 'half', 'row' or 'texel_shift'
    (inverse_texture.reference_step's).'''
    from perfbench.plainref.scene import with_tensor
    leaf = data.detach().to(dev).requires_grad_(True)
    s = with_tensor(scene, PATH, leaf)
    img = inverse._reference_image(s, res, sample, dev, round_to)
    if fault == 'row':
        img = torch.cat([torch.zeros_like(img[:, :res]), img[:, res:]], 1)
    sq = (img - target) ** 2
    if fault == 'half':
        sq = sq[:, : sq.shape[1] // 2]
    loss = torch.mean(sq)
    g, = torch.autograd.grad(loss, leaf)
    if fault == 'texel_shift':
        g = torch.roll(g, 1, dims=1)
    after = projected(leaf.detach() - lr * g, *bounds)
    if round_to is not None:
        after = after.to(round_to).to(torch.float32)
    return float(loss.detach()), after


def reference_steps(inputs, map0, res, start, target, steps, lr, bounds,
                    dev, round_to=None, fault=None):
    '''The plain reference's optimisation from the start map: `steps` SGD
    steps toward `target` (reference_target).  Returns (losses, tex0,
    tex1, texn) on the host.'''
    scene = reference_scene(inputs, dev, [map0], round_to)
    data = scene.textures.data
    texs, losses = [data.detach().cpu().clone()], []
    for k in range(steps):
        loss, data = reference_step(scene, data, target, res, start + k, lr,
                                    bounds, dev, round_to, fault)
        losses.append(loss)
        texs.append(data.cpu().clone())
    return losses, texs[0], texs[1], texs[-1]


def reference_last(inputs, map0, res, last, target, lr, bounds, dev,
                   round_to=None, fault=None):
    '''The reference's step from the atlas the window's last step started
    from (last: the program's (loss, sample, before, after)): (loss,
    sample, before, after) on the host.'''
    _, sample, before, _ = last
    scene = reference_scene(inputs, dev, [map0], round_to)
    loss, after = reference_step(scene, before, target, res, sample, lr,
                                 bounds, dev, round_to, fault)
    return loss, sample, before, after.cpu()


def _sides(st, target, round_to=None, fault=None):
    '''The reference's set-up steps and last step (a side of the check).'''
    inputs, bounds = st.cell.inputs, (st.lo, st.hi)
    steps = reference_steps(inputs, st.map0, st.res, st.start, target,
                            len(st.losses), st.lr, bounds, st.dev, round_to,
                            fault)
    last = reference_last(inputs, st.map0, st.res, st.last, target, st.lr,
                          bounds, st.dev, round_to, fault)
    return steps, last


def check(st, window, limits):
    got = (st.losses, st.tex0, st.tex1, st.texn)
    del st.scene, st.target
    common.free(st.dev)
    _float32_matmuls()
    target = reference_target(st.cell.inputs, st.res, st.target_spp, st.dev)
    ref, last = _sides(st, target)
    return common.judged({**step_numbers(got, ref, st.lr),
                          **last_numbers(st.last, last, st.lr)}, limits)


def readings(cell, seeds, control_seeds, faults, units):
    '''Print the program's, the control's and the faults' numbers for
    each seed (module docstring), a line as each side is done.  The
    reference's targets depend on no seed and are made once.'''
    import json
    t0 = time.perf_counter()
    targets = {}

    def target_of(st, round_to=None):
        if round_to not in targets:
            targets[round_to] = reference_target(
                cell.inputs, st.res, st.target_spp, st.dev, round_to)
        return targets[round_to]
    for seed in seeds:
        cell.seed = seed
        st = setup(cell)
        window(st, 0.0, False, units=units)
        got = (st.losses, st.tex0, st.tex1, st.texn)
        del st.scene, st.target
        common.free(st.dev)
        _float32_matmuls()
        target = target_of(st)
        ref = _sides(st, target)

        def show(name, steps, last):
            print(json.dumps({'seed': seed, 'side': name,
                              **step_numbers(steps, ref[0], st.lr),
                              **last_numbers(last, ref[1], st.lr),
                              'losses': steps[0], 'last_loss': last[0],
                              'last_sample': last[1],
                              'elapsed_s': time.perf_counter() - t0}),
                  flush=True)
        show('program', got, st.last)
        if seed in control_seeds:
            show('control', *_sides(st, target_of(st, torch.bfloat16),
                                    torch.bfloat16))
            if faults:
                loss, sample, before, _ = st.last
                show('fault:unchanged', (got[0], got[1], got[1], got[1]),
                     (loss, sample, before, before))
                for fault in ('half', 'row', 'texel_shift'):
                    show(f'fault:{fault}', *_sides(st, target, fault=fault))
        common.free(st.dev)


def main():
    import argparse
    import json
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    from perfbench import run
    from perfbench.harness import host, manifest as mf
    p = argparse.ArgumentParser(description='The readings of an '
                                'environment recovery cell\'s limits '
                                '(module docstring).')
    p.add_argument('--workload', default='envmap.inverse')
    p.add_argument('--seeds', type=int, nargs='+', required=True)
    p.add_argument('--control-seeds', type=int, nargs='*', default=())
    p.add_argument('--faults', action='store_true')
    p.add_argument('--units', type=int, default=2,
                   help='the window\'s steps (its last is checked)')
    a = p.parse_args()
    cell = run.Cell(mf.manifest(), a.workload, a.seeds[0])
    cell.device = 'cuda'
    host.require_cards(cell.workload['chips'])
    print(json.dumps({'card': host.card_line()}), flush=True)
    readings(cell, a.seeds, set(a.control_seeds), a.faults, a.units)


if __name__ == '__main__':
    main()
