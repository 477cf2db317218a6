'''
The readings a cell's limits are set from (not run by the benchmark's own
runs): on the card, at the cell's own size, for each seed, the numbers
that decide `correct` for

  * the program: what its timed entry produces for that seed (the two
    progressive cells: frames 0 and 2 of the loop, frame 2 on the film
    the first two left; the inverse cell: set-up's checked steps, and the
    last step of a window of --units steps);
  * the control: the plain reference itself in the program's place,
    computed in bfloat16, the precision below the configuration's
    float32: its vertex table, each bounce's path state and the
    radiance rounded through bfloat16 (perfbench/plainref/path.py);
  * with --faults, the faults planted in the reference (inverse cell):
    half of the pixels left out of the loss's mean, and the image's first
    row altered where it is made.  A step that returns its state
    unchanged reads change_gap 1 without a run.

    python perfbench/control.py --workload monkey.progressive \
        --seeds 1 2 3 [--control-seeds 1 2 3] [--faults] [--units 8]

Prints one JSON line per seed and side.
'''

import argparse
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench import run  # noqa: E402
from perfbench.drivers import common  # noqa: E402
from perfbench.harness import host, manifest as mf  # noqa: E402

BF16 = torch.bfloat16


def _progressive(cell, seeds, control_seeds):
    from perfbench.drivers import progressive as drv
    from ptina_tpu_torch.film import new_film
    for seed in seeds:
        cell.seed = seed
        st = drv.setup(cell)
        film = new_film(st.res, st.res, device=st.dev)
        reads = [drv._frame(st, k, film) for k in range(3)]
        got = drv.at_pixels({0: reads[0], 2: (reads[1], reads[2])},
                            st.pixels, st.res)
        del st.scene, film
        common.free(st.dev)
        ref_scene = common.reference_scene(cell.inputs, st.dev)
        ctrl_scene = common.reference_scene(cell.inputs, st.dev,
                                            round_to=BF16) \
            if seed in control_seeds else None
        sides = {'program': {}, 'control': {}}
        for f, (before, after) in got.items():
            args = (st.pixels, st.res, st.start + f * st.spp, st.spp, st.dev)
            ref = common.reference_sums(ref_scene, *args, base=before)
            runs = [('program', after)]
            if ctrl_scene is not None:
                runs.append(('control', common.reference_sums(
                    ctrl_scene, *args, round_to=BF16, base=before)))
            for side, val in runs:
                for k, v in common.frame_numbers(val, ref, before,
                                                 st.spp).items():
                    sides[side][k] = max(sides[side].get(k, 0.0), v)
        for side, nums in sides.items():
            if nums:
                print(json.dumps({'seed': seed, 'side': side, **nums}),
                      flush=True)


def _inverse(cell, seeds, control_seeds, faults, units):
    from perfbench.drivers import inverse as drv
    for seed in seeds:
        cell.seed = seed
        st = drv.setup(cell)
        drv.window(st, 0.0, False, units=units)
        got = (st.losses, st.fac0, st.fac1, st.facn)
        del st.scene, st.target
        common.free(st.dev)

        def side(target, round_to=None, fault=None):
            args = (cell.inputs, st.materials, st.res)
            steps = drv.reference_steps(*args, st.start, target,
                                        len(st.losses), st.lr, st.dev,
                                        round_to, fault)
            last = drv.reference_last(*args, st.last, target, st.lr, st.dev,
                                      round_to, fault)
            return steps, last
        target = drv.reference_target(cell.inputs, st.res, st.target_spp,
                                      st.dev)
        ref = side(target)
        runs = [('program', (got, st.last))]
        if seed in control_seeds:
            runs.append(('control', side(drv.reference_target(
                cell.inputs, st.res, st.target_spp, st.dev, BF16), BF16)))
            if faults:
                for fault in ('half', 'row'):
                    runs.append((f'fault:{fault}', side(target,
                                                        fault=fault)))
        for name, (steps, last) in runs:
            print(json.dumps({'seed': seed, 'side': name,
                              **drv.step_numbers(steps, ref[0], st.lr),
                              **drv.last_numbers(last, ref[1], st.lr),
                              'losses': steps[0], 'last_loss': last[0],
                              'last_sample': last[1]}), flush=True)
        common.free(st.dev)


def main():
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', type=int, nargs='+', required=True)
    p.add_argument('--control-seeds', type=int, nargs='*', default=())
    p.add_argument('--faults', action='store_true')
    p.add_argument('--units', type=int, default=8,
                   help='the inverse cell\'s window steps before its last')
    a = p.parse_args()
    man = mf.manifest()
    cell = run.Cell(man, a.workload, a.seeds[0])
    cell.device = 'cuda'
    host.require_cards(cell.workload['chips'])
    print(json.dumps({'card': host.card_line()}), flush=True)
    kind = cell.traffic['kind']
    if kind == 'progressive':
        _progressive(cell, a.seeds, set(a.control_seeds))
    elif kind == 'inverse':
        _inverse(cell, a.seeds, set(a.control_seeds), a.faults,
                 a.units)
    else:
        raise SystemExit(f'no readings for traffic kind {kind!r}')


if __name__ == '__main__':
    main()
