'''The control (the plain reference in the program's place, computed in
bfloat16, the precision below the configurations' float32) comes out not
correct under each cell's limits, at a test size on the CPU.  On the card
perfbench/control.py reads it at the cells' own size.'''

import torch

from perfbench import run as bench_run
from perfbench.drivers import common, inverse, progressive
from perfbench.harness import manifest as mf

from conftest import TEST_RES, shrink

MAN = mf.manifest()
SEED = 1414213562


def _cell(name):
    cell = bench_run.Cell(MAN, name, SEED)
    cell.device = 'cpu'
    return shrink(cell)


def _fails(values, name):
    lim = mf.limits(name)['compare']
    return any(values[k] > v for k, v in lim.items())


def test_progressive_control_fails():
    cell = _cell('monkey.progressive')
    st = progressive.setup(cell)
    ref = common.reference_scene(cell.inputs, 'cpu')
    ctrl = common.reference_scene(cell.inputs, 'cpu', round_to=torch.bfloat16)
    base = torch.zeros((4, len(st.pixels)))
    args = (st.pixels, st.res, st.start, st.spp, 'cpu')
    r = common.reference_sums(ref, *args, base=base)
    c = common.reference_sums(ctrl, *args, round_to=torch.bfloat16,
                              base=base)
    values = common.frame_numbers(c, r, base, st.spp)
    assert _fails(values, 'monkey.progressive')
    assert _fails(values, 'highpoly.progressive')


def test_inverse_control_fails():
    cell = _cell('monkey.inverse')
    tr = cell.traffic
    mats = inverse.perturbed(cell.inputs['materials'], SEED)
    lr, spp = float(tr['lr']), int(tr['target_spp'])
    target = inverse.reference_target(cell.inputs, TEST_RES, spp, 'cpu')
    ctrl_target = inverse.reference_target(cell.inputs, TEST_RES, spp, 'cpu',
                                           torch.bfloat16)
    args = (cell.inputs, mats, TEST_RES, 5)
    ref = inverse.reference_steps(*args, target, inverse.CHECK_STEPS, lr,
                                  'cpu')
    ctrl = inverse.reference_steps(*args, ctrl_target, inverse.CHECK_STEPS,
                                   lr, 'cpu', round_to=torch.bfloat16)
    assert _fails(inverse.step_numbers(ctrl, ref, lr), 'monkey.inverse')

