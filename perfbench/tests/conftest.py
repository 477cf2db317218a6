'''Fixtures of the harness's CPU tests: the repository root on sys.path,
a run of a cell on the CPU at a test size, and the card check of the
`cuda`-marked tests (decided in a fixture, never at import).'''

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TEST_RES = 8


def shrink(cell):
    '''A cell cut to the test size: the film's side TEST_RES.'''
    cell.config = dict(cell.config, res=TEST_RES)
    return cell


@pytest.fixture
def tiny_run(monkeypatch, capsys):
    '''run(workload, seed, trace=0) -> the parsed last line of a run of the
    cell through run.main on the CPU at TEST_RES^2, through the program's
    plain code (perfbench.run.main(device='cpu') skips the card check).'''
    from perfbench import run as bench_run
    init = bench_run.Cell.__init__

    def small(self, man, name, seed):
        init(self, man, name, seed)
        shrink(self)

    monkeypatch.setattr(bench_run.Cell, '__init__', small)

    def go(workload, seed, seconds=0.0):
        bench_run.main(['--workload', workload, '--seed', str(seed),
                        '--seconds', str(seconds), '--trace', '0'],
                       device='cpu')
        lines = capsys.readouterr().out.strip().splitlines()
        return json.loads(lines[-1])
    return go


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card (torch.cuda.is_available() is '
                    'false)')
