'''On the card: each cell runs a short window from the command line and
comes out correct (run with `python -m pytest perfbench/tests -m cuda` on
a machine with an NVIDIA card; skips without one).'''

import json
import subprocess
import sys

import pytest

from perfbench.harness import manifest as mf

from conftest import ROOT

pytestmark = pytest.mark.cuda
CELLS = [w['name'] for w in mf.manifest()['workloads']]


@pytest.mark.parametrize('workload', CELLS)
def test_cell_runs_correct(card, workload):
    out = subprocess.run(
        [sys.executable, 'perfbench/run.py', '--workload', workload,
         '--seed', '2236067977', '--seconds', '2', '--trace', '1'],
        cwd=ROOT, capture_output=True, text=True, timeout=600, check=True)
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line['correct'] is True
    assert line['device']['busy_s'] > 0
