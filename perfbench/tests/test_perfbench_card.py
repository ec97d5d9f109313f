"""On the card: each cell runs through ``perfbench/run.py`` with a short
window and comes out correct."""

import json
import subprocess
import sys

import pytest

from conftest import CELLS, ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(cuda_device, cell):
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", cell, "--seed",
                          "2147483660", "--seconds", "3", "--trace", "0"],
                         capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"] is True
