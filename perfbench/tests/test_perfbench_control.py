"""The check fails what it must: the control and each planted fault of a
one-chip cell turn ``correct`` false, through the whole run past the
harness's look for a chip (on the CPU, at a small size)."""

import json

import pytest

from conftest import CELLS, run_tiny, tiny
from perfbench import control

# the number each plant has to move, besides turning correct false
MOVES = {
    "control": "answers_infeasible",
    "answer": "answers_infeasible",
    "unchanged": "lanes_not_stepped",
    "half": "lanes_not_stepped",
    "kernel": "kernel_rows_differ",
}


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("mode", ["sound", *MOVES])
def test_plant_turns_correct_false(cell, mode):
    config = tiny(cell)[0]
    with control.plant(mode, config):
        line, checks = run_tiny(cell, seed=2**32 + 17)
    out = json.loads(line)
    if mode == "sound":
        assert out["correct"] is True
        assert all(v == 0 for v, _ in checks.values())
    else:
        assert out["correct"] is False
        assert checks[MOVES[mode]][0] > checks[MOVES[mode]][1]


def test_an_answer_one_worse_fails_the_optimum_check():
    # graphs small enough that instances finish in the window's first chunk,
    # so claimed optima are there to check however slow the host
    cell = "mc-phat300-lanes64"
    with control.plant("worse", tiny(cell)[0]):
        line, checks = run_tiny(cell, seed=2**32 + 19, n=10)
    out = json.loads(line)
    assert out["attempted"] > 2 and out["correct"] is False
    assert checks["answers_not_optimal"][0] > 0 and checks["answers_infeasible"][0] == 0


def test_plants_are_restored():
    from repro_torch.core import engine, superstep

    before = (engine._extract_result, superstep.superstep)
    config = tiny(CELLS[0])[0]
    for mode in [*MOVES, "worse"]:
        with control.plant(mode, config):
            pass
    assert (engine._extract_result, superstep.superstep) == before
