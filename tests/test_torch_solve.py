"""The slice end to end on the CPU: ``SolverSession(device="cpu").solve``
against the JAX package's goldens and live solves.

* every ``solo`` and ``fpt`` entry of ``tests/golden_vc.json`` bit for bit
  (best size and solution, rounds, nodes, transfers, payload bytes);
* live parity with the JAX ``SolverSession.solve`` on fresh graphs;
* cross-resume: the JAX plane runs one chunk, its state goes through the
  flat layout into the port, and both finish identically;
* ``python -m repro_torch.launch.solve --device cpu`` prints the JAX CLI's
  ``[solve]`` lines (wall time aside).
"""

import json
import os
import pathlib
import re
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro.api import SolveConfig as JaxConfig
from repro.api import SolverSession as JaxSession
from repro.core import engine as jax_engine
from repro.core import superstep as jss
from repro.graphs.generators import erdos_renyi
from repro.problems import base as jb
from repro.problems.registry import get_problem
from repro_torch.api import SolveConfig, SolverSession
from repro_torch.core.superstep import worker_state_from_flat
from repro_torch.problems.sequential import verify_cover

ROOT = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = json.loads((ROOT / "tests" / "golden_vc.json").read_text())

FIELDS = (
    "best_size", "rounds", "nodes_expanded", "tasks_transferred", "found",
)
STATS = (
    "overflow", "overflow_count", "control_bytes_per_round", "transfer_rounds",
    "transfer_bytes_total", "transfer_bytes_per_round",
)


def _config(solve_kw: dict) -> dict:
    """The golden's legacy kwargs as SolveConfig fields."""
    kw = dict(solve_kw)
    if "policy_priority" in kw:
        kw["policy"] = "priority" if kw.pop("policy_priority") else "random"
    return kw


def _record(r) -> dict:
    return {
        "best_size": int(r.best_size),
        "best_sol": [int(w) for w in np.asarray(r.best_sol, np.uint32)],
        "rounds": int(r.rounds),
        "nodes_expanded": int(r.nodes_expanded),
        "tasks_transferred": int(r.tasks_transferred),
        "transfer_rounds": int(r.stats.transfer_rounds),
        "transfer_bytes_total": int(r.stats.transfer_bytes_total),
        "overflow": bool(r.stats.overflow),
    }


def _golden_cases():
    cases = [
        pytest.param(c["graph"], _config(c["solve_kw"]), c["result"], id=label)
        for label, c in GOLDEN["solo"].items()
    ]
    f = GOLDEN["fpt"]
    cases.append(
        pytest.param(f["graph"], dict(num_workers=4, mode="fpt", k=f["k"]),
                     f["result"], id="fpt")
    )
    return cases


@pytest.mark.parametrize("graph,cfg,want", _golden_cases())
def test_goldens_on_cpu(graph, cfg, want):
    g = erdos_renyi(graph["n"], graph["p"], graph["seed"])
    r = SolverSession(config=SolveConfig(**cfg), device="cpu").solve(g)
    assert _record(r) == want
    assert verify_cover(g, r.best_sol)
    assert r.stats.reduce_sweeps > 0


def _same_result(jr, tr):
    for name in FIELDS:
        assert getattr(tr, name) == getattr(jr, name), name
    assert (np.asarray(tr.best_sol) == np.asarray(jr.best_sol)).all()
    for name in STATS:
        assert getattr(tr.stats, name) == getattr(jr.stats, name), name


def test_live_parity_with_jax():
    kw = dict(num_workers=6, steps_per_round=4, lanes=2, donate_k=2, chunk_rounds=3)
    jax_session = JaxSession(config=JaxConfig(**kw))
    torch_session = SolverSession(config=SolveConfig(**kw), device="cpu")
    for seed in range(4):
        g = erdos_renyi(44, 0.18, 500 + seed)
        _same_result(jax_session.solve(g), torch_session.solve(g))


def test_cross_resume_from_a_jax_chunk():
    """One JAX chunk, then both packages finish from the same state."""
    g = erdos_renyi(48, 0.25, 77)  # about 30 supersteps
    kw = dict(num_workers=5, steps_per_round=2, chunk_rounds=2)
    spec = get_problem("vertex_cover")
    n, W = g.n, g.W
    cap = 4 * n + 8
    state = jax_engine.make_instance_state(spec, g, kw["num_workers"], cap, W, n + 1)
    plane = jss.build_plane_fn(
        spec, steps_per_round=kw["steps_per_round"], lanes=1,
        explore_impl="fused", chunk_rounds=kw["chunk_rounds"],
    )
    state, done, ran, _ = plane(jb.make_data(spec, g), state)
    assert not bool(done) and int(ran) == kw["chunk_rounds"]
    flat = jss.worker_state_to_flat(jax.device_get(state))

    jr = JaxSession(config=JaxConfig(**kw)).solve(g, initial_state=state)
    tr = SolverSession(config=SolveConfig(**kw), device="cpu").solve(
        g, initial_state=worker_state_from_flat(flat, "cpu")
    )
    _same_result(jr, tr)
    assert tr.rounds > 0 and verify_cover(g, tr.best_sol)


def _solve_lines(module: str, *extra: str) -> list:
    args = ["--graph", "gnp", "--n", "36", "--p", "0.15", "--seed", "4",
            "--workers", "4", "--steps-per-round", "4", "--donate-k", "2"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-m", module, *args, *extra],
        env=env, capture_output=True, text=True, check=True, timeout=300,
    ).stdout
    lines = [ln for ln in out.splitlines() if ln.startswith("[solve]")]
    return [re.sub(r" wall=\S+", "", ln) for ln in lines]


def test_cli_prints_the_jax_solve_line():
    want = _solve_lines("repro.launch.solve")
    got = _solve_lines("repro_torch.launch.solve", "--device", "cpu")
    assert len(want) == 2 and got == want
