"""The max-clique and MIS goldens of the port's card smoke, made by the JAX
package.

Run as a script, it solves both full-size runs of ``chip_smoke.py`` with the
JAX package on the CPU and writes ``src/repro_torch/data/golden_clique.json``:

  PYTHONPATH=src python tests/test_torch_golden_clique.py

* max clique on ``p_hat_like(n=300, density=0.325, seed=0)`` (edge density
  0.2456, the size class of DIMACS p_hat300-1), 128 workers, every other
  knob at its default: an exact solve (139 supersteps);
* MIS on the paper's graph G(600, 4/599, seed 0), whose complement is the
  dense branching graph (W = 19), 128 workers, bounded to 64 supersteps.

``chip_smoke.py`` reads the file as package data, so the port's solves on
the card are held against the JAX package without importing it.  Run as a
test, it checks that the JAX package still reproduces the file and that
the port's graph generators build the same graphs.
"""

import json
import pathlib

import numpy as np

from repro.api import SolveConfig, SolverSession
from repro.graphs import generators as jgen
from repro_torch.graphs import generators as tgen

OUT = (
    pathlib.Path(__file__).resolve().parent.parent
    / "src" / "repro_torch" / "data" / "golden_clique.json"
)

RUNS = {
    "max_clique": dict(
        problem="max_clique",
        graph=dict(generator="p_hat_like", n=300, density=0.325, seed=0),
        solve_kw=dict(num_workers=128),
    ),
    "mis": dict(
        problem="mis",
        graph=dict(generator="erdos_renyi", n=600, p=4.0 / 599, seed=0),
        solve_kw=dict(num_workers=128, max_rounds=64),
    ),
}


def build(gen, graph: dict):
    kw = {k: v for k, v in graph.items() if k != "generator"}
    return getattr(gen, graph["generator"])(**kw)


def record(r) -> dict:
    return {
        "best_size": int(r.best_size),
        "best_sol": [int(w) for w in np.asarray(r.best_sol, np.uint32)],
        "rounds": int(r.rounds),
        "nodes_expanded": int(r.nodes_expanded),
        "tasks_transferred": int(r.tasks_transferred),
        "transfer_rounds": int(r.stats.transfer_rounds),
        "transfer_bytes_total": int(r.stats.transfer_bytes_total),
        "overflow": bool(r.stats.overflow),
        "overflow_count": int(r.stats.overflow_count),
    }


def jax_record(run: dict) -> dict:
    g = build(jgen, run["graph"])
    session = SolverSession(problem=run["problem"], config=SolveConfig(**run["solve_kw"]))
    return record(session.solve(g))


def test_jax_reproduces_golden_clique():
    golden = json.loads(OUT.read_text())
    assert sorted(golden) == sorted(RUNS)
    for name, run in RUNS.items():
        assert {k: golden[name][k] for k in run} == run
        assert jax_record(run) == golden[name]["result"], name


def test_port_builds_the_same_graphs():
    for run in RUNS.values():
        jg, tg = build(jgen, run["graph"]), build(tgen, run["graph"])
        assert jg.n == tg.n and (jg.adj == tg.adj).all()


if __name__ == "__main__":
    OUT.parent.mkdir(parents=True, exist_ok=True)
    doc = {name: {**run, "result": jax_record(run)} for name, run in RUNS.items()}
    OUT.write_text(json.dumps(doc, indent=1) + "\n")
    for name, d in doc.items():
        print(f"wrote {OUT} [{name}]: {d['result']}")
