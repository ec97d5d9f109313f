"""The n = 300 golden of the port's card smoke, made by the JAX package.

Run as a script, it solves the paper's random family at n = 300 —
G(300, 4/299, seed 0), 64 workers, every other knob at its default — with
the JAX package and writes ``src/repro_torch/data/golden_smoke.json``:

  PYTHONPATH=src python tests/test_torch_golden_smoke.py

``chip_smoke.py`` reads that file as package data, so the port's solve on
the card is held against the JAX package without importing it.  Run as a
test, it checks that the JAX package still reproduces the file.
"""

import json
import pathlib

import numpy as np

from repro.api import SolveConfig, SolverSession
from repro.graphs.generators import erdos_renyi

OUT = (
    pathlib.Path(__file__).resolve().parent.parent
    / "src" / "repro_torch" / "data" / "golden_smoke.json"
)

GRAPH = dict(n=300, p=4.0 / 299, seed=0)
SOLVE_KW = dict(num_workers=64)


def jax_record() -> dict:
    g = erdos_renyi(GRAPH["n"], GRAPH["p"], GRAPH["seed"])
    r = SolverSession(config=SolveConfig(**SOLVE_KW)).solve(g)
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


def test_jax_reproduces_golden_smoke():
    golden = json.loads(OUT.read_text())
    assert golden["graph"] == GRAPH
    assert golden["solve_kw"] == SOLVE_KW
    assert jax_record() == golden["result"]


if __name__ == "__main__":
    OUT.parent.mkdir(parents=True, exist_ok=True)
    doc = {"graph": GRAPH, "solve_kw": SOLVE_KW, "result": jax_record()}
    OUT.write_text(json.dumps(doc, indent=1) + "\n")
    print(f"wrote {OUT}: {doc['result']}")
