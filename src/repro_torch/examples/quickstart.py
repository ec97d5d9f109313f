"""Quickstart: the paper's solver, three engines behind one façade, and a
small LM that learns.

The port's twin of ``examples/quickstart.py``, on ``--device`` (the card by
default).  Part 1: minimum vertex cover on G(50, 4/49, seed 7) by the
sequential reference, the asynchronous protocol simulator (host) and the
SPMD engine.  Part 2: the qwen1.5 smoke config trained 60 steps on the
synthetic pipeline through ``repro_torch.launch.train.train_loop`` (the
port's seeded init, so its losses are its own, not JAX's).

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

from __future__ import annotations

import argparse

from repro_torch.api import SolveConfig, SolverSession
from repro_torch.configs import get_smoke_config
from repro_torch.graphs.generators import erdos_renyi
from repro_torch.launch.train import train_loop
from repro_torch.problems.sequential import verify_cover


def main(argv=None) -> bool:
    ap = argparse.ArgumentParser(prog="repro_torch.examples.quickstart")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # one façade over every engine: pick a backend, get one result schema
    g = erdos_renyi(50, 4 / 49, seed=7)
    print(f"graph: n={g.n} m={g.num_edges}")
    cfg = SolveConfig(num_workers=6, steps_per_round=16)

    seq = SolverSession(backend="sequential", config=cfg, device=args.device).solve(g)
    print(f"sequential:        mvc={seq.best_size} "
          f"({seq.nodes_expanded} nodes)")

    sim = SolverSession(backend="protocol_sim", config=cfg, device=args.device).solve(g)
    print(
        f"semi-centralized:  mvc={sim.best_size} "
        f"(async protocol sim, {sim.tasks_transferred} transfers, "
        f"{sim.stats.failed_requests} failed requests)"
    )

    r = SolverSession(backend="spmd", config=cfg, device=args.device).solve(g)
    ok = r.best_size == seq.best_size == sim.best_size and verify_cover(g, r.best_sol)
    print(
        f"SPMD engine:       mvc={r.best_size} "
        f"({r.rounds} supersteps, {r.tasks_transferred} transfers, "
        f"verified={ok})"
    )
    if not ok:
        raise SystemExit("the engines disagree")

    # --- 2. the LM substrate: a tiny qwen-style model learns --------------
    lm = get_smoke_config("qwen1_5_0_5b")
    print(f"\ntraining {lm.name} (d={lm.d_model}, L={lm.n_layers}) ...")
    _, _, losses = train_loop(lm, steps=60, batch=8, seq=64, log_every=20, device=args.device)
    first, last = sum(losses[:6]) / 6, sum(losses[-6:]) / 6
    print(f"loss {first:.3f} -> {last:.3f} ({'OK' if last < first else 'FLAT'})")
    return ok


if __name__ == "__main__":
    main()
