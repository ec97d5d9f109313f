"""Continuous-batching solver service quickstart: submit -> ticket ->
streamed results.

The port's twin of ``examples/serve_solver.py``.  A SolveService keeps ONE
live plane per (problem, W) on ``--device`` (the card by default):
submitted instances queue, the scheduler admits them into vacant lanes, and
each step() retires finished lanes, streaming those results out while the
other lanes keep solving and freed lanes re-admit from the queue (swap-in is
pure data).

  PYTHONPATH=src python -m repro_torch.examples.serve_solver [--device cpu]
"""

from __future__ import annotations

import argparse

from repro_torch.api import SolveConfig, SolverSession
from repro_torch.graphs.generators import erdos_renyi


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="repro_torch.examples.serve_solver")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    session = SolverSession(
        problem="max_clique",
        config=SolveConfig(num_workers=4, steps_per_round=8, service_lanes=4),
        device=args.device,
    )
    svc = session.serve()

    # submit a burst twice the lane count: the second half admits into
    # lanes freed by the first as they finish, not in a second batch
    tickets = [
        svc.submit(erdos_renyi(n, 0.5, seed=i), priority=n)
        for i, n in enumerate([18, 24, 14, 22, 16, 20, 12, 26])
    ]
    print("queued:", svc.status())

    sizes = {}
    while not svc.idle():
        for t in svc.step():  # tickets whose lane retired this step
            r = svc.result(t)  # pops; KeyError before the lane retires
            sizes[t] = r.best_size
            print(f"ticket {t}: best={r.best_size} rounds={r.rounds} "
                  f"lane={r.stats.service.lane}")

    stats = svc.stats()
    print(f"occupancy={stats['occupancy']:.2f} over "
          f"{stats['chunk_calls']} chunks; cache: {svc.cache_stats()}")
    if sorted(sizes) != sorted(tickets) or any(svc.ready(t) for t in tickets):
        raise SystemExit("a ticket was not streamed out exactly once")
    return sizes


if __name__ == "__main__":
    main()
