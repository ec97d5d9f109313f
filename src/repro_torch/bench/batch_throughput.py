"""Batched multi-instance solve plane: instances/sec vs a sequential loop.

The port's mirror of ``benchmarks/batch_throughput.py``, on ``device``: for
B in {1, 4, 16}, B independent G(n, p) instances solved (a) by a loop of B
solves, each through a fresh session (its own plane cache), and (b) by one
``solve_many`` call on one batched plane.  Per-instance best, solution and
rounds are asserted bit-identical between the two.

The namesake asserts a B = 16 speedup of at least ``MIN_SPEEDUP_B16``, a bar
set on a CPU where every fresh session paid an XLA compile; an eager package
pays none, so here the speedup is recorded beside that bar, not asserted.
"""

from __future__ import annotations

import time

from repro_torch.api import SolveConfig, SolverSession
from repro_torch.graphs.generators import erdos_renyi

BATCH_SIZES = (1, 4, 16)
# the namesake's bar (recorded, not asserted: see the module docstring)
MIN_SPEEDUP_B16 = 2.0


def _bench_one(B: int, *, n: int, p: float, workers: int, spr: int, device) -> dict:
    graphs = [erdos_renyi(n, p, seed) for seed in range(B)]
    cfg = SolveConfig(num_workers=workers, steps_per_round=spr)

    t0 = time.perf_counter()
    singles = [SolverSession(config=cfg, device=device).solve(g) for g in graphs]
    seq_wall = time.perf_counter() - t0

    batch = SolverSession(config=cfg, device=device).solve_many(graphs)
    batch_wall = batch.wall_s

    for s, b in zip(singles, batch.results):
        assert s.best_size == b.best_size
        same_sol = (s.best_sol is None and b.best_sol is None) or (
            (s.best_sol == b.best_sol).all()
        )
        assert same_sol and s.rounds == b.rounds
    return dict(
        B=B,
        seq_wall_s=round(seq_wall, 3),
        batch_wall_s=round(batch_wall, 3),
        seq_inst_per_s=round(B / seq_wall, 3),
        batch_inst_per_s=round(B / batch_wall, 3),
        speedup=round(seq_wall / batch_wall, 2),
        best=[int(r.best_size) for r in batch.results],
        rounds=[int(r.rounds) for r in batch.results],
    )


def run(smoke: bool = False, device="cuda") -> dict:
    n, p, workers, spr = (24, 0.3, 4, 8) if smoke else (40, 0.28, 6, 8)
    rows = [_bench_one(B, n=n, p=p, workers=workers, spr=spr, device=device)
            for B in BATCH_SIZES]
    print(f"G({n}, {p}), {workers} workers/instance, "
          f"steps_per_round={spr}; sequential loop = B x fresh-session solve")
    print(f"{'B':>4} {'seq inst/s':>12} {'batch inst/s':>13} {'speedup':>8}")
    for r in rows:
        print(f"{r['B']:>4} {r['seq_inst_per_s']:>12} "
              f"{r['batch_inst_per_s']:>13} {r['speedup']:>7}x")
    return dict(problem="vertex_cover", n=n, p=p, workers=workers, steps_per_round=spr,
                rows=rows, min_speedup_b16=MIN_SPEEDUP_B16)


if __name__ == "__main__":
    run()
