"""Hierarchical frontier memory: spill completes what overflow drops.

The port's mirror of ``benchmarks/spill_throughput.py``, on ``device``: three
solves of the same instance through one plane cache, after a warm-up of
each,

* **unsaturated** — engine-sized capacity, the optimum and the wall baseline;
* **starved** — a pinned capacity under the search's peak frontier, without
  spill: tasks are dropped (``overflow_count > 0``);
* **spilled** — the same capacity with ``frontier_spill=True``: no drop, the
  unsaturated optimum.

Those claims are asserted, as in the namesake.  Its wall gate (spilled
within ``MAX_WALL_RATIO`` of unsaturated) was set on a CPU; the host pump's
share of an eager solve on the card differs, so the ratio is recorded, not
asserted.
"""

from __future__ import annotations

import time

from repro_torch.api import PlaneCache, SolveConfig, SolverSession
from repro_torch.graphs.generators import erdos_renyi

# the namesake's bar (recorded, not asserted: see the module docstring)
MAX_WALL_RATIO = 1.5


def _median_wall(fn, reps=3):
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        walls.append(time.perf_counter() - t0)
    return out, sorted(walls)[len(walls) // 2]


def run(smoke: bool = False, device="cuda") -> dict:
    n, p, seed = (40, 0.28, 0) if smoke else (48, 0.28, 0)
    cap = 12
    g = erdos_renyi(n, p, seed)
    base = SolveConfig(num_workers=4, steps_per_round=2, chunk_rounds=2, capacity=cap)
    cache = PlaneCache()

    def solve(cfg):
        return SolverSession("vertex_cover", config=cfg, cache=cache, device=device).solve(g)

    unsat_cfg = base.replace(capacity=None)
    spill_cfg = base.replace(frontier_spill=True)
    solve(unsat_cfg), solve(base), solve(spill_cfg)

    unsat, unsat_wall = _median_wall(lambda: solve(unsat_cfg))
    starved, _ = _median_wall(lambda: solve(base))
    spilled, spill_wall = _median_wall(lambda: solve(spill_cfg))

    assert starved.stats.overflow and starved.stats.overflow_count > 0, (
        "starved baseline did not overflow"
    )
    assert spilled.stats.spilled_tasks > 0
    assert not spilled.stats.overflow and spilled.stats.overflow_count == 0
    assert spilled.best_size == unsat.best_size, (
        f"spilled optimum {spilled.best_size} != unsaturated {unsat.best_size}"
    )
    wall_ratio = spill_wall / max(unsat_wall, 1e-9)

    out = dict(
        n=n,
        p=p,
        capacity=cap,
        best=int(unsat.best_size),
        starved_overflow_count=int(starved.stats.overflow_count),
        starved_best=int(starved.best_size),
        spilled_tasks=int(spilled.stats.spilled_tasks),
        readmitted_tasks=int(spilled.stats.readmitted_tasks),
        cold_bytes_peak=int(spilled.stats.cold_bytes_peak),
        no_drop=bool(not spilled.stats.overflow and spilled.stats.overflow_count == 0),
        optimum_matches=bool(spilled.best_size == unsat.best_size),
        unsat_wall_s=round(unsat_wall, 3),
        spill_wall_s=round(spill_wall, 3),
        wall_ratio=round(wall_ratio, 2),
        max_wall_ratio=MAX_WALL_RATIO,
    )
    print(
        f"spill gate: cap={cap} drops {out['starved_overflow_count']} tasks "
        f"without spill; with spill {out['spilled_tasks']} spilled / "
        f"{out['readmitted_tasks']} readmitted, 0 dropped, optimum "
        f"{out['best']} preserved at {out['wall_ratio']}x unsaturated wall"
    )
    return out


if __name__ == "__main__":
    run()
