"""Cold vs warm session solves: the plane cache's payoff.

The port's mirror of ``benchmarks/session_warm.py``, on ``device``: a
session's first solve (cold), a same-shape solve of another graph (warm) and
the first graph again (warm repeat, asserted bit-identical to cold).

The port is eager: nothing is traced or compiled per shape.  So
``plane_traces``, which the namesake reads off the JAX package's trace
counter, is here the number of plane functions the session's cache built for
the same-shape trio (``CacheStats.planes``, see ``api/cache.py``); it must
be 1, and the cache must show one miss and two hits, as the namesake
asserts.  The namesake also asserts ``warm >= MIN_WARM_SPEEDUP x cold``, a
bar for an XLA compile saved; an eager cold solve saves only a plane
function's construction, so the ratio is recorded, not asserted.
"""

from __future__ import annotations

import time

from repro_torch.api import SolveConfig, SolverSession
from repro_torch.graphs.generators import erdos_renyi

# the namesake's bar (recorded, not asserted: see the module docstring)
MIN_WARM_SPEEDUP = 5.0


def run(smoke: bool = False, device="cuda") -> dict:
    n, p, workers, spr = (24, 0.3, 4, 8) if smoke else (40, 0.28, 6, 8)
    session = SolverSession(
        problem="vertex_cover",
        config=SolveConfig(num_workers=workers, steps_per_round=spr),
        device=device,
    )
    g_cold = erdos_renyi(n, p, 0)
    g_warm = erdos_renyi(n, p, 1)

    planes0 = session.cache.stats().planes
    t0 = time.perf_counter()
    r_cold = session.solve(g_cold)
    cold_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    r_warm = session.solve(g_warm)
    warm_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    r_repeat = session.solve(g_cold)
    repeat_s = time.perf_counter() - t0
    traces = session.cache.stats().planes - planes0

    stats = session.cache_stats()
    assert traces == 1, f"same-shape solves built {traces} planes, want 1"
    assert stats["misses"] == 1 and stats["hits"] == 2, stats
    assert r_repeat.best_size == r_cold.best_size
    assert (r_repeat.best_sol == r_cold.best_sol).all()
    assert r_repeat.rounds == r_cold.rounds
    assert r_warm.best_size is not None

    speedup = cold_s / max(warm_s, 1e-9)
    print(f"G({n}, {p}), {workers} workers, steps_per_round={spr}")
    print(f"cold  (plane built + run): {cold_s * 1e3:9.1f} ms")
    print(f"warm  (same-shape reuse) : {warm_s * 1e3:9.1f} ms   ({speedup:.1f}x)")
    print(f"warm  (repeat, bit-identical): {repeat_s * 1e3:5.1f} ms")
    print(f"cache: {stats}")
    return dict(
        problem="vertex_cover",
        n=n,
        p=p,
        workers=workers,
        steps_per_round=spr,
        cold_s=round(cold_s, 4),
        warm_s=round(warm_s, 4),
        warm_repeat_s=round(repeat_s, 4),
        warm_speedup=round(speedup, 1),
        min_warm_speedup=MIN_WARM_SPEEDUP,
        plane_traces=traces,
        cache=stats,
    )


if __name__ == "__main__":
    run()
