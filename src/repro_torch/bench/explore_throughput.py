"""Exploration-plane throughput: fused vs reference, in nodes expanded/sec.

The port's mirror of ``benchmarks/explore_throughput.py``: the two
``explore_impl`` routes solve the same instances on ``device`` and are
asserted bit-identical (best, solution, rounds, nodes), so the ratio is the
hot path's cost, not a different search.

* **reference** — the full-capacity sorted pop and the composed callables
  (on the card: ``batched_degrees`` sweeps for vertex cover, one
  ``batched_expand_stats`` a round for max clique);
* **fused** — the cheap depth-major pop and the plugin's ``expand_tasks``
  (one ``vc_expand`` or ``clique_expand`` launch a round).

The namesake asserts ``fused >= MIN_FUSED_SPEEDUP x reference`` on the smoke's
max-clique shape, a bar set on a CPU under XLA; here the ratio is recorded
beside that bar and not asserted.
"""

from __future__ import annotations

import time

from repro_torch.api import SolveConfig, SolverSession
from repro_torch.graphs.generators import erdos_renyi

# the namesake's bar (recorded, not asserted: see the module docstring)
MIN_FUSED_SPEEDUP = 1.3


def _throughput(problem, graphs, impl, *, workers, spr, lanes, repeats, device):
    """Run ``graphs`` once (warm-up), then ``repeats`` timed sweeps; keep the
    fastest.  Returns (nodes_per_sec, [results])."""
    session = SolverSession(
        problem=problem,
        config=SolveConfig(num_workers=workers, steps_per_round=spr, lanes=lanes,
                           explore_impl=impl),
        device=device,
    )
    for g in graphs:
        session.solve(g)
    best_wall, results = float("inf"), []
    for _ in range(repeats):
        t0 = time.perf_counter()
        sweep = [session.solve(g) for g in graphs]  # each ends in a host fetch
        wall = time.perf_counter() - t0
        if wall < best_wall:
            best_wall, results = wall, sweep
    nodes = sum(r.nodes_expanded for r in results)
    return nodes / max(best_wall, 1e-9), results


def ab(problem, graphs, *, workers, spr, lanes, repeats, device):
    """(reference nodes/s, fused nodes/s, fused results), the two routes
    asserted bit-identical."""
    out = {}
    for impl in ("reference", "fused"):
        out[impl] = _throughput(problem, graphs, impl, workers=workers, spr=spr,
                                lanes=lanes, repeats=repeats, device=device)
    for a, b in zip(out["reference"][1], out["fused"][1]):
        assert (a.best_size, a.rounds, a.nodes_expanded) == (
            b.best_size, b.rounds, b.nodes_expanded
        ), "fused explore diverged from reference"
        assert (a.best_sol == b.best_sol).all()
    return out["reference"][0], out["fused"][0], out["fused"][1]


def shapes(smoke: bool) -> dict:
    """The namesake's shapes (engine-default explore knobs)."""
    if smoke:
        return {
            "max_clique": dict(n=40, p=0.5, seeds=(0, 1), workers=4, spr=32, lanes=1, repeats=4),
            "vertex_cover": dict(n=28, p=0.3, seeds=(0,), workers=4, spr=32, lanes=1, repeats=4),
        }
    return {
        "max_clique": dict(n=64, p=0.4, seeds=(0, 1, 2), workers=8, spr=32, lanes=1, repeats=5),
        "vertex_cover": dict(n=44, p=0.25, seeds=(0, 1), workers=8, spr=32, lanes=1, repeats=5),
    }


def run(smoke: bool = False, device="cuda") -> dict:
    rows = {}
    for problem, kw in shapes(smoke).items():
        graphs = [erdos_renyi(kw["n"], kw["p"], s) for s in kw["seeds"]]
        ref_nps, fused_nps, results = ab(problem, graphs, workers=kw["workers"], spr=kw["spr"],
                                         lanes=kw["lanes"], repeats=kw["repeats"], device=device)
        speedup = fused_nps / max(ref_nps, 1e-9)
        rows[problem] = dict(
            n=kw["n"], p=kw["p"], instances=len(graphs), workers=kw["workers"],
            steps_per_round=kw["spr"], lanes=kw["lanes"],
            reference_nodes_per_s=round(ref_nps),
            fused_nodes_per_s=round(fused_nps),
            fused_speedup=round(speedup, 2),
            best=[int(r.best_size) for r in results],
            rounds=[int(r.rounds) for r in results],
            nodes=[int(r.nodes_expanded) for r in results],
        )
        print(f"{problem:13s} G({kw['n']}, {kw['p']}) x{len(graphs)}: "
              f"reference {ref_nps:10.0f} nodes/s | fused {fused_nps:10.0f} "
              f"nodes/s | {speedup:.2f}x")
    return dict(problem="max_clique", gate_speedup=rows["max_clique"]["fused_speedup"],
                min_fused_speedup=MIN_FUSED_SPEEDUP, shapes=rows)


if __name__ == "__main__":
    run()
