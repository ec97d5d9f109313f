"""SPMD superstep engine: throughput and collective-traffic budget.

The port's mirror of ``benchmarks/engine_throughput.py``, on ``device``:

  budget   expansion/transfer accounting per worker count and matching
           policy (deterministic: equal to the namesake's rows);
  chunked  supersteps/sec of the port's plane function
           (``superstep.build_plane_fn``) at ``chunk_rounds=K`` against
           ``chunk_rounds=1`` at P = 64 workers, for pure coordination
           rounds (``steps_per_round=0``) and compute-carrying ones (1).
           The port reads ``done`` once a superstep either way, so this A/B
           measures the host's cost of a chunk call, where the namesake's
           measures one device sync a chunk against one a round;
  transfer gather vs sparse data plane on the DIMACS-style sample:
           identical best and solution, payload bytes per round
           (deterministic: equal to the namesake's rows).
"""

from __future__ import annotations

import statistics
import time

from repro_torch.api import SolveConfig, SolverSession
from repro_torch.core import engine as E
from repro_torch.core.superstep import build_plane_fn
from repro_torch.graphs.bitgraph import n_words
from repro_torch.graphs.generators import erdos_renyi, p_hat_like
from repro_torch.problems.base import make_data
from repro_torch.problems.registry import get_problem
from repro_torch.problems.sequential import solve_sequential


def budget_rows(device="cuda"):
    g = erdos_renyi(48, 0.25, 2)
    want, _, _ = solve_sequential(g)
    rows = []
    for p in (2, 4, 8):
        for policy in ("priority", "random"):
            r = SolverSession(config=SolveConfig(num_workers=p, steps_per_round=8, policy=policy),
                              device=device).solve(g)
            assert r.best_size == want
            rows.append(
                dict(
                    workers=p,
                    policy="priority" if policy == "priority" else "round_robin",
                    rounds=r.rounds,
                    nodes=r.nodes_expanded,
                    transfers=r.tasks_transferred,
                    nodes_per_round=round(r.nodes_expanded / r.rounds, 1),
                    control_B_per_round=r.stats.control_bytes_per_round,
                    transfer_B_per_round=round(r.stats.transfer_bytes_per_round, 1),
                )
            )
    return rows


def _median_rate(fn, reps=3):
    return statistics.median(fn() for _ in range(reps))


def chunked_ab(P=64, K=32, R=96, n=32, seed=1, device="cuda"):
    """supersteps/sec: a plane of one superstep a call vs one of K."""
    g = erdos_renyi(n, 0.3, seed)
    W = n_words(g.n)
    cap = 4 * g.n + 8
    spec = get_problem("vertex_cover")
    data = make_data(spec, g, device)
    s0 = E.make_instance_state(spec, g, P, cap, W, g.n + 1, device)
    out = []
    for spr, label in ((0, "coordination (steps_per_round=0)"),
                       (1, "compute round (steps_per_round=1)")):
        step_fn = build_plane_fn(spec, steps_per_round=spr, lanes=1, chunk_rounds=1)
        chunk_fn = build_plane_fn(spec, steps_per_round=spr, lanes=1, chunk_rounds=K)
        step_fn(data, s0)  # warm-up (a first CUDA call builds and loads kernels)
        chunk_fn(data, s0)

        def host_rate():
            s, t0 = s0, time.perf_counter()
            for _ in range(R):
                s, _done, _, _ = step_fn(data, s)
            return R / (time.perf_counter() - t0)

        def device_rate():
            s, t0, ran_tot = s0, time.perf_counter(), 0
            while ran_tot < R:
                s, done, ran, _ = chunk_fn(data, s)
                ran_tot += ran
                if done:
                    break
            return ran_tot / (time.perf_counter() - t0)

        h = _median_rate(host_rate)
        v = _median_rate(device_rate)
        out.append(
            dict(
                mode=label, workers=P, chunk_rounds=K,
                host_steps_per_s=round(h, 1),
                device_steps_per_s=round(v, 1),
                speedup=round(v / h, 2),
            )
        )
    return out


def transfer_ab(device="cuda"):
    """gather vs sparse on the solve_dimacs.py sample: identical results,
    payload proportional to the matches for sparse."""
    g = p_hat_like(60, 0.4, seed=0)
    out = []
    results = {}
    rec_words = 2 * n_words(g.n) + 1
    for impl in ("gather", "sparse"):
        r = SolverSession(config=SolveConfig(num_workers=8, steps_per_round=16,
                                             transfer_impl=impl), device=device).solve(g)
        results[impl] = r
        out.append(
            dict(
                impl=impl,
                best=r.best_size,
                rounds=r.rounds,
                transfer_rounds=r.stats.transfer_rounds,
                tasks_moved=r.tasks_transferred,
                payload_B_total=r.stats.transfer_bytes_total,
                payload_B_per_round=round(r.stats.transfer_bytes_per_round, 1),
                record_B=4 * rec_words,
            )
        )
    a, b = results["gather"], results["sparse"]
    assert a.best_size == b.best_size and (a.best_sol == b.best_sol).all(), (
        "transfer paths diverged"
    )
    assert b.stats.transfer_bytes_total == 4 * rec_words * b.tasks_transferred
    return out


def _print_csv(rows):
    keys = list(rows[0].keys())
    print(",".join(keys))
    for r in rows:
        print(",".join(str(r[k]) for k in keys))


def run(csv=True, device="cuda"):
    sections = {
        "budget": budget_rows(device),
        "chunked": chunked_ab(device=device),
        "transfer": transfer_ab(device),
    }
    if csv:
        for name, rows in sections.items():
            print(f"# {name}")
            _print_csv(rows)
    return sections


if __name__ == "__main__":
    run()
