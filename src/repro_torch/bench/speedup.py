"""Paper Fig. 4 / Table 1: speedup vs worker count, semi-centralized vs
fully-centralized, for both task encodings.

Hardware-neutral reproduction: the discrete-event simulators charge ONE tick
per node expansion per worker, so `ticks(sequential) / ticks(P workers)` is
the idealized-compute speedup and the schedulers differ exactly by their
scheduling/communication behaviour (the paper's y-axis, minus machine noise).
Byte counts are the paper's §4.3 communication story.

The port's mirror of ``benchmarks/speedup.py``: the simulators run on the
host; the donation rows run the SPMD engine on ``device`` (``vc_expand`` on
the card).
"""

from __future__ import annotations

from repro_torch.core.centralized import run_centralized_sim
from repro_torch.core.protocol_sim import run_protocol_sim
from repro_torch.graphs.generators import erdos_renyi, p_hat_like
from repro_torch.problems.sequential import solve_sequential

# explore rounds a superstep of the donation rows' SPMD solves
DONATION_STEPS_PER_ROUND = 8


def rows(graph_name, g, workers_list):
    base, _, base_stats = solve_sequential(g)
    seq_ticks = base_stats.nodes  # one expansion per tick
    out = []
    for p in workers_list:
        for codec in ("optimized", "basic"):
            semi = run_protocol_sim(g, num_workers=p, codec_name=codec)
            cent = run_centralized_sim(g, num_workers=p, codec_name=codec)
            assert semi.best_size == cent.best_size == base
            out.append(
                dict(
                    graph=graph_name,
                    workers=p,
                    codec=codec,
                    seq_ticks=seq_ticks,
                    semi_ticks=semi.ticks,
                    central_ticks=cent.ticks,
                    semi_speedup=round(seq_ticks / semi.ticks, 2),
                    central_speedup=round(seq_ticks / cent.ticks, 2),
                    semi_bytes=semi.stats.total_bytes,
                    central_bytes=cent.stats.total_bytes,
                    semi_failed=semi.stats.failed_requests,
                )
            )
    return out


def donation_rows(graph_name, g, workers_list, device="cuda"):
    """SPMD engine: multi-task donation (``donate_k``) on a skewed tree —
    a matched donor ships up to k shallowest tasks, so starved workers are
    refilled in fewer rebalance rounds (tasks moved per transfer round)."""
    from repro_torch.api import SolveConfig, SolverSession

    out = []
    for p in workers_list:
        base = None
        for k in (1, 4):
            r = SolverSession(config=SolveConfig(
                num_workers=p, steps_per_round=DONATION_STEPS_PER_ROUND, donate_k=k
            ), device=device).solve(g)
            if base is None:
                base = r.best_size
            assert r.best_size == base
            transfer_rounds = r.stats.transfer_rounds
            out.append(
                dict(
                    graph=graph_name,
                    workers=p,
                    donate_k=k,
                    rounds=r.rounds,
                    transfer_rounds=transfer_rounds,
                    tasks_moved=r.tasks_transferred,
                    tasks_per_transfer_round=round(
                        r.tasks_transferred / max(transfer_rounds, 1), 2
                    ),
                )
            )
    return out


def run(csv=True, device="cuda"):
    results = []
    # hard instance: ~7.5k search nodes sequentially (the p_hat-like regime)
    results += rows("gnp80_p2_hard", erdos_renyi(80, 0.2, 0), [2, 4, 8, 16, 32])
    # easy instance: reductions solve it almost instantly — reproduces the
    # paper's DSJ500.5 finding that massive parallelism wastes work there
    results += rows("phat_48_easy", p_hat_like(48, 0.45, 1), [2, 8])
    donation = donation_rows("gnp64_skewed", erdos_renyi(64, 0.22, 3), [8, 16], device)
    if csv:
        keys = list(results[0].keys())
        print(",".join(keys))
        for r in results:
            print(",".join(str(r[k]) for k in keys))
        print("# multi-task donation (SPMD engine)")
        keys = list(donation[0].keys())
        print(",".join(keys))
        for r in donation:
            print(",".join(str(r[k]) for k in keys))
    return results + donation


if __name__ == "__main__":
    run()
