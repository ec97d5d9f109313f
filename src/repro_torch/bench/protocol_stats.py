"""Paper §3 claims, measured: message counts/bytes by tag, zero failed
requests, and the center's control-plane share of total traffic.

The port's mirror of ``benchmarks/protocol_stats.py``: the same graph and
worker counts, the same rows (the simulator runs on the host)."""

from __future__ import annotations

from repro_torch.core.protocol_sim import run_protocol_sim
from repro_torch.graphs.generators import erdos_renyi


def run(csv=True):
    g = erdos_renyi(60, 4 / 59, 3)
    rows = []
    for p in (4, 8, 16):
        res = run_protocol_sim(g, num_workers=p, codec_name="optimized")
        s = res.stats
        rows.append(
            dict(
                workers=p,
                mvc=res.best_size,
                ticks=res.ticks,
                nodes=s.nodes_expanded,
                transfers=s.tasks_transferred,
                failed_requests=s.failed_requests,
                msgs_total=sum(s.msg_count.values()),
                bytes_total=s.total_bytes,
                center_bytes=s.center_bytes,
                center_share=round(s.center_bytes / max(s.total_bytes, 1), 3),
                term_cancelled=s.termination_cancelled,
            )
        )
    if csv:
        keys = list(rows[0].keys())
        print(",".join(keys))
        for r in rows:
            print(",".join(str(r[k]) for k in keys))
    return rows


if __name__ == "__main__":
    run()
