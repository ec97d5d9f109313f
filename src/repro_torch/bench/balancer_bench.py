"""Beyond-paper: the semi-centralized request balancer on a hot-shard decode
trace — makespan and idle-slot reduction vs no balancing.

The port's mirror of ``benchmarks/balancer_bench.py``, on the port's
``serving.balancer.simulate`` (host)."""

from __future__ import annotations

import numpy as np

from repro_torch.serving.balancer import simulate


def run(csv=True):
    rng = np.random.default_rng(0)
    rows = []
    for replicas in (4, 8, 16):
        works = list(rng.integers(8, 256, replicas * 8))
        off = simulate(replicas, 8, works, balance=False)
        on = simulate(replicas, 8, works, balance=True)
        rows.append(
            dict(
                replicas=replicas,
                requests=len(works),
                makespan_off=off["rounds"],
                makespan_on=on["rounds"],
                speedup=round(off["rounds"] / on["rounds"], 2),
                idle_off=off["idle_slot_steps"],
                idle_on=on["idle_slot_steps"],
                transfers=on["transfers"],
                control_ints_per_round=on["control_ints_per_round"],
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
