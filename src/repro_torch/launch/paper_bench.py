"""Time the vertex-cover main path at the paper's size, and the degree panel kernel.

  python3 src/repro_torch/launch/paper_bench.py [--src DIR] [--max-rounds 8] [--runs 2]

``--src`` names the ``src/`` directory whose ``repro_torch`` is imported
(default: the one holding this file), so the same measurement can be made of
two checkouts in one session on one card, e.g. parent, change, change,
parent, each a process of its own.  It builds that checkout's kernels, then:

- ``batched_degrees`` at the plane's shape (T = 128, n = 600, W = 19): the
  median of CUDA-event times of one call (the wrapper's host work shows when
  it outlasts the kernel), the host time per call of 1,000 back-to-back
  calls, and the plain version's event time;
- ``--runs`` anytime solves of G(600, 4/599, seed 0) with 128 workers and
  ``--max-rounds`` supersteps (one chunk), with wall, nodes, sweeps and
  launch counts.

Needs one NVIDIA GPU.  Prints the card's name and power limit, then one JSON
line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[2]),
                    help="the src/ directory whose repro_torch is timed")
    ap.add_argument("--max-rounds", type=int, default=8)
    ap.add_argument("--runs", type=int, default=2)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("paper_bench: torch.cuda.is_available() is false")
    sys.path.insert(0, str(Path(args.src).resolve()))

    import repro_torch
    from repro_torch.api import SolveConfig, SolverSession
    from repro_torch.graphs.bitgraph import mask_full
    from repro_torch.graphs.generators import erdos_renyi
    from repro_torch.kernels import build, counts
    from repro_torch.kernels.bitset_ops import batched_degrees, batched_degrees_ref

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    build.build_all()
    dev = torch.device("cuda")

    def event_ms(fn, reps=50, warmup=10):
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    g = erdos_renyi(n=600, p=4.0 / 599, seed=0)
    T = 128
    rng = np.random.default_rng(0)
    masks = rng.integers(0, 2**32, size=(T, g.W), dtype=np.uint32) & mask_full(g.n)
    adj = torch.from_numpy(np.asarray(g.adj, np.uint32).view(np.int32).copy()).to(dev)
    m = torch.from_numpy(masks.view(np.int32).copy()).to(dev)
    out = {"src": str(Path(repro_torch.__file__).resolve().parents[1]), "card": smi}
    out["degrees_ms"] = event_ms(lambda: batched_degrees(adj, m))
    out["degrees_plain_ms"] = event_ms(lambda: batched_degrees_ref(adj, m))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(1000):
        batched_degrees(adj, m)
    out["degrees_host_us_per_call"] = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()

    cfg = SolveConfig(num_workers=128, max_rounds=args.max_rounds,
                      chunk_rounds=args.max_rounds)
    session = SolverSession(config=cfg, device=dev)
    out["runs"] = []
    for _ in range(args.runs):
        counts.reset()
        t0 = time.perf_counter()
        r = session.solve(g)
        wall = time.perf_counter() - t0
        out["runs"].append({
            "wall_s": wall,
            "rounds": int(r.rounds),
            "best": int(r.best_size),
            "nodes": int(r.nodes_expanded),
            "sweeps": int(r.stats.reduce_sweeps),
            "launches": counts.snapshot(),
            "ms_per_superstep": 1e3 * wall / r.rounds,
        })
    print(json.dumps(out))


if __name__ == "__main__":
    main()
