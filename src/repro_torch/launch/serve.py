"""The asyncio front end of the port's continuous-batching solve service.

The port of ``repro/launch/serve.py``.  Drives a synthetic Poisson request
stream (Erdős–Rényi instances) through
:class:`repro_torch.api.AsyncSolveService`: every request is submitted the
moment it "arrives", admission fills lanes freed by finished instances on
the ONE live plane per (problem, W), and per-request results stream back as
their lanes retire.  Prints end-to-end latency percentiles (p50/p99,
arrival → result) and throughput.  Runs on the card unless ``--device``
says otherwise.

Usage:
  python -m repro_torch.launch.serve                 # 32 max-clique requests
  python -m repro_torch.launch.serve --smoke --device cpu
  python -m repro_torch.launch.serve --problem max_clique \
      --requests 32 --lanes 8 --rate 4.0 --n 24
  python -m repro_torch.launch.serve --checkpoint-dir ckpt --checkpoint-every 4
  python -m repro_torch.launch.serve --resume ckpt   # after a kill

``--checkpoint-dir`` checkpoints the live service (lanes and queue) every
``--checkpoint-every`` steps; ``--resume`` restores a service checkpoint
(either package's) first, and its in-flight and queued tickets finish
beside the new stream.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import time

import numpy as np


def build_requests(args, rng) -> list:
    """The synthetic arrival trace: (arrival_s, graph) pairs.  Sizes are
    drawn uniformly from [n_min, n], all packing into one W=1 plane by
    default; arrival gaps are exponential at ``rate`` req/s (0 = a burst)."""
    from repro_torch.graphs.generators import erdos_renyi

    reqs = []
    t = 0.0
    for _ in range(args.requests):
        n = int(rng.integers(args.n_min, args.n + 1))
        g = erdos_renyi(n, args.density, seed=int(rng.integers(1 << 30)))
        if args.rate > 0:
            t += float(rng.exponential(1.0 / args.rate))
        reqs.append((t, g))
    return reqs


async def run_service(args, reqs) -> dict:
    from repro_torch.api import AsyncSolveService, SolveConfig, SolveService

    cfg = SolveConfig(
        num_workers=args.workers,
        steps_per_round=args.steps_per_round,
        chunk_rounds=args.chunk_rounds,
        service_lanes=args.lanes,
        admission=args.admission,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
    )
    leftover = []
    if args.resume:
        # live lanes and the pending queue from a service checkpoint; its
        # tickets finish beside the fresh stream
        service = SolveService.restore(args.resume, device=args.device)
        leftover = service.tickets()
        print(f"[serve] restored {args.resume}: {len(leftover)} "
              f"in-flight/queued tickets resume")
    else:
        service = SolveService(args.problem, cfg, device=args.device)
    latencies = []
    t0 = time.perf_counter()

    async def one(arrival_s, g):
        # hold the request until its Poisson arrival, then submit
        now = time.perf_counter() - t0
        if arrival_s > now:
            await asyncio.sleep(arrival_s - now)
        submit = time.perf_counter()
        r = await svc.solve(g, deadline=args.deadline)
        latencies.append(time.perf_counter() - submit)
        return r

    async with AsyncSolveService(service) as svc:
        results = await asyncio.gather(*(one(a, g) for a, g in reqs))
    # the restored checkpoint's own tickets may still be in flight: finish
    # them, so a killed and restarted service completes all it admitted
    resumed_results = {}
    if leftover:
        service.drain()
        resumed_results = {t: service.result(t) for t in leftover}
    wall = time.perf_counter() - t0

    lat = np.array(sorted(latencies))
    stats = service.stats()
    return {
        "resumed_tickets": len(resumed_results),
        "resumed_best_sizes": [
            resumed_results[t].best_size for t in sorted(resumed_results)
        ],
        "requests": len(reqs),
        "wall_s": wall,
        "instances_per_s": len(reqs) / wall,
        "latency_p50_s": float(np.percentile(lat, 50)),
        "latency_p99_s": float(np.percentile(lat, 99)),
        "occupancy": stats["occupancy"],
        "evicted": stats["evicted"],
        "steps": stats["steps"],
        "supersteps": stats["supersteps"],
        "best_sizes": [r.best_size for r in results],
        "rounds": [r.rounds for r in results],
        "cache": service.cache_stats(),
    }


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--problem", default="max_clique")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--lanes", type=int, default=8,
                    help="service lanes per live plane")
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--steps-per-round", type=int, default=16)
    ap.add_argument("--chunk-rounds", type=int, default=8)
    ap.add_argument("--n", type=int, default=26, help="max instance size")
    ap.add_argument("--n-min", type=int, default=14)
    ap.add_argument("--density", type=float, default=0.5)
    ap.add_argument("--rate", type=float, default=0.0,
                    help="Poisson arrival rate, req/s (0 = burst)")
    ap.add_argument("--deadline", type=int, default=None,
                    help="superstep budget per request (anytime eviction)")
    ap.add_argument("--admission", choices=("fifo", "priority"),
                    default="priority")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda: the card; cpu: the plain path)")
    ap.add_argument("--checkpoint-dir", default=None, metavar="DIR",
                    help="auto-checkpoint the live service (lanes + queue) "
                         "every --checkpoint-every steps")
    ap.add_argument("--checkpoint-every", type=int, default=8)
    ap.add_argument("--resume", default=None, metavar="DIR",
                    help="restore a service checkpoint first; its in-flight "
                         "and queued tickets finish alongside the new stream")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny settings for CI")
    ap.add_argument("--json", action="store_true",
                    help="print the full stats dict as JSON")
    args = ap.parse_args(argv)
    if args.smoke:
        args.requests = min(args.requests, 12)
        args.n = min(args.n, 20)
        args.workers = min(args.workers, 4)
        args.lanes = min(args.lanes, 4)
        args.steps_per_round = min(args.steps_per_round, 8)
    return args


def main(argv=None) -> dict:
    args = parse_args(argv)
    rng = np.random.default_rng(args.seed)
    reqs = build_requests(args, rng)
    out = asyncio.run(run_service(args, reqs))
    if args.json:
        print(json.dumps(out, indent=2))
    else:
        print(
            f"[serve] {out['requests']} requests in {out['wall_s']:.2f}s "
            f"({out['instances_per_s']:.2f} inst/s), latency p50 "
            f"{out['latency_p50_s']*1e3:.0f}ms p99 "
            f"{out['latency_p99_s']*1e3:.0f}ms, plane occupancy "
            f"{out['occupancy']:.2f}, evicted {out['evicted']}"
            + (f", resumed {out['resumed_tickets']} checkpointed tickets"
               if out["resumed_tickets"] else "")
        )
        print(f"[serve] cache: {out['cache']}")
    return out


if __name__ == "__main__":
    main()
