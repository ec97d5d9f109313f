"""Where the solve plane's time goes on the card, at the smoke's sizes.

  PYTHONPATH=src python -m repro_torch.launch.profile [--supersteps 1]
  PYTHONPATH=src python -m repro_torch.launch.profile --problem max_clique --supersteps 8

Solves, with 128 workers, for a bounded number of supersteps after one
warm-up superstep, under ``torch.profiler``, the graph ``chip_smoke.py``
runs for the problem: G(600, 4/599, seed 0) (the paper's random family) for
vertex cover and MIS, ``p_hat_like(300, 0.325, seed 0)`` for max clique.
Prints:

* wall time, device busy time (the union of kernel, copy and memset
  intervals in the trace) and the device's idle share;
* device time and launch count by kernel name, largest first;
* the hand-written kernels' device time per launch, from the trace (their
  µs-scale bodies are far below the host time of a call, which a CUDA
  event pair around one call measures instead);
* the device time of one ``expand_tasks`` call at the plane's batch shape
  (``time_ms``: back-to-back calls between two CUDA events), which is one
  ``vc_expand`` or ``clique_expand`` launch: what each explore round runs;
* the solve's reduction sweeps and kernel launches.

The trace itself goes to ``--trace`` (default
``build/repro_torch_profile/trace.json``).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import json
import time
from pathlib import Path

import torch

from repro_torch.api import SolveConfig, SolverSession
from repro_torch.core import engine
from repro_torch.graphs.generators import erdos_renyi, p_hat_like
from repro_torch.kernels import counts
from repro_torch.launch.timing import time_ms
from repro_torch.problems.base import make_data
from repro_torch.problems.registry import get_problem

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the hand-written kernels' names in a trace (kernels/*/csrc/*.cu)
PORT_KERNELS = ("batched_degrees_kernel", "batched_expand_stats_kernel",
                "vc_expand_kernel", "clique_expand_kernel")


def _device_intervals(trace_path: Path):
    events = json.loads(trace_path.read_text())["traceEvents"]
    return [
        (e["ts"], e["ts"] + e["dur"], e["name"])
        for e in events
        if e.get("cat") in DEVICE_CATS and "dur" in e
    ]


def _union_us(intervals) -> float:
    busy, end = 0.0, float("-inf")
    for s, e, _ in sorted(intervals):
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--problem", default="vertex_cover",
                    choices=["vertex_cover", "max_clique", "mis"])
    ap.add_argument("--n", type=int, default=None,
                    help="vertices (default: 300 for max_clique, else 600)")
    ap.add_argument("--workers", type=int, default=128)
    ap.add_argument("--supersteps", type=int, default=1)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--trace", default="build/repro_torch_profile/trace.json")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        raise SystemExit("profile: needs a CUDA device")
    dev = torch.device("cuda")
    if args.problem == "max_clique":
        g = p_hat_like(args.n or 300, 0.325, 0)
    else:
        n = args.n or 600
        g = erdos_renyi(n, 4.0 / (n - 1), 0)
    spec = get_problem(args.problem)
    cfg = SolveConfig(
        num_workers=args.workers, max_rounds=args.supersteps,
        chunk_rounds=args.supersteps,
    )

    # warm-up: kernel build, allocator, one superstep
    SolverSession(spec, config=cfg.replace(max_rounds=1, chunk_rounds=1), device=dev).solve(g)

    trace = Path(args.trace)
    trace.parent.mkdir(parents=True, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    counts.reset()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        r = SolverSession(spec, config=cfg, device=dev).solve(g)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    launches = counts.snapshot()
    prof.export_chrome_trace(str(trace))

    intervals = _device_intervals(trace)
    busy_s = _union_us(intervals) / 1e6
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for s, e, name in intervals:
        by_name[name][0] += (e - s) / 1e3
        by_name[name][1] += 1
    total_ms = sum(v[0] for v in by_name.values())
    explore_rounds = r.rounds * cfg.steps_per_round

    print(f"[profile] {torch.cuda.get_device_name(0)}; G(n={g.n}, m={g.num_edges}), "
          f"{args.workers} workers, {r.rounds} supersteps, {explore_rounds} explore rounds")
    print(f"[profile] wall {wall_s:.3f} s (under the profiler), device busy "
          f"{busy_s:.3f} s, idle share {1 - busy_s / wall_s:.3f}")
    print(f"[profile] reduce sweeps {r.stats.reduce_sweeps} "
          f"({r.stats.reduce_sweeps / explore_rounds:.2f} per explore round), "
          f"kernel launches {launches}, device events {len(intervals)} "
          f"({len(intervals) / explore_rounds:.0f} per explore round)")
    print("[profile] device time by kernel (ms, share, count):")
    for name, (ms, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[: args.top]:
        print(f"[profile]   {ms:10.3f}  {ms / total_ms:6.3f}  {cnt:8d}  {name[:110]}")
    for kernel in PORT_KERNELS:
        hits = [v for name, v in by_name.items() if kernel in name]
        if hits:
            ms, cnt = sum(h[0] for h in hits), sum(h[1] for h in hits)
            print(f"[profile] {kernel}: {ms:.3f} ms of device time over {cnt} launches, "
                  f"{1e3 * ms / cnt:.3f} µs a launch")

    # one expand_tasks call (one fused kernel launch) at the plane's batch
    # shape, on the startup split's tasks
    data = make_data(spec, g, dev)
    state = engine.make_instance_state(
        spec, g, args.workers, 4 * g.n + 8, g.W, spec.bnb_bound(g), dev
    )
    masks = state.frontier.masks[:, 0].contiguous()
    sols = state.frontier.sols[:, 0].contiguous()
    expand_ms = time_ms(lambda: spec.expand_tasks(data, masks, sols))
    print(f"[profile] one expand_tasks call at T={masks.shape[0]}: {expand_ms:.4f} ms "
          f"of device time; {1e3 * wall_s / explore_rounds:.4f} ms of wall per "
          f"explore round; explore rounds x that call = "
          f"{explore_rounds * expand_ms / 1e3:.3f} s of the {wall_s:.3f} s wall")


if __name__ == "__main__":
    main()
