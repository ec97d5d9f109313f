"""Where the solve plane's time goes on the card, by kernel and by program span.

  PYTHONPATH=src python -m repro_torch.launch.profile [--supersteps 16]
  PYTHONPATH=src python -m repro_torch.launch.profile --workers 2048 --supersteps 16
  PYTHONPATH=src python -m repro_torch.launch.profile --problem max_clique --supersteps 16

Starts one instance with ``--workers`` workers (the startup split), runs one
warm-up superstep (the kernel build, the allocator), then one chunk of
``--supersteps`` supersteps of the solo plane under ``torch.profiler``, on
the graph ``chip_smoke.py`` runs for the problem: G(600, 4/599, seed 0)
(the paper's random family) for vertex cover and MIS,
``p_hat_like(300, 0.325, seed 0)`` for max clique.  Prints:

* wall time, device busy time (the union of kernel, copy and memset
  intervals in the trace) and the device's idle share;
* device time and launch count by kernel name, largest first;
* the hand-written kernels' device time per launch, from the trace;
* device ms per superstep by program span (:mod:`repro_torch.telemetry`:
  the profiler switches the spans on), each device event given to the
  innermost span its launch was issued in (matched through the launch's
  correlation id), the rest under "other";
* the idle gaps between device work, summed by the innermost program span
  open at each gap's middle ("other" outside every span);
* the device time of one ``expand_tasks`` call at the plane's batch shape
  (``time_ms``: back-to-back calls between two CUDA events), which is one
  ``vc_expand`` or ``clique_expand`` launch: what each explore round runs;
* the chunk's reduction sweeps and kernel launches.

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

from repro_torch.api import PlaneCache, SolveConfig
from repro_torch.core import engine
from repro_torch.core.encoding import make_codec
from repro_torch.graphs.generators import erdos_renyi, p_hat_like
from repro_torch.kernels import counts
from repro_torch.launch.timing import time_ms
from repro_torch.problems.base import WorkCounters, initial_bound, make_data
from repro_torch.problems.registry import get_problem

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
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


def _ranges_of(events: list, ranges) -> list:
    """The profiler ranges (``user_annotation`` events) named in ``ranges``
    (every one when None) as (start, end, name), by start."""
    return sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                  if e.get("cat") == "user_annotation" and "dur" in e
                  and (ranges is None or e["name"] in ranges))


def innermost(spans: list, points) -> dict:
    """Each time in ``points`` -> the name of the innermost of the nested
    (start, end, name) ``spans`` (by start) holding it, or "other"."""
    out = {}
    stack, i = [], 0
    for t in sorted(set(points)):
        while i < len(spans) and spans[i][0] <= t:
            while stack and stack[-1][1] < spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[t] = stack[-1][2] if stack else "other"
    return out


def range_split(trace: Path, ranges=None) -> dict:
    """Device ms by the profiler range (``record_function``, as
    :func:`repro_torch.telemetry.span` opens) that issued each device
    event: the innermost range named in ``ranges`` (any when None) holding
    the launch, matched through the launch's correlation id.  Events
    issued outside every such range go to "other"."""
    events = json.loads(trace.read_text())["traceEvents"]
    issued = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
    device = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]
    at = [issued.get(e.get("args", {}).get("correlation")) for e in device]
    name = innermost(_ranges_of(events, ranges), [t for t in at if t is not None])
    ms = collections.Counter()
    for e, t in zip(device, at):
        ms[name.get(t, "other")] += e["dur"] / 1e3
    return dict(ms)


def gap_split(trace: Path, ranges=None) -> dict:
    """The idle gaps between device work (ms), summed by the innermost
    profiler range in ``ranges`` (any when None) open at each gap's middle,
    "other" where none is."""
    events = json.loads(trace.read_text())["traceEvents"]
    busy = []
    for s, e, _ in sorted(_device_intervals(trace)):
        if busy and s <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], e)
        else:
            busy.append([s, e])
    gaps = [(end, nxt) for (_, end), (nxt, _) in zip(busy, busy[1:])]
    name = innermost(_ranges_of(events, ranges), [(a + b) / 2 for a, b in gaps])
    ms = collections.Counter()
    for a, b in gaps:
        ms[name[(a + b) / 2]] += (b - a) / 1e3
    return dict(ms)


def _print_split(label: str, split: dict, per: int) -> None:
    total = sum(split.values()) or 1.0
    print(f"[profile] {label} (ms per superstep, share):")
    for name, v in sorted(split.items(), key=lambda kv: -kv[1]):
        print(f"[profile]   {name:16s} {v / per:10.3f}  {v / total:6.3f}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--problem", default="vertex_cover",
                    choices=["vertex_cover", "max_clique", "mis"])
    ap.add_argument("--n", type=int, default=None,
                    help="vertices (default: 300 for max_clique, else 600)")
    ap.add_argument("--workers", type=int, default=128)
    ap.add_argument("--supersteps", type=int, default=16)
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
    cfg = SolveConfig(num_workers=args.workers, chunk_rounds=args.supersteps)
    data = make_data(spec, g, dev)
    pad = make_codec(cfg.codec, g.n, problem=spec).pad_words
    cap = cfg.capacity or (4 * g.n + 8 * cfg.lanes)
    best = initial_bound(spec, g, cfg.mode, None)
    cache = PlaneCache()

    # warm-up: kernel build, allocator, one superstep from the startup split
    state = engine.make_instance_state(spec, g, args.workers, cap, g.W, best, dev)
    state, done, _, _ = cache.solo_plane(spec, cfg.replace(chunk_rounds=1), pad, False)(
        data, state)
    torch.cuda.synchronize()

    trace = Path(args.trace)
    trace.parent.mkdir(parents=True, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    plane = cache.solo_plane(spec, cfg, pad, False)
    counters = WorkCounters()
    counts.reset()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        state, done, ran, _ = plane(data, state, None, counters)
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
    total_ms = sum(v[0] for v in by_name.values()) or 1.0
    ran = max(ran, 1)
    explore_rounds = ran * cfg.steps_per_round

    print(f"[profile] {torch.cuda.get_device_name(0)}; G(n={g.n}, m={g.num_edges}), "
          f"{args.workers} workers, {ran} supersteps from superstep 1 "
          f"({'finished' if done else 'unfinished'}), {explore_rounds} explore rounds")
    print(f"[profile] wall {wall_s:.3f} s (under the profiler), device busy "
          f"{busy_s:.3f} s, idle share {1 - busy_s / wall_s:.3f}")
    print(f"[profile] reduce sweeps {counters.reduce_sweeps} "
          f"({counters.reduce_sweeps / explore_rounds:.2f} per explore round), "
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
    _print_split("device time by program span", range_split(trace), ran)
    _print_split("idle gaps by program span", gap_split(trace), ran)

    # one expand_tasks call (one fused kernel launch) at the plane's batch
    # shape, on the startup split's tasks
    state = engine.make_instance_state(spec, g, args.workers, cap, g.W, best, dev)
    masks = state.frontier.masks[:, 0].contiguous()
    sols = state.frontier.sols[:, 0].contiguous()
    expand_ms = time_ms(lambda: spec.expand_tasks(data, masks, sols))
    print(f"[profile] one expand_tasks call at T={masks.shape[0]}: {expand_ms:.4f} ms "
          f"of device time; {1e3 * wall_s / explore_rounds:.4f} ms of wall per "
          f"explore round; explore rounds x that call = "
          f"{explore_rounds * expand_ms / 1e3:.3f} s of the {wall_s:.3f} s wall")


if __name__ == "__main__":
    main()
