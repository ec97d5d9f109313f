"""Reading a ``torch.profiler`` trace of a sub-window of the run.

The trace is exported as Chrome JSON under the run's ``TMPDIR``, read once
and deleted.  Device busy time is the union of the kernel, copy and memset
intervals (copied from ``repro_torch/launch/profile.py``'s
``_device_intervals`` and ``_union_us``); host launches are the CUDA
runtime and driver calls that launch a kernel or a graph, and a kernel
whose launch the host-side trace does not show (a library that links the
runtime statically) counts once by its own correlation id.
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import tempfile
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cuda_runtime", "cuda_driver")
LAUNCH_CALLS = ("LaunchKernel", "GraphLaunch", "LaunchCooperativeKernel")


def union_us(intervals) -> float:
    """The length covered by (start, end, ...) intervals."""
    busy, end = 0.0, float("-inf")
    for s, e, *_ in sorted(intervals):
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def merged(intervals) -> list:
    """The union as disjoint (start, end) intervals in order."""
    out = []
    for s, e, *_ in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def read_events(prof) -> list:
    """Export ``prof``'s trace under TMPDIR, parse it and delete the file."""
    fd, path = tempfile.mkstemp(prefix="perfbench_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return json.loads(Path(path).read_text())["traceEvents"]
    finally:
        os.unlink(path)


def summarize(events: list) -> dict:
    """What the per-layer readers take from a trace: the device intervals
    (µs) by name, the busy time, the host launches, and the host ops."""
    device, host_launch_ids, kernel_ids, host_ops = [], set(), {}, []
    for e in events:
        cat, dur = e.get("cat"), e.get("dur")
        if dur is None:
            continue
        args = e.get("args") or {}
        if cat in DEVICE_CATS:
            device.append((e["ts"], e["ts"] + dur, e["name"]))
            if cat == "kernel" and "correlation" in args:
                kernel_ids[args["correlation"]] = e["name"]
        elif cat in HOST_CATS and any(c in e["name"] for c in LAUNCH_CALLS):
            host_launch_ids.add(args.get("correlation", id(e)))
        elif cat == "cpu_op":
            host_ops.append((e["ts"], e["ts"] + dur, e["name"]))
    unseen = [c for c in kernel_ids if c not in host_launch_ids]
    return {
        "device": device,
        "busy_us": union_us(device),
        "launches": len(host_launch_ids) + len(unseen),
        "host_ops": host_ops,
    }


def kernel_durations_s(summary: dict, kernel: str) -> list:
    """Device seconds of each launch of ``kernel`` (a substring of the
    kernel's name in the trace), in launch order."""
    return [(e - s) / 1e6 for s, e, name in sorted(summary["device"]) if kernel in name]


def breakdown(summary: dict, top: int = 10) -> dict:
    """The device operations that took most time, and the idle gaps between
    device work summed by the innermost host op running at each gap's
    middle ("python" where no op ran: the interpreter's own work)."""
    by_op = collections.Counter()
    for s, e, name in summary["device"]:
        by_op[name[:120]] += (e - s) / 1e6
    gaps = collections.Counter()
    busy = merged(summary["device"])
    ops = sorted(summary["host_ops"])
    starts = [o[0] for o in ops]
    for (_, end), (nxt, _) in zip(busy, busy[1:]):
        mid = (end + nxt) / 2
        name = "python"
        i = bisect.bisect_right(starts, mid)
        # the innermost op holding the middle: the latest start that still covers it
        for s, e, op in reversed(ops[max(0, i - 64):i]):
            if e >= mid:
                name = op
                break
        gaps[name[:120]] += (nxt - end) / 1e6
    return {
        "device_ops": [[k, v] for k, v in by_op.most_common(top)],
        "idle_gaps": [[k, v] for k, v in gaps.most_common(top)],
    }
