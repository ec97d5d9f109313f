"""Timing a kernel call on the card with CUDA events.

``time_ms`` is the device time of one call: calls run back to back behind a
spin kernel, so the events time the card's work and not the host's cost of
each call (a µs-scale kernel's wrapper takes longer on the host than its
body on the card).  ``call_ms`` is the single synchronised call that earlier
measurements used; for such a kernel it reads the wrapper's host time.
Both need a CUDA device.
"""

from __future__ import annotations

import statistics
import time

import torch

# a spin kernel's cycles per second of wall (above an H100's 1.98 GHz boost
# clock, so a spin lasts at least as long as asked) and its longest spin
SPIN_CYCLES_PER_S = 2e9
SPIN_MAX_S = 0.2


def time_ms(fn, n: int = 50, runs: int = 5, warmup: int = 10) -> float:
    """Device time of one call: the median over ``runs`` of (an event, ``n``
    back-to-back calls, an event, one synchronise) / ``n``.  Before each run
    a spin kernel holds the stream about twice as long as the host takes to
    queue the ``n`` calls, so the calls run back to back on the card."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    spin_s = min(SPIN_MAX_S, 2 * n * (time.perf_counter() - t0))
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(spin_s * SPIN_CYCLES_PER_S))
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def call_ms(fn, reps: int = 50, warmup: int = 10) -> float:
    """The median of ``reps`` single calls, each between two events and
    synchronised."""
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
