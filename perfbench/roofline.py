"""The least time one H100 could take for a launch of a kernel, and a
kernel's share of it.

Each kernel's counts live beside its reader (``metrics/<kernel>.roofline.py``:
``count(B, n, W, T, in_mask)`` gives the bytes moved, the 32-bit integer
operations and the popcounts of one launch; each input byte counted once as
read and each output byte once as written, whatever the kernel reads
again).  The arithmetic is frozen from ``chip_smoke.py``'s phase 2, widened
to the window's launches (B instances and a row map) and split by the pipe
each operation issues to.  The bound is the larger of the bytes over the
HBM bandwidth and each pipe's operations over its rate: the integer and
the popcount pipes issue apart.

The rates: H100 SXM5, 132 SMs at the 1,980 MHz boost clock and 3.35 TB/s
of HBM3 (NVIDIA H100 Tensor Core GPU data sheet and architecture paper);
per SM and clock at compute capability 9.0, 64 results of 32-bit integer
add and of bitwise AND, and 16 of population count (CUDA C++ Programming
Guide, "Arithmetic Instructions", throughput table).
"""

from __future__ import annotations

SMS, CLOCK_HZ = 132, 1.98e9
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT_PER_S = SMS * 64 * CLOCK_HZ  # 32-bit AND and add: 16.7e12
PEAK_POPC_PER_S = SMS * 16 * CLOCK_HZ  # population count: 4.18e12


def row_map(B: int, T: int) -> int:
    """Words of the (T,) row map a batched launch reads; one instance needs none."""
    return T if B > 1 else 0


def bound_s(moved: int, int_ops: int, popcounts: int) -> float:
    """A launch's least time on the card, in seconds."""
    return max(moved / PEAK_BYTES_PER_S, int_ops / PEAK_INT_PER_S,
               popcounts / PEAK_POPC_PER_S)


def share(obs: dict, kernel: str, trace_name: str, count):
    """Percent of the roofline over the sampled launches of ``kernel``:
    the sum of their bounds over the sum of their device times.  None when
    the run's kernel is another, or when the trace's launches of the kernel
    do not line up one for one with the launches the run counted in the
    profiled chunk."""
    from perfbench import devtrace

    if obs["trace"] is None or obs["kernel"] != kernel or not obs.get("sampled"):
        return None
    times = devtrace.kernel_durations_s(obs["trace"], trace_name)
    if len(times) != obs["armed_launches"]:
        return None
    bound = sum(bound_s(*count(s["B"], s["n"], s["W"], s["T"], s["in_mask"]))
                for s in obs["sampled"].values())
    spent = sum(times[i] for i in obs["sampled"])
    return 100.0 * bound / spent
