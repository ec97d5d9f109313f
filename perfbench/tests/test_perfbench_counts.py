"""The frozen copies: the roofline counts equal ``chip_smoke.py``'s phase-2
hand count, split by pipe, and the trace union and launch count equal
hand-made lists."""

import numpy as np
import torch

from conftest import ROOT
from perfbench import devtrace, instances, roofline
from perfbench.bench import find
from perfbench.reference import bits
from perfbench.reference.problems import max_clique, vertex_cover


def _plane_masks(n, T, seed):
    rng = np.random.default_rng(seed)
    N = 32 * ((n + 31) // 32)
    m = torch.from_numpy(rng.random((T, N)) < 15 / 16)
    m[:, n:] = False
    return m


def _counter(kernel):
    return find(ROOT, "metrics", f"{kernel}.roofline").count


def test_vc_expand_count_equals_phase2_hand_count():
    from repro_torch.kernels.bitset_ops.ref import popcount_rows, vc_expand_ref, vc_reduce_step

    n, T = 200, 16
    dense = instances.gnp(n, 4.0, 0)
    W = (n + 31) // 32
    A = bits.padded_adjacency([dense], W, "cpu")
    m = _plane_masks(n, T, 1)
    s = torch.zeros_like(m)
    adj = bits.pack(A[0] > 0.5)
    mw, sw = bits.pack(m), bits.pack(s)
    # chip_smoke.py phase 2, as it stands: the sweep replay and the counts
    sweeps = vc_expand_ref(adj, mw, sw).sweeps
    in_sweeps, rm, rs = 0, mw, sw
    for k in range(int(sweeps.max())):
        in_sweeps += int(popcount_rows(rm[sweeps > k]).sum())
        rm, rs, _ = vc_reduce_step(adj, rm, rs)
    N = 32 * W
    moved = 4 * (N * W + 2 * T * W + 5 * T * W + 5 * T) + T
    ops = 3 * W * in_sweeps
    mine = vertex_cover.expand(A, m.view(1, T, N), s.view(1, T, N))
    assert int(mine["in_mask"].sum()) == in_sweeps
    got_moved, int_ops, popcounts = _counter("vc_expand")(1, N, W, T, in_sweeps)
    assert got_moved == moved and int_ops + popcounts == ops and popcounts == W * in_sweeps
    bound = max(moved / 3.35e12, int_ops / roofline.PEAK_INT_PER_S,
                popcounts / roofline.PEAK_POPC_PER_S)
    assert roofline.bound_s(got_moved, int_ops, popcounts) == bound
    # popcounts at a quarter of the integer rate: they set the compute bound
    assert popcounts / roofline.PEAK_POPC_PER_S > int_ops / roofline.PEAK_INT_PER_S


def test_clique_expand_count_equals_phase2_hand_count():
    from repro_torch.kernels.bitset_ops.ref import popcount_rows

    n, T = 300, 16
    W = (n + 31) // 32
    dense = instances.p_hat(n, 0.0, 0.5, 0)
    m = _plane_masks(n, T, 2)
    mw = bits.pack(m)
    moved = 4 * (n * W + 2 * T * W + 3 * T * W + 4 * T) + T
    ops = 3 * W * int(popcount_rows(mw).sum()) + 4 * T * W
    N = 32 * W
    mine = max_clique.expand(bits.padded_adjacency([dense], W, "cpu"),
                             m.view(1, T, N), torch.zeros_like(m).view(1, T, N))
    count = _counter("clique_expand")
    got_moved, int_ops, popcounts = count(1, n, W, T, int(mine["in_mask"].sum()))
    assert got_moved == moved and int_ops + popcounts == ops
    # a batched launch reads every instance's adjacency and the row map
    assert count(4, n, W, T, 0)[0] == moved + 4 * (3 * n * W + T)


def test_peak_rates():
    assert roofline.PEAK_INT_PER_S == 132 * 64 * 1.98e9
    assert roofline.PEAK_POPC_PER_S * 4 == roofline.PEAK_INT_PER_S


def test_union_of_intervals():
    iv = [(0, 10, "a"), (5, 12, "b"), (20, 25, "c"), (21, 22, "d"), (30, 30, "e"), (12, 14, "f")]
    assert devtrace.union_us(iv) == 14 + 5
    assert devtrace.merged(iv) == [[0, 14], [20, 25], [30, 30]]
    assert devtrace.union_us([]) == 0


def test_trace_summary_counts_launches_and_gaps():
    events = [
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 0, "dur": 2,
         "args": {"correlation": 1}},
        {"cat": "kernel", "name": "k1", "ts": 3, "dur": 4, "args": {"correlation": 1}},
        {"cat": "kernel", "name": "vc_expand_kernel<true>", "ts": 20, "dur": 5,
         "args": {"correlation": 9}},  # launched where the host trace cannot see
        {"cat": "cuda_runtime", "name": "cudaGraphLaunch", "ts": 8, "dur": 1,
         "args": {"correlation": 2}},
        {"cat": "cuda_runtime", "name": "cudaMemcpyAsync", "ts": 9, "dur": 1,
         "args": {"correlation": 3}},
        {"cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 27, "dur": 3,
         "args": {"correlation": 3}},
        {"cat": "cpu_op", "name": "aten::nonzero", "ts": 6, "dur": 16},
        {"cat": "cpu_op", "name": "aten::where", "ts": 8, "dur": 2},
        {"ph": "i", "name": "marker", "ts": 1},
    ]
    s = devtrace.summarize(events)
    assert s["launches"] == 3 and s["busy_us"] == 4 + 5 + 3
    assert devtrace.kernel_durations_s(s, "vc_expand_kernel") == [5e-6]
    b = devtrace.breakdown(s)
    assert b["device_ops"][0] == ["vc_expand_kernel<true>", 5e-6]
    assert dict(b["idle_gaps"]) == {"aten::nonzero": 13e-6, "python": 2e-6}
