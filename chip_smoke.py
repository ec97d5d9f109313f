#!/usr/bin/env python3
"""Card smoke of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of the repository, with no arguments:

  python3 chip_smoke.py

Phases (any failed check raises, so the exit code is not 0):

1. card and build — the card's name and power limit from nvidia-smi; every
   CUDA kernel of the port built from the sources in the checkout, one nvcc
   per source, all started together; the tensor-core attention kernel's
   SASS holds wgmma (HGMMA) instructions;
2. kernels vs plain — ``batched_degrees`` and ``batched_expand_stats``
   against their plain PyTorch versions on the card, exactly, over n in
   {1, 31, 33, 300, 600, 2048}, T in {1, 2, 7, 128, 1024}, random, empty,
   full and single-bit masks (and random, empty and full sols), for one
   instance and for a padded batch of 3 with a task-row map; the fused
   ``vc_expand`` (reduction loop included, trip counts too) and
   ``clique_expand`` against theirs the same way over n in {1, 31, 33,
   300, 600, 1300, 2048} (adjacency staged in shared memory up to 1300,
   read from L2 at 2048; ``vc_expand`` at T = 1024 only where n <= 600,
   where its plain version is quick); then all four timed with CUDA events
   at the solve plane's shapes, each bound counting the operations of this
   run's masks; then the composed expansion (each problem with
   ``expand_tasks=None``, the plane's fallback), which runs the two panel
   kernels: the vertex-cover goldens and ``clique_smoke`` reproduce through
   it, and its launches are the panel kernels' launches of the kernels
   line;
3. exact vertex-cover solves — ``SolverSession(device="cuda").solve``
   reproduces every solo and fpt golden of ``tests/golden_vc.json`` and the
   n = 300 golden ``src/repro_torch/data/golden_smoke.json``, all made by the
   JAX package; the covers verify and the sequential solver agrees;
4. max clique — the second path: an exact solve of ``p_hat_like(300,
   0.325, seed 0)`` (density 0.2456, the size class of DIMACS p_hat300-1)
   with 128 workers, equal to the JAX golden of
   ``src/repro_torch/data/golden_clique.json``; one ``clique_expand``
   launch per explore round and no ``batched_expand_stats``;
5. MIS — the paper's graph G(600, 4/599, seed 0) branched on its dense
   complement (W = 19), 128 workers, 64 supersteps, equal to its JAX golden;
6. the batched plane — ``solve_many`` of vertex cover on G(300, 4/299,
   seeds 0 and 1), 64 workers: instance 0 equals the n = 300 golden,
   instance 1 its own solo solve, one ``vc_expand`` launch per explore
   round for the whole batch and no ``batched_degrees``; a batch of two
   copies of seed 0 launches exactly what one solo solve does and counts
   the same reduction sweeps; and ``clique_smoke``'s configuration gives
   [4, 6, 4, 4];
7. paper size — the vertex-cover main path: G(600, 4/599, seed 0) with 128
   workers, a bounded anytime solve (``--paper-max-rounds`` supersteps),
   run twice, one ``vc_expand`` launch per explore round; prints whether
   the solve finished exact (its frontier empty before the cap);
8. LM kernels vs plain — ``flash_attention`` against its plain version and
   the f32 oracle on the JAX package's attention cases in f32 and bf16 (the
   dispatch rule sends bf16 with D % 16 == 0 to the tensor-core variant,
   the rest to the CUDA-core one), and at the serving shapes (qwen1.5-0.5b's
   prefill, starcoder2-3b's GQA widths, a window, one query against 1,057
   keys; in bf16 both variants); ``wkv6`` against ``wkv6_ref`` on the JAX
   package's cases with and without a state and at RWKV6-3B's prefill; then
   both timed at the serving shapes, both attention variants in the same
   call, beside their plain versions (and attention beside
   ``scaled_dot_product_attention``, which the port never calls);
9. the LM golden — ``src/repro_torch/data/golden_lm.json``, made by the JAX
   package for the qwen1.5, starcoder2 and rwkv6 smoke configs in f32:
   last-position logits and greedy tokens reproduced through the kernels;
10. LM serving at full width — qwen1.5-0.5b and rwkv6-3b in bf16 with the
   port's seeded init: a prefill of 4 prompts of 1,024 tokens (one kernel
   launch per layer) and greedy decode of 32 tokens; each layer's attention
   or time-mix output with the kernel against the plain op computed in f64;
   the whole bf16 forward with the kernel against the plain one, held to the
   witness gap between the plain route and its f64 twin; in f32 the kernel
   forward against the plain one; the decode path's last prompt logits
   against the forward's; and for rwkv6 the prompt as one chunk against two
   halves;
11. the live service (run after phase 7) — ``SolveService`` on the card:
   (a) lane churn, eight tickets G(300, 4/299, seeds 0-7) with distinct
   priorities through 4 lanes of 64 workers: seed 0 equals
   ``golden_smoke.json``, the others their solo solves, every cover
   verifies, one plane, exactly one ``vc_expand`` launch per explore round
   of the supersteps the plane ran (the service's ``stats()["supersteps"]``)
   and no ``batched_degrees`` (and the eight solo solves, one after
   another, timed beside the stream); (b) the paper's size in 2 lanes of 128
   workers: seed 0 equals phase 7's record, seed 1 with ``deadline=32`` is
   evicted at 32 supersteps equal to its solo solve capped there; (c) the
   asyncio front end ``repro_torch.launch.serve`` with its defaults (32
   max-clique requests, n 14-26, 8 lanes): every size equals the sequential
   reference, on ``clique_expand`` and no ``batched_expand_stats``.  Prints
   each stream's step wall (and of it, the plane's chunks, admission,
   retirement and the rest of the service's host work), occupancy, wait,
   residency, instances/s and the front end's p50/p99 latency (a smoke
   reading at n <= 26: the service's latency at the paper's size is
   measured by ``launch.serve`` itself, PERF.md section 5);
12. durability (run after phases 4, 6, 7 and 11; checkpoints under a
   ``tempfile.mkdtemp()`` directory, removed at the end) — (a) phase 7's
   solve with a checkpoint every chunk equals phase 7's record, and
   ``SolverSession.resume`` from its first, a middle and its newest
   checkpoint each equals it too, launching exactly one ``vc_expand`` per
   explore round run after the checkpoint and nothing else; each
   checkpoint's bytes, write time (the copy to the host, CRC32, ``savez``,
   manifest and rename) and load time are printed beside a chunk's wall;
   (b) phase 6's batch (a chunk a superstep) resumed mid-bucket; (c) phase
   4's max-clique solve resumed mid-solve, on ``clique_expand``; (d) phase
   11's paper-size service checkpointed after its first step, both lanes
   live, restored into a fresh service and drained: seed 0 equals phase 7,
   seed 1 is evicted at 32 equal to its capped solo solve; (e) the JAX
   package's checkpoint ``src/repro_torch/data/ckpt_jax_vc`` resumed to
   its record.  The kernels line gives the resumes' launches as
   ``resume_launches``;
13. frontier spill (run after phase 12) — the host cold tier at the paper's
   size.  The capacity C of each spilled path is 3/4 of its unsaturated
   run's peak per-worker pending over its chunk boundaries, and at least
   the no-drop headroom of one chunk plus 2; the paper size's peak (phase
   7's is printed) is under that headroom at 32 explore rounds a superstep,
   so the spilled paths run 8 (max clique: 2) a superstep, a chunk a
   superstep.  (a) G(600, 4/599, seed 0), 128 workers: phase 7's shape at
   a chunk a superstep (no capacity under its peak keeps the headroom), the
   unsaturated reference (best 304, its peak, C), the starved solve at C
   without spill
   (it drops tasks) and the spilled one at C, twice: no drop, every spilled
   task readmitted, best 304, the cover verifies, both runs identical,
   counters included, one ``vc_expand`` per explore round; its wall against
   the unsaturated one, its pumps, their time and the bytes they move each
   way; (b) max clique on ``p_hat_like(300, 0.325, seed 0)`` spilled: phase
   4's optimum, no drop, one ``clique_expand`` per explore round; (c)
   seeds 0 and 1 in 2 lanes through ``solve_many`` and ``SolveService``:
   seed 0's lane equals its spilled solo solve, the service's lanes equal
   solve_many's, spill counters included, no drop; (d) (a)'s spilled solve
   with a checkpoint every 16 chunks resumed from one whose cold tier holds
   records; (e) ``src/repro_torch/data/golden_spill.json`` (JAX records of
   spilled solves at n = 40-48) reproduced exactly and the JAX-written
   mid-spill checkpoint ``src/repro_torch/data/ckpt_jax_vc_spill``
   resumed to its record.  The kernels line gives the spilled paths'
   launches as ``spill_launches``;
14. faults (run after phase 13; ``repro_torch.faults`` plans fire at the
   host-sync boundaries, as in the JAX package) — (a) both legs of
   ``benchmarks/chaos_smoke.py`` from the JAX-made
   ``src/repro_torch/data/golden_chaos.json`` (a 3-lane spilled service
   under crashes, a stall, payload corruption and a write error; a
   checkpointed spilled solo solve under a crash and read and write errors):
   every result, ledger and injector report equal to JAX's, the answers
   equal to the fault-free run's, the totals equal to the exact pins of
   ``benchmarks/baseline.json`` (10 injected, 10 recovered, 7 retries, 2
   lanes quarantined; by kind 2/1/2/2/3), the wall ratio printed, not gated;
   (b) phase 13's spilled paper-size solve with a checkpoint every 32
   chunks under a crash at boundary 200, a read error on its recovery's
   load, two transfer and two cold-tier corruptions and a write error:
   equal to phase 13's record, ``reduce_sweeps`` included, with the
   replayed supersteps, the recovery's load time and the wall against phase
   13's printed; (c) phase 11a's lane-churn stream at 4 supersteps a chunk
   under two crashes and a 4-boundary stall (``lane_stall_chunks`` 2), each
   fired while 2 or more lanes are live and 8 or more chunks before the
   end: every ticket equal to phase 11a's, 3 lanes quarantined, 3 faults
   injected and recovered, none shed at drain, the tickets' ledgers summing
   to the service's; (d) phase 4's max clique beside a copy of itself in
   ``solve_many``, one lane crashed: both equal phase 4's golden.  Every
   faulted path launches exactly one fused expansion per explore round its
   plane runs, replays included; the kernels line gives them as
   ``fault_launches``.

Kernel launch counts are zeroed just before each path runs and read just
after it; ``flash_attention`` counts each variant on its own.  Times
(``repro_torch.launch.timing``): ``ms`` is the device time of one call from
back-to-back calls (``time_ms``), ``call_ms`` the single synchronised call
of earlier runs.  The last three lines of standard output are the kernels
JSON line, the nvidia-smi line and ``{"ok": true, "device": {...}}``.  The
script imports nothing of JAX and nothing of the JAX package ``repro``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, and the non-tensor-core
# 32-bit rate, used here for the kernel's 32-bit integer operations
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12

PAPER_GRAPH = dict(n=600, p=4.0 / 599, seed=0)
PAPER_WORKERS = 128
# superstep cap of each paper-size run: the solve finished exact in 100
# supersteps, 4.9-8.3 s a run, on an H100 at 700 W; the cap keeps a slower
# host's two runs near a minute (a superstep took 0.05-0.11 s)
PAPER_MAX_ROUNDS = 400
CLIQUE_GRAPH = dict(n=300, density=0.325, seed=0)  # edge density 0.2456
BATCH_GRAPH = dict(n=300, p=4.0 / 299)  # golden_smoke.json's family, seeds 0 and 1


def fail(msg: str):
    raise SystemExit(f"[smoke] FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def words_on(words, device):
    import numpy as np
    import torch

    arr = np.ascontiguousarray(np.asarray(words, np.uint32)).view(np.int32)
    return torch.from_numpy(arr.copy()).to(device)


def _instances(n: int, B: int, seed: int):
    """B random graphs padded to (B, n, W): instance 0 has n vertices, the
    others fewer (zero padding rows).  Returns (adj, sizes)."""
    import numpy as np

    from repro_torch.graphs.bitgraph import n_words
    from repro_torch.graphs.generators import erdos_renyi

    sizes = [n] + [max(1, n - 1 - i * (n // 3)) for i in range(B - 1)]
    adj = np.zeros((B, n, n_words(n)), np.uint32)
    for i, ni in enumerate(sizes):
        g = erdos_renyi(ni, min(1.0, 8.0 / max(ni - 1, 1)), seed + i)
        adj[i, :ni, : g.W] = g.adj
    return adj, sizes


def _row_kinds(n: int, T: int, rng) -> dict:
    """(T, W) task rows: random, empty, full, and single bits (bit 31 of a
    word whenever n > 31)."""
    import numpy as np

    from repro_torch.graphs.bitgraph import mask_full, n_words

    W = n_words(n)
    full = mask_full(n)
    single = np.zeros((T, W), np.uint32)
    v = np.arange(T) % n
    v[0] = min(31, n - 1)
    single[np.arange(T), v // 32] = np.uint32(1) << (v % 32).astype(np.uint32)
    return {
        "random": rng.integers(0, 2**32, size=(T, W), dtype=np.uint32) & full,
        "empty": np.zeros((T, W), np.uint32),
        "full": np.tile(full, (T, 1)),
        "single": single,
    }


def _bound_ms(moved: int, ops: int):
    bytes_ms = moved / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


def _in_masks(masks) -> int:
    """The vertices in a (T, W) batch of masks, summed over its rows: a
    panel's degrees are only needed for those."""
    from repro_torch.kernels.bitset_ops.ref import popcount_rows

    return int(popcount_rows(masks).sum())


def phase_kernels(dev):
    """Both kernels vs their plain versions on the card, one instance and a
    padded batch of 3; then their times at the plane's shapes.  Returns the
    kernels' fields of the kernels line (launches aside), by name."""
    import numpy as np
    import torch

    from repro_torch.graphs.bitgraph import mask_full, n_words
    from repro_torch.graphs.generators import erdos_renyi, p_hat_like
    from repro_torch.kernels.bitset_ops import (
        batched_degrees,
        batched_degrees_ref,
        batched_expand_stats,
        expand_stats_ref,
    )
    from repro_torch.launch.timing import call_ms, time_ms

    err = {"batched_degrees": 0, "batched_expand_stats": 0}
    checked = {"batched_degrees": 0, "batched_expand_stats": 0}

    def hold(name, got, want, what):
        torch.cuda.synchronize()
        e = max(int((a.long() - b.long()).abs().max()) if a.numel() else 0
                for a, b in zip(got, want))
        err[name] = max(err[name], e)
        checked[name] += 1
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"{name} != plain at {what} (max abs err {e})")

    for n in (1, 31, 33, 300, 600, 2048):
        W = n_words(n)
        for B in (1, 3):
            adj_np, sizes = _instances(n, B, n)
            adj = words_on(adj_np, dev)
            for T in (1, 2, 7, 128, 1024):
                rng = np.random.default_rng(n * 10_000 + T * 10 + B)
                inst_np = rng.integers(0, B, size=T).astype(np.int32)
                inst = None if B == 1 else torch.from_numpy(inst_np).to(dev)
                # each task's rows only hold vertices of its own instance
                own = np.zeros((T, W), np.uint32)
                for t in range(T):
                    f = mask_full(sizes[inst_np[t]])
                    own[t, : f.shape[0]] = f
                rows = {k: v & own for k, v in _row_kinds(n, T, rng).items()}
                sol_kinds = {k: rows[k] for k in ("random", "empty", "full")}
                for kind, masks in rows.items():
                    m = words_on(masks, dev)
                    what = f"n={n} B={B} T={T} masks={kind}"
                    hold("batched_degrees", [batched_degrees(adj, m, inst)],
                         [batched_degrees_ref(adj, m, inst)], what)
                    for skind, sols in sol_kinds.items():
                        s_ = words_on(sols, dev)
                        deg, pc = batched_expand_stats(adj, m, s_, inst)
                        rdeg, rpm, rps = expand_stats_ref(adj, m, s_, inst)
                        hold("batched_expand_stats", [deg, pc],
                             [rdeg, torch.stack([rpm, rps], 1)], f"{what} sols={skind}")
    for name in err:
        print(f"[smoke] {name} == plain version on {checked[name]} cases "
              f"(max abs err {err[name]})")

    out = {}
    # batched_degrees at the vertex-cover plane's shape: T = P*lanes = 128,
    # n = 600, W = 19
    n, T = PAPER_GRAPH["n"], PAPER_WORKERS
    W = n_words(n)
    rng = np.random.default_rng(0)
    adj = words_on(erdos_renyi(**PAPER_GRAPH).adj, dev)
    m = words_on(rng.integers(0, 2**32, size=(T, W), dtype=np.uint32) & mask_full(n), dev)
    kernel = lambda: batched_degrees(adj, m)
    plain = lambda: batched_degrees_ref(adj, m)
    kernel_ms, kernel_call = time_ms(kernel), call_ms(kernel)
    plain_ms, plain_call = time_ms(plain), call_ms(plain)
    moved = 4 * (n * W + T * W + T * n)  # adj and masks read once, out written once
    ops = 3 * W * _in_masks(m)  # AND, popcount, add per (vertex in a mask, word)
    bound, by = _bound_ms(moved, ops)
    print(f"[smoke] batched_degrees T={T} n={n} W={W}: kernel {kernel_ms:.6f} ms "
          f"(one call {kernel_call:.6f}), plain {plain_ms:.6f} ms (one call "
          f"{plain_call:.6f}), bound {bound:.6f} ms ({moved} B, {ops} ops)")
    out["batched_degrees"] = {
        "name": "batched_degrees",
        "route": "cuda",
        "source": "src/repro_torch/kernels/bitset_ops/csrc/degrees.cu",
        "replaces": "src/repro/kernels/bitset_ops/kernel.py:180",
        "exact": err["batched_degrees"] == 0,
        "max_abs_err": err["batched_degrees"],
        "ms": kernel_ms,
        "call_ms": kernel_call,
        "plain_ms": plain_ms,
        "plain_call_ms": plain_call,
        "bound_ms": bound,
        "bound_by": by,
        # torch has no popcount, so no single PyTorch call computes this
        "library_ms": None,
    }

    # batched_expand_stats at the max-clique plane's shape (T = 128, n = 300,
    # W = 10), and at MIS's (n = 600, W = 19) for the record
    for label, g in (("max_clique", p_hat_like(**CLIQUE_GRAPH)),
                     ("mis", erdos_renyi(**PAPER_GRAPH))):
        n, W = g.n, g.W
        adj = words_on(g.adj, dev)
        masks = rng.integers(0, 2**32, size=(T, W), dtype=np.uint32) & mask_full(n)
        sols = rng.integers(0, 2**32, size=(T, W), dtype=np.uint32) & mask_full(n) & ~masks
        m, s_ = words_on(masks, dev), words_on(sols, dev)
        kernel = lambda: batched_expand_stats(adj, m, s_)
        plain = lambda: expand_stats_ref(adj, m, s_)
        kernel_ms, kernel_call = time_ms(kernel), call_ms(kernel)
        plain_ms, plain_call = time_ms(plain), call_ms(plain)
        # adj, masks and sols read once; deg and pc written once
        moved = 4 * (n * W + 2 * T * W + T * n + 2 * T)
        # + popcount and add per mask and sol word
        ops = 3 * W * _in_masks(m) + 4 * T * W
        bound, by = _bound_ms(moved, ops)
        print(f"[smoke] batched_expand_stats ({label}) T={T} n={n} W={W}: kernel "
              f"{kernel_ms:.6f} ms (one call {kernel_call:.6f}), plain {plain_ms:.6f} ms "
              f"(one call {plain_call:.6f}), bound {bound:.6f} ms ({moved} B, {ops} ops)")
        if label == "max_clique":
            out["batched_expand_stats"] = {
                "name": "batched_expand_stats",
                "route": "cuda",
                "source": "src/repro_torch/kernels/bitset_ops/csrc/expand_stats.cu",
                "replaces": "src/repro/kernels/bitset_ops/kernel.py:138",
                "exact": err["batched_expand_stats"] == 0,
                "max_abs_err": err["batched_expand_stats"],
                "ms": kernel_ms,
                "call_ms": kernel_call,
                "plain_ms": plain_ms,
                "plain_call_ms": plain_call,
                "bound_ms": bound,
                "bound_by": by,
                "library_ms": None,  # no single PyTorch call computes a popcount panel
            }
    return out


EXPAND_NS = (1, 31, 33, 300, 600, 1300, 2048)
EXPAND_TS = (1, 2, 7, 128, 1024)


def _plane_masks(n: int, T: int, rng):
    """(T, W) masks like the VC plane's early tasks: every vertex, less a
    random sixteenth."""
    import numpy as np

    from repro_torch.graphs.bitgraph import mask_full, n_words

    drop = np.full((T, n_words(n)), 0xFFFFFFFF, np.uint32)
    for _ in range(4):
        drop &= rng.integers(0, 2**32, size=drop.shape, dtype=np.uint32)
    return np.tile(mask_full(n), (T, 1)) & ~drop


def phase_expand_kernels(dev) -> dict:
    """The fused ``vc_expand`` and ``clique_expand`` vs their plain versions,
    every output (vertex cover's trip counts too) exactly, one instance and a
    padded batch of 3 with a task-row map; then their times at the plane's
    shapes.  Returns their fields of the kernels line (launches aside)."""
    import numpy as np
    import torch

    from repro_torch.graphs.bitgraph import complement, mask_full, n_words
    from repro_torch.graphs.generators import erdos_renyi, p_hat_like
    from repro_torch.kernels.bitset_ops import (
        clique_expand,
        clique_expand_ref,
        vc_expand,
        vc_expand_ref,
    )
    from repro_torch.kernels.bitset_ops.ref import vc_reduce_step
    from repro_torch.launch.timing import call_ms, time_ms

    kernels = {"vc_expand": (vc_expand, vc_expand_ref),
               "clique_expand": (clique_expand, clique_expand_ref)}
    checked = dict.fromkeys(kernels, 0)
    for n in EXPAND_NS:
        W = n_words(n)
        for B in (1, 3):
            adj_np, sizes = _instances(n, B, n + 1)
            adj = words_on(adj_np, dev)
            for T in EXPAND_TS:
                rng = np.random.default_rng(n * 10_000 + T * 10 + B + 5)
                inst_np = rng.integers(0, B, size=T).astype(np.int32)
                inst = None if B == 1 else torch.from_numpy(inst_np).to(dev)
                own = np.zeros((T, W), np.uint32)
                for t in range(T):
                    f = mask_full(sizes[inst_np[t]])
                    own[t, : f.shape[0]] = f
                rows = {k: v & own for k, v in _row_kinds(n, T, rng).items()}
                sols = rng.integers(0, 2**32, size=(T, W), dtype=np.uint32) & own
                for kind, masks in rows.items():
                    m = words_on(masks, dev)
                    sol_kinds = {"disjoint": sols & ~masks, "empty": 0 * sols, "full": own}
                    for skind, sol in sol_kinds.items():
                        s_ = words_on(sol, dev)
                        for name, (kernel, plain) in kernels.items():
                            if name == "vc_expand" and (skind != "disjoint" or (T > 128 and n > 600)):
                                # a cover and its mask are disjoint, and the
                                # sol steers no rule: one kind, and T = 1024
                                # only up to n = 600, keep the plain
                                # version's time in bounds
                                continue
                            got, want = kernel(adj, m, s_, inst), plain(adj, m, s_, inst)
                            torch.cuda.synchronize()
                            for field, a in got._asdict().items():
                                b = getattr(want, field)
                                check((a is None) == (b is None) and (a is None or torch.equal(a, b)),
                                      f"{name} != plain version in {field} at n={n} B={B} "
                                      f"T={T} masks={kind} sols={skind}")
                            checked[name] += 1
    for name, cnt in checked.items():
        print(f"[smoke] {name} == plain version, every output, on {cnt} cases "
              f"(n in {EXPAND_NS}, T in {EXPAND_TS}, B in (1, 3)"
              f"{'; T = 1024 only where n <= 600' if name == 'vc_expand' else ''})")

    out = {}
    T = PAPER_WORKERS
    rng = np.random.default_rng(1)
    g = erdos_renyi(**PAPER_GRAPH)
    n, W = g.n, g.W
    adj = words_on(g.adj, dev)
    m = words_on(_plane_masks(n, T, rng), dev)
    s_ = torch.zeros_like(m)
    got = vc_expand(adj, m, s_)
    sweeps = got.sweeps
    kernel = lambda: vc_expand(adj, m, s_)
    plain = lambda: vc_expand_ref(adj, m, s_)
    kernel_ms, kernel_call = time_ms(kernel), call_ms(kernel)
    # the plain version takes ~0.7 s a call (its ~200 whole-batch sweeps are
    # host-bound): a few calls time it, where the defaults' 320 took ~220 s
    plain_ms = time_ms(plain, n=2, runs=3, warmup=1)
    plain_call = call_ms(plain, reps=3, warmup=1)
    # adj, masks and sols read once; five word rows and six scalars a row
    # written; AND, popcount and add per (sweep, vertex in the row's mask at
    # that sweep, word).  The masks each sweep sees are replayed with the
    # plain sweep: row t runs sweeps 0 .. sweeps[t] - 1, and reaches the
    # kernel's reduced sol after them.
    moved = 4 * (n * W + 2 * T * W + 5 * T * W + 5 * T) + T
    in_sweeps, rm, rs = 0, m, s_
    for k in range(int(sweeps.max())):
        run = sweeps > k
        in_sweeps += _in_masks(rm[run])
        rm, rs, _ = vc_reduce_step(adj, rm, rs)
    check(torch.equal(rs, got.terminal_sol), "the sweep replay of vc_expand's bound "
          "does not reach the kernel's reduced sol")
    ops = 3 * W * in_sweeps
    bound, by = _bound_ms(moved, ops)
    print(f"[smoke] vc_expand T={T} n={n} W={W} (masks: all vertices less a random "
          f"sixteenth; sweeps max {int(sweeps.max())}, mean {float(sweeps.float().mean()):.2f}; "
          f"{in_sweeps / int(sweeps.sum()):.2f} vertices in a sweep's mask on average): "
          f"kernel {kernel_ms:.6f} ms (one call {kernel_call:.6f}), plain {plain_ms:.6f} ms "
          f"(one call {plain_call:.6f}), bound {bound:.6f} ms ({moved} B, {ops} ops)")
    out["vc_expand"] = {
        "name": "vc_expand",
        "route": "cuda",
        "source": "src/repro_torch/kernels/bitset_ops/csrc/vc_expand.cu",
        "replaces": "src/repro/kernels/bitset_ops/kernel.py:180",
        "exact": True,
        "max_abs_err": 0,
        "ms": kernel_ms,
        "call_ms": kernel_call,
        "plain_ms": plain_ms,
        "plain_call_ms": plain_call,
        "bound_ms": bound,
        "bound_by": by,
        "library_ms": None,  # no single PyTorch call computes the expansion
    }

    for label, gc in (("max_clique", p_hat_like(**CLIQUE_GRAPH)),
                      ("mis", complement(erdos_renyi(**PAPER_GRAPH)))):
        n, W = gc.n, gc.W
        adj = words_on(gc.adj, dev)
        masks = rng.integers(0, 2**32, size=(T, W), dtype=np.uint32) & mask_full(n)
        sols = rng.integers(0, 2**32, size=(T, W), dtype=np.uint32) & mask_full(n) & ~masks
        m, s_ = words_on(masks, dev), words_on(sols, dev)
        kernel = lambda: clique_expand(adj, m, s_)
        plain = lambda: clique_expand_ref(adj, m, s_)
        kernel_ms, kernel_call = time_ms(kernel), call_ms(kernel)
        plain_ms, plain_call = time_ms(plain), call_ms(plain)
        # adj, masks and sols read once; three word rows and 4 scalars and a
        # flag a row written; the panel's AND, popcount and add per (vertex
        # in a row's mask, word) and popcount and add per mask and sol word
        moved = 4 * (n * W + 2 * T * W + 3 * T * W + 4 * T) + T
        ops = 3 * W * _in_masks(m) + 4 * T * W
        bound, by = _bound_ms(moved, ops)
        print(f"[smoke] clique_expand ({label}) T={T} n={n} W={W}: kernel {kernel_ms:.6f} ms "
              f"(one call {kernel_call:.6f}), plain {plain_ms:.6f} ms (one call "
              f"{plain_call:.6f}), bound {bound:.6f} ms ({moved} B, {ops} ops)")
        if label == "max_clique":
            out["clique_expand"] = {
                "name": "clique_expand",
                "route": "cuda",
                "source": "src/repro_torch/kernels/bitset_ops/csrc/clique_expand.cu",
                "replaces": "src/repro/kernels/bitset_ops/kernel.py:138",
                "exact": True,
                "max_abs_err": 0,
                "ms": kernel_ms,
                "call_ms": kernel_call,
                "plain_ms": plain_ms,
                "plain_call_ms": plain_call,
                "bound_ms": bound,
                "bound_by": by,
                "library_ms": None,
            }
    return out


def phase_composed(dev) -> dict:
    """The composed expansion on the card: vertex cover and max clique with
    ``expand_tasks=None``, so the plane composes task_bound, branch_once and
    child_bound, whose panels are the ``batched_degrees`` and
    ``batched_expand_stats`` kernels.  Every vertex-cover golden of
    ``tests/golden_vc.json`` and ``clique_smoke`` reproduce through it, and
    it launches no fused kernel.  Returns its launch counts."""
    import dataclasses

    from repro_torch.api import SolveConfig, SolverSession
    from repro_torch.graphs.generators import erdos_renyi
    from repro_torch.kernels import counts
    from repro_torch.problems.registry import get_problem

    golden = json.loads((ROOT / "tests" / "golden_vc.json").read_text())
    vc = dataclasses.replace(get_problem("vertex_cover"), expand_tasks=None)
    mc = dataclasses.replace(get_problem("max_clique"), expand_tasks=None)
    counts.reset()
    for label, c in golden["solo"].items():
        kw = dict(c["solve_kw"])
        if "policy_priority" in kw:
            kw["policy"] = "priority" if kw.pop("policy_priority") else "random"
        r = SolverSession(vc, config=SolveConfig(**kw), device=dev).solve(erdos_renyi(**c["graph"]))
        check(record(r) == c["result"], f"composed golden {label}: {record(r)} != {c['result']}")
    graphs = [erdos_renyi(20, 0.4, seed) for seed in range(4)]
    batch = SolverSession(mc, config=SolveConfig(num_workers=4, steps_per_round=8),
                          device=dev).solve_many(graphs)
    sizes = [r.best_size for r in batch.results]
    check(sizes == [4, 6, 4, 4], f"composed clique_smoke sizes {sizes} != [4, 6, 4, 4]")
    launches = counts.snapshot()
    check(launches.get("batched_degrees", 0) > 0 and launches.get("batched_expand_stats", 0) > 0
          and not launches.get("vc_expand") and not launches.get("clique_expand"),
          f"the composed expansion launched {launches}")
    print(f"[smoke] composed expansion (expand_tasks=None): {len(golden['solo'])} VC goldens "
          f"and clique_smoke {sizes} reproduce; launches={launches}")
    return launches


def record(r) -> dict:
    import numpy as np

    return {
        "best_size": int(r.best_size),
        "best_sol": [int(w) for w in np.asarray(r.best_sol, np.uint32)],
        "rounds": int(r.rounds),
        "nodes_expanded": int(r.nodes_expanded),
        "tasks_transferred": int(r.tasks_transferred),
        "transfer_rounds": int(r.stats.transfer_rounds),
        "transfer_bytes_total": int(r.stats.transfer_bytes_total),
        "overflow": bool(r.stats.overflow),
    }


def phase_goldens(dev) -> dict:
    """Every vertex-cover golden; returns the n = 300 solve's launch counts
    and reduce sweeps."""
    from repro_torch.api import SolveConfig, SolverSession
    from repro_torch.graphs.generators import erdos_renyi
    from repro_torch.kernels import counts
    from repro_torch.problems.sequential import solve_sequential, verify_cover

    golden = json.loads((ROOT / "tests" / "golden_vc.json").read_text())
    smoke = json.loads(
        (ROOT / "src" / "repro_torch" / "data" / "golden_smoke.json").read_text()
    )
    cases = []
    for label, c in golden["solo"].items():
        kw = dict(c["solve_kw"])
        if "policy_priority" in kw:
            kw["policy"] = "priority" if kw.pop("policy_priority") else "random"
        cases.append((label, c["graph"], kw, c["result"]))
    f = golden["fpt"]
    cases.append(("fpt", f["graph"], dict(num_workers=4, mode="fpt", k=f["k"]), f["result"]))
    cases.append(("smoke_n300", smoke["graph"], smoke["solve_kw"], smoke["result"]))
    for label, graph, kw, want in cases:
        g = erdos_renyi(graph["n"], graph["p"], graph["seed"])
        counts.reset()
        t0 = time.perf_counter()
        r = SolverSession(config=SolveConfig(**kw), device=dev).solve(g)
        wall = time.perf_counter() - t0
        launches = counts.snapshot()
        got = record(r)
        check(got == want, f"golden {label}: got {got}, want {want}")
        check(verify_cover(g, r.best_sol), f"golden {label}: cover does not verify")
        explore_rounds = r.rounds * SolveConfig(**kw).steps_per_round
        check(launches.get("vc_expand", 0) == explore_rounds and not launches.get("batched_degrees"),
              f"golden {label}: {launches} launches, want one vc_expand per explore "
              f"round ({explore_rounds}) and no batched_degrees")
        opt, _, _ = solve_sequential(g)
        check(opt == r.best_size, f"golden {label}: sequential optimum {opt} != {r.best_size}")
        print(f"[smoke] golden {label}: n={g.n} best={r.best_size} rounds={r.rounds} "
              f"nodes={r.nodes_expanded} transfers={r.tasks_transferred} "
              f"== JAX golden, {wall:.3f} s, launches={launches}")
    return {"launches": launches, "reduce_sweeps": r.stats.reduce_sweeps, "rounds": r.rounds}


def phase_clique_goldens(dev) -> dict:
    """Max clique (exact, p_hat_like 300) and MIS (G(600) complement, 64
    supersteps) at full size, each against its JAX golden.  Returns the
    max-clique run's launch counts."""
    from repro_torch.api import SolveConfig, SolverSession
    from repro_torch.graphs import generators
    from repro_torch.kernels import counts
    from repro_torch.problems.sequential import verify_clique, verify_independent_set

    golden = json.loads(
        (ROOT / "src" / "repro_torch" / "data" / "golden_clique.json").read_text()
    )
    check(golden["max_clique"]["graph"] == {"generator": "p_hat_like", **CLIQUE_GRAPH},
          f"golden_clique.json's max-clique graph is not {CLIQUE_GRAPH}")
    verify = {"max_clique": verify_clique, "mis": verify_independent_set}
    out = {}
    for name, run in golden.items():
        spec = run["graph"]
        g = getattr(generators, spec["generator"])(
            **{k: v for k, v in spec.items() if k != "generator"})
        cfg = SolveConfig(**run["solve_kw"])
        session = SolverSession(problem=run["problem"], config=cfg, device=dev)
        counts.reset()
        t0 = time.perf_counter()
        r = session.solve(g)
        wall = time.perf_counter() - t0
        launches = counts.snapshot()
        got = {**record(r), "overflow_count": int(r.stats.overflow_count)}
        want = run["result"]
        check(got == want, f"{name} full size: got {got}, want {want}")
        check(verify[name](g, r.best_sol), f"{name} full size: solution does not verify")
        explore_rounds = r.rounds * cfg.steps_per_round
        check(launches.get("clique_expand", 0) == explore_rounds
              and not launches.get("batched_expand_stats"),
              f"{name}: {launches} launches, want one clique_expand per explore "
              f"round ({explore_rounds}) and no batched_expand_stats")
        print(f"[smoke] {name} full size: {spec}, m={g.num_edges}, "
              f"{cfg.num_workers} workers: best={r.best_size} rounds={r.rounds} "
              f"nodes={r.nodes_expanded} transfers={r.tasks_transferred} == JAX golden; "
              f"wall={wall:.3f} s, {1e3 * wall / r.rounds:.3f} ms/superstep, "
              f"nodes/s={r.nodes_expanded / wall:.1f}, launches={launches} "
              f"({launches['clique_expand'] / explore_rounds:.2f} per explore round)")
        out[name] = launches
    return out["max_clique"]


def phase_batch(dev, solo_n300: dict) -> dict:
    """The batched plane: vertex cover on two n = 300 instances, a batch of
    two copies, and clique_smoke's max-clique configuration.  Returns the
    record of instance 1 (seed 1)."""
    from repro_torch.api import SolveConfig, SolverSession
    from repro_torch.graphs.generators import erdos_renyi
    from repro_torch.kernels import counts
    from repro_torch.problems.sequential import solve_sequential_max_clique, verify_clique

    smoke = json.loads(
        (ROOT / "src" / "repro_torch" / "data" / "golden_smoke.json").read_text()
    )
    check(smoke["graph"] == {**BATCH_GRAPH, "seed": 0}, "golden_smoke.json's graph moved")
    cfg = SolveConfig(**smoke["solve_kw"])
    session = SolverSession(config=cfg, device=dev)
    g0, g1 = (erdos_renyi(seed=s, **BATCH_GRAPH) for s in (0, 1))

    def per_round(launches, explore_rounds):
        # one vc_expand launch per explore round for the whole batch
        check(launches.get("vc_expand", 0) == explore_rounds
              and not launches.get("batched_degrees"),
              f"{launches} launches for {explore_rounds} explore rounds: want one "
              f"vc_expand per explore round and no batched_degrees")
        return launches["vc_expand"] / explore_rounds

    counts.reset()
    t0 = time.perf_counter()
    batch = session.solve_many([g0, g1])
    wall = time.perf_counter() - t0
    launches = counts.snapshot()
    r0, r1 = batch.results
    check(record(r0) == smoke["result"], f"batch instance 0: {record(r0)} != golden_smoke")
    t1 = time.perf_counter()
    solo1 = session.solve(g1)
    wall1 = time.perf_counter() - t1
    check(record(r1) == record(solo1), f"batch instance 1 {record(r1)} != solo {record(solo1)}")
    ran = max(r0.rounds, r1.rounds)  # no compaction at B = 2: the chunk loop ran this
    check(batch.compactions == 0, f"unexpected compaction: {batch.compactions}")
    sweeps = batch.lane_stats.reduce_sweeps
    rate = per_round(launches, ran * cfg.steps_per_round)
    print(f"[smoke] solve_many VC G(300, 4/299, seeds 0, 1), 64 workers: "
          f"instance 0 == golden_smoke, instance 1 == its solo solve "
          f"(best {r1.best_size}, {r1.rounds} rounds, solo wall {wall1:.3f} s, "
          f"sweeps {solo1.stats.reduce_sweeps}); batch wall {wall:.3f} s; "
          f"launches={launches}, sweeps={sweeps}: {rate:.0f} per explore round "
          f"for the whole batch")

    counts.reset()
    twins = session.solve_many([g0, g0])
    launches = counts.snapshot()
    for r in twins.results:
        check(record(r) == smoke["result"], f"twin batch: {record(r)} != golden_smoke")
    check(launches == solo_n300["launches"],
          f"a batch of two copies launched {launches}, one solo solve "
          f"{solo_n300['launches']}: the batch must launch once per explore round")
    print(f"[smoke] solve_many of two copies of seed 0: launches={launches} == "
          f"the solo solve's, sweeps {twins.lane_stats.reduce_sweeps} == "
          f"{solo_n300['reduce_sweeps']}")
    check(twins.lane_stats.reduce_sweeps == solo_n300["reduce_sweeps"],
          "a batch of two copies swept differently from one solo solve")

    graphs = [erdos_renyi(20, 0.4, seed) for seed in range(4)]
    cfg = SolveConfig(num_workers=4, steps_per_round=8)
    counts.reset()
    batch = SolverSession(problem="max_clique", config=cfg, device=dev).solve_many(graphs)
    launches = counts.snapshot()
    sizes = [r.best_size for r in batch.results]
    check(sizes == [4, 6, 4, 4], f"clique_smoke sizes {sizes} != [4, 6, 4, 4]")
    for g, r in zip(graphs, batch.results):
        check(r.best_size == solve_sequential_max_clique(g)[0] and verify_clique(g, r.best_sol),
              "clique_smoke: disagrees with the sequential reference")
    ran = max(r.rounds for r in batch.results)
    check(launches == {"clique_expand": ran * cfg.steps_per_round},
          f"clique_smoke: {launches} launches for {ran * cfg.steps_per_round} "
          f"explore rounds of the batch of 4")
    print(f"[smoke] clique_smoke on the card: sizes={sizes} (verified against the "
          f"sequential reference), launches={launches}: one per explore round "
          f"for the batch of {len(graphs)}")
    return record(r1)


def phase_paper(dev, max_rounds: int) -> tuple:
    """The main path at the paper's size, twice; returns its launch counts,
    its record and its peak per-worker pending over its chunk boundaries."""
    from repro_torch.api import SolveConfig, SolverSession
    from repro_torch.graphs.generators import erdos_renyi
    from repro_torch.kernels import counts
    from repro_torch.problems.sequential import verify_cover

    g = erdos_renyi(**PAPER_GRAPH)
    # max_rounds is checked per chunk, so the chunk is cut with it
    cfg = SolveConfig(num_workers=PAPER_WORKERS, max_rounds=max_rounds,
                      chunk_rounds=min(16, max_rounds))
    cache = _hot_cache()
    session = SolverSession(config=cfg, cache=cache, device=dev)
    print(f"[smoke] paper size: G(n={g.n}, p=4/599, seed 0), m={g.num_edges}, "
          f"{PAPER_WORKERS} workers, max_rounds={max_rounds}")
    runs = []
    launches = None
    for i in range(2):
        if i == 0:
            counts.reset()
        t0 = time.perf_counter()
        r = session.solve(g)
        wall = time.perf_counter() - t0
        if i == 0:
            launches = counts.snapshot()
        check(r.best_sol is not None and verify_cover(g, r.best_sol),
              f"paper run {i}: cover does not verify")
        check(r.stats.overflow_count == 0, f"paper run {i}: overflow {r.stats.overflow_count}")
        explore_rounds = r.rounds * cfg.steps_per_round
        exact = r.rounds < max_rounds  # the plane stopped with its frontier empty
        print(f"[smoke] paper run {i}: {'EXACT' if exact else 'anytime (cap reached)'} "
              f"best={r.best_size} rounds={r.rounds} "
              f"nodes={r.nodes_expanded} transfers={r.tasks_transferred} "
              f"wall={wall:.3f} s nodes/s={r.nodes_expanded / wall:.1f} "
              f"supersteps/s={r.rounds / wall:.3f} s/superstep={wall / r.rounds:.4f} "
              f"reduce_sweeps={r.stats.reduce_sweeps} "
              f"sweeps/explore_round={r.stats.reduce_sweeps / explore_rounds:.2f} "
              f"launches={launches}")
        runs.append(record(r))
    check(runs[0] == runs[1], f"paper runs differ: {runs[0]} vs {runs[1]}")
    check(launches == {"vc_expand": explore_rounds},
          f"the main path launched {launches}: want one vc_expand per explore round "
          f"({explore_rounds}) and nothing else")
    return launches, runs[0], max(cache.peaks)


# -- the live solve service (phase 11) --------------------------------------------


def _per_explore_round(launches: dict, name: str, steps_per_round: int, svc, rounds) -> int:
    """Check that a service's plane launched ``name`` exactly once per
    explore round for the whole plane: ``steps_per_round`` times the plane
    supersteps that its chunks ran (``stats()["supersteps"]``), which lie
    between the longest ticket's and the tickets' sum (a superstep runs only
    while some lane is live, and advances every live lane).  Returns the
    plane supersteps."""
    n, ran = launches.get(name, 0), svc.stats()["supersteps"]
    check(max(rounds) <= ran <= sum(rounds),
          f"the service's plane ran {ran} supersteps for tickets of {list(rounds)}")
    check(n == steps_per_round * ran,
          f"the service launched {n} {name} in {ran} plane supersteps: want "
          f"{steps_per_round * ran}, one per explore round")
    return ran


def _timed_cache():
    """A plane cache whose batched planes add each chunk's wall to
    ``chunk_s``: a chunk ends in the plane's own read of ``done``."""
    from repro_torch.api import PlaneCache

    class TimedCache(PlaneCache):
        chunk_s = 0.0

        def batch_plane(self, *a):
            plane = super().batch_plane(*a)

            def timed(*args, **kw):
                t = time.perf_counter()
                out = plane(*args, **kw)
                self.chunk_s += time.perf_counter() - t
                return out

            return timed

    return TimedCache()


def _timed_service(problem: str, cfg, dev):
    """A service whose host work is timed apart from its plane's chunks:
    ``admit_s`` is admission (host work and, by a synchronize, its device
    writes), ``retire_s`` the retirement of finished or evicted lanes (the
    state fetch, result extraction, freeing the lane); the rest of a step
    outside the chunks is the reads of ``done``/``rounds`` and the loop."""
    import torch

    from repro_torch.api import SolveService

    class TimedService(SolveService):
        admit_s = retire_s = 0.0

        def _admit(self):
            t = time.perf_counter()
            super()._admit()
            torch.cuda.synchronize(dev)
            self.admit_s += time.perf_counter() - t

        def _retire(self, *a):
            t = time.perf_counter()
            out = super()._retire(*a)
            self.retire_s += time.perf_counter() - t
            return out

    return TimedService(problem, cfg, device=dev, cache=_timed_cache())


def _drain_timed(svc) -> list:
    """Drain ``svc`` step by step; returns each step's wall (s)."""
    walls = []
    while not svc.idle():
        t = time.perf_counter()
        svc.step()
        walls.append(time.perf_counter() - t)
    return walls


def _service_line(label: str, svc, walls: list) -> str:
    import numpy as np

    st = svc.stats()
    n, steps = st["completed"], len(walls)
    rest = sum(walls) - svc.cache.chunk_s - svc.admit_s - svc.retire_s
    return (f"[smoke] service {label}: {n} tickets in {sum(walls):.3f} s "
            f"({n / sum(walls):.2f} inst/s), {steps} steps, step wall mean "
            f"{1e3 * np.mean(walls):.3f} ms median {1e3 * np.median(walls):.3f} ms; "
            f"plane chunks {svc.cache.chunk_s:.3f} s ({st['supersteps']} supersteps, "
            f"{1e3 * svc.cache.chunk_s / st['supersteps']:.3f} ms each); host work: "
            f"admission {svc.admit_s:.3f} s ({1e3 * svc.admit_s / n:.3f} ms an admission), "
            f"retirement {svc.retire_s:.3f} s ({1e3 * svc.retire_s / n:.3f} ms a ticket), "
            f"the rest {rest:.3f} s ({1e3 * rest / steps:.3f} ms a step); occupancy "
            f"{st['occupancy']:.4f}, wait mean {st['wait_s_mean']:.4f} s, residency mean "
            f"{st['residency_s_mean']:.4f} s, evicted {st['evicted']}, planes {st['planes']}")


def phase_service(dev, paper: dict, max_rounds: int) -> dict:
    """The live service on the card: (a) lane churn of eight n = 300 tickets
    through 4 lanes, (b) the paper's size in a 2-lane service with a
    superstep deadline, (c) the asyncio front end ``repro_torch.launch.serve``
    with its defaults.  Returns each path's launch counts, under
    ``"capped"`` the record of seed 1's solo solve capped at 32 supersteps,
    and under ``"churn_records"`` the lane churn's records, seed by seed."""
    import numpy as np

    from repro_torch.api import SolveConfig, SolverSession
    from repro_torch.graphs.generators import erdos_renyi
    from repro_torch.kernels import counts
    from repro_torch.launch import serve
    from repro_torch.problems.sequential import solve_sequential_max_clique, verify_cover

    out = {}
    # (a) lane churn at the goldens' size: 8 tickets, 4 lanes, distinct priorities
    smoke = json.loads(
        (ROOT / "src" / "repro_torch" / "data" / "golden_smoke.json").read_text()
    )
    cfg = SolveConfig(**smoke["solve_kw"], service_lanes=4)
    check(cfg.num_workers == 64, f"golden_smoke.json's config moved: {smoke['solve_kw']}")
    graphs = [erdos_renyi(seed=s, **BATCH_GRAPH) for s in range(8)]
    svc = _timed_service("vertex_cover", cfg, dev)
    tickets = [svc.submit(g, priority=(3 * s) % 8) for s, g in enumerate(graphs)]
    counts.reset()
    walls = _drain_timed(svc)
    launches = counts.snapshot()
    results = [svc.result(t) for t in tickets]
    check(record(results[0]) == smoke["result"],
          f"service ticket of seed 0: {record(results[0])} != golden_smoke")
    session = SolverSession(config=cfg, device=dev)
    solo_s = 0.0
    for s, (g, r) in enumerate(zip(graphs, results)):
        check(verify_cover(g, r.best_sol), f"service seed {s}: cover does not verify")
        t = time.perf_counter()
        solo = session.solve(g)
        solo_s += time.perf_counter() - t
        got, want = ({**record(x), "overflow_count": x.stats.overflow_count}
                     for x in (r, solo))
        check(got == want, f"service seed {s}: {got} != its solo solve {want}")
    check(svc.cache_stats()["planes"] == 1, f"the churn built {svc.cache_stats()} planes")
    check(not launches.get("batched_degrees"), f"the service launched {launches}")
    rounds = [r.rounds for r in results]
    ran = _per_explore_round(launches, "vc_expand", cfg.steps_per_round, svc, rounds)
    out["churn"] = launches
    out["churn_records"] = [record(r) for r in results]
    print(_service_line("lane churn, G(300, 4/299, seeds 0-7), 64 workers, 4 lanes",
                        svc, walls))
    print(f"[smoke] service lane churn: seed 0 == golden_smoke, seeds 0-7 == their "
          f"solo solves (rounds {rounds}; the eight solo solves one after another "
          f"{solo_s:.3f} s); launches={launches}: one per explore round of {ran} "
          f"plane supersteps, for {sum(rounds)} ticket supersteps")

    # (b) the paper's size: seed 0 to its optimum beside seed 1 evicted at 32
    cfg = SolveConfig(num_workers=PAPER_WORKERS, max_rounds=max_rounds,
                      chunk_rounds=min(16, max_rounds), service_lanes=2)
    g0, g1 = (erdos_renyi(**{**PAPER_GRAPH, "seed": s}) for s in (0, 1))
    svc = _timed_service("vertex_cover", cfg, dev)
    t0, t1 = svc.submit(g0), svc.submit(g1, deadline=32)
    counts.reset()
    walls = _drain_timed(svc)
    launches = counts.snapshot()
    r0, r1 = svc.result(t0), svc.result(t1)
    check(record(r0) == paper, f"service paper seed 0: {record(r0)} != phase 7's {paper}")
    check(r1.stats.service.deadline_hit and r1.rounds == 32,
          f"service paper seed 1: deadline_hit={r1.stats.service.deadline_hit} "
          f"rounds={r1.rounds}, want an eviction at 32 supersteps")
    capped = SolverSession(config=cfg.replace(max_rounds=32), device=dev).solve(g1)
    check(record(r1) == record(capped),
          f"service paper seed 1: {record(r1)} != its solo solve capped at 32 {record(capped)}")
    out["capped"] = record(capped)
    check(verify_cover(g0, r0.best_sol) and verify_cover(g1, r1.best_sol),
          "service paper size: a cover does not verify")
    check(not launches.get("batched_degrees"), f"the service launched {launches}")
    _per_explore_round(launches, "vc_expand", cfg.steps_per_round, svc, [r0.rounds, r1.rounds])
    out["paper"] = launches
    print(_service_line("paper size, G(600, 4/599, seeds 0, 1), 128 workers, 2 lanes",
                        svc, walls))
    print(f"[smoke] service paper size: seed 0 == phase 7 (best {r0.best_size}, "
          f"{r0.rounds} supersteps); seed 1 evicted at {r1.rounds} supersteps, best "
          f"{r1.best_size} == its capped solo solve; launches={launches}")

    # (c) the asyncio front end, its defaults on the card
    argv = ["--device", str(dev)]
    args = serve.parse_args(argv)
    graphs = [g for _, g in serve.build_requests(args, np.random.default_rng(args.seed))]
    counts.reset()
    res = serve.main(argv)
    launches = counts.snapshot()
    want = [solve_sequential_max_clique(g)[0] for g in graphs]
    check(res["best_sizes"] == want and len(want) == args.requests,
          f"launch.serve answered {res['best_sizes']}, the sequential reference {want}")
    check(launches.get("clique_expand", 0) > 0 and not launches.get("batched_expand_stats"),
          f"launch.serve launched {launches}: want clique_expand and no "
          f"batched_expand_stats")
    out["serve"] = launches
    print(f"[smoke] service asyncio front end (launch.serve defaults: {args.requests} "
          f"max-clique requests, n {args.n_min}-{args.n}, {args.lanes} lanes, "
          f"{args.workers} workers): every size == the sequential reference; "
          f"a smoke reading at n <= {args.n}, not the service's latency: "
          f"p50 {1e3 * res['latency_p50_s']:.3f} ms p99 "
          f"{1e3 * res['latency_p99_s']:.3f} ms, {res['instances_per_s']:.3f} inst/s, "
          f"{res['steps']} steps, occupancy {res['occupancy']:.4f}; launches={launches}")
    return out


# -- durability on the card (phase 12) -----------------------------------------


@contextlib.contextmanager
def _timed_calls(spans: dict, targets: dict):
    """Wrap ``getattr(owner, attr)`` for each ``name: (owner, attr)`` of
    ``targets`` so each call appends its wall (s) to ``spans[name]``; the
    originals (a class's own descriptors: a classmethod stays one) are put
    back on exit."""
    saved = {name: getattr(owner, attr) for name, (owner, attr) in targets.items()}
    raw = {name: vars(owner).get(attr, saved[name]) for name, (owner, attr) in targets.items()}

    def wrap(name, fn):
        def timed(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                spans.setdefault(name, []).append(time.perf_counter() - t)
        return timed

    for name, (owner, attr) in targets.items():
        setattr(owner, attr, wrap(name, saved[name]))
    try:
        yield spans
    finally:
        for name, (owner, attr) in targets.items():
            setattr(owner, attr, raw[name])


def _dir_bytes(path) -> int:
    return sum(p.stat().st_size for p in Path(path).rglob("*") if p.is_file())


def _step_dirs(d) -> list:
    return sorted((p for p in Path(d).iterdir() if p.name.startswith("step_")),
                  key=lambda p: int(p.name[5:]))


def _resume_checked(label: str, step_dir, want: dict, kernel: str, dev,
                    extra=None) -> tuple:
    """Resume ``step_dir`` on the card; check its record against ``want``
    and that it launched exactly one ``kernel`` per explore round it ran
    after the checkpoint and nothing else.  Returns (launches, result)."""
    from repro_torch.api import SolverSession
    from repro_torch.checkpoint.solve import SolveCheckpoint
    from repro_torch.kernels import counts

    ck = SolveCheckpoint.load(str(step_dir))
    spr = ck.config["steps_per_round"]
    counts.reset()
    t = time.perf_counter()
    r = SolverSession.resume(str(step_dir), device=dev, checkpoint_dir=None)
    wall = time.perf_counter() - t
    launches = counts.snapshot()
    results = r.results if hasattr(r, "results") else [r]
    got = [{**record(x), **(extra(x) if extra else {})} for x in results]
    check(got == want, f"{label}: resumed {got} != uninterrupted {want}")
    ran = max(x.rounds for x in results) - ck.rounds
    check(launches == {kernel: ran * spr},
          f"{label}: the resume from {Path(step_dir).name} launched {launches}: "
          f"want {ran * spr} {kernel}, one per explore round of its {ran} "
          f"supersteps, and nothing else")
    print(f"[smoke] durability {label}: resumed from {Path(step_dir).name} "
          f"(at superstep {ck.rounds}) == the uninterrupted run; {ran} supersteps "
          f"in {wall:.3f} s (loads included); launches={launches}")
    return launches, r


def phase_durability(dev, paper: dict, batch_seed1: dict, capped_seed1: dict,
                     max_rounds: int) -> dict:
    """Checkpoint and resume on the card: (a) the paper-size VC solve with a
    checkpoint every chunk, resumed from its first, a middle and its newest
    checkpoint; (b) phase 6's batch resumed mid-bucket; (c) phase 4's exact
    max-clique solve resumed from a middle step; (d) phase 11's paper-size
    service checkpointed after its first step and restored into a fresh
    service; (e) the JAX package's checkpoint ``src/repro_torch/data/
    ckpt_jax_vc``.  Returns the resumes' launch counts per kernel."""
    import torch

    from repro_torch.api import PlaneCache, SolveConfig, SolverSession, SolveService
    from repro_torch.api import backends
    from repro_torch.checkpoint import store
    from repro_torch.checkpoint.solve import SolveCheckpoint
    from repro_torch.core.superstep import worker_state_from_flat
    from repro_torch.graphs import generators
    from repro_torch.graphs.generators import erdos_renyi
    from repro_torch.kernels import counts

    import numpy as np

    out = {"vc_expand": 0, "clique_expand": 0}
    root = tempfile.mkdtemp(prefix="smoke_ckpt_")
    try:
        # (a) the main path at the paper's size, a checkpoint every chunk
        g = erdos_renyi(**PAPER_GRAPH)
        cfg = SolveConfig(num_workers=PAPER_WORKERS, max_rounds=max_rounds,
                          chunk_rounds=min(16, max_rounds), checkpoint_every=1)
        d = os.path.join(root, "paper")
        spans: dict = {}
        with _timed_calls(spans, {
            "write": (backends, "_write_solo_checkpoint"),
            "copy": (backends, "worker_state_to_flat"),
            "crc": (store, "array_checksum"),
            "savez": (np, "savez"),
        }):
            t = time.perf_counter()
            r = SolverSession(config=cfg, device=dev).solve(g, checkpoint_dir=d)
            wall = time.perf_counter() - t
        check(record(r) == paper, f"durable paper solve: {record(r)} != phase 7's {paper}")
        steps = _step_dirs(d)
        n_ck = len(steps)
        check(r.stats.checkpoints_written == n_ck > 2,
              f"durable paper solve wrote {r.stats.checkpoints_written} checkpoints, "
              f"{n_ck} on disk: want one a chunk but the last")
        chunks = -(-r.rounds // cfg.chunk_rounds)
        chunk_s = (wall - sum(spans["write"])) / chunks
        per = len(spans["crc"]) // n_ck  # one CRC32 per array of a checkpoint
        crc_per = [sum(spans["crc"][i * per:(i + 1) * per]) for i in range(n_ck)]
        print(f"[smoke] durability paper size: {r.rounds} supersteps in {wall:.3f} s "
              f"with {n_ck} checkpoints (one a chunk of {cfg.chunk_rounds}; "
              f"a chunk's wall without its write {1e3 * chunk_s:.3f} ms); == phase 7")
        for i, step_dir in enumerate(steps):
            t = time.perf_counter()
            ck = SolveCheckpoint.load(str(step_dir))
            load_s = time.perf_counter() - t
            t = time.perf_counter()
            worker_state_from_flat(ck.arrays, dev)
            torch.cuda.synchronize(dev)
            h2d_s = time.perf_counter() - t
            write = spans["write"][i]
            rest = write - spans["copy"][i] - crc_per[i] - spans["savez"][i]
            print(f"[smoke]   {step_dir.name}: {_dir_bytes(step_dir)} bytes; write "
                  f"{1e3 * write:.3f} ms (copy to host {1e3 * spans['copy'][i]:.3f}, "
                  f"CRC32 {1e3 * crc_per[i]:.3f}, savez {1e3 * spans['savez'][i]:.3f}, "
                  f"manifest and rename {1e3 * rest:.3f}); load {1e3 * load_s:.3f} ms "
                  f"+ to the card {1e3 * h2d_s:.3f} ms; a chunk {1e3 * chunk_s:.3f} ms")
        for step_dir in (steps[0], steps[len(steps) // 2], steps[-1]):
            launches, _ = _resume_checked("paper size", step_dir, [paper], "vc_expand", dev)
            out["vc_expand"] += launches.get("vc_expand", 0)

        # (b) the batched plane: phase 6's batch, resumed mid-bucket (a chunk
        # a superstep: the batch is done in a few supersteps)
        smoke = json.loads(
            (ROOT / "src" / "repro_torch" / "data" / "golden_smoke.json").read_text()
        )
        cfg = SolveConfig(**smoke["solve_kw"], chunk_rounds=1, checkpoint_every=1)
        d = os.path.join(root, "batch")
        g0, g1 = (erdos_renyi(seed=s, **BATCH_GRAPH) for s in (0, 1))
        batch = SolverSession(config=cfg, device=dev).solve_many([g0, g1], checkpoint_dir=d)
        want = [smoke["result"], batch_seed1]
        check([record(x) for x in batch.results] == want,
              "durable batch: results differ from phase 6's")
        steps = _step_dirs(d)
        check(len(steps) > 2, f"durable batch wrote {len(steps)} checkpoints")
        launches, _ = _resume_checked("batch (solve_many)", steps[len(steps) // 2], want,
                                      "vc_expand", dev)
        out["vc_expand"] += launches.get("vc_expand", 0)

        # (c) max clique: phase 4's exact solve, resumed from a middle step
        golden = json.loads(
            (ROOT / "src" / "repro_torch" / "data" / "golden_clique.json").read_text()
        )["max_clique"]
        spec = golden["graph"]
        g = getattr(generators, spec["generator"])(
            **{k: v for k, v in spec.items() if k != "generator"})
        cfg = SolveConfig(**golden["solve_kw"], checkpoint_every=1)
        d = os.path.join(root, "clique")
        r = SolverSession(problem="max_clique", config=cfg, device=dev).solve(
            g, checkpoint_dir=d)
        with_overflow = lambda x: {"overflow_count": int(x.stats.overflow_count)}  # noqa: E731
        check({**record(r), **with_overflow(r)} == golden["result"],
              "durable max clique: differs from golden_clique.json")
        steps = _step_dirs(d)
        check(len(steps) >= 1, "durable max clique wrote no checkpoint")
        launches, _ = _resume_checked("max clique", steps[len(steps) // 2],
                                      [golden["result"]], "clique_expand", dev,
                                      extra=with_overflow)
        out["clique_expand"] += launches.get("clique_expand", 0)

        # (d) the live service at the paper's size, checkpointed while both
        # lanes are live, restored into a fresh service and drained
        cfg = SolveConfig(num_workers=PAPER_WORKERS, max_rounds=max_rounds,
                          chunk_rounds=min(16, max_rounds), service_lanes=2)
        g0, g1 = (erdos_renyi(**{**PAPER_GRAPH, "seed": s}) for s in (0, 1))
        svc = SolveService("vertex_cover", cfg, device=dev)
        t0, t1 = svc.submit(g0), svc.submit(g1, deadline=32)
        svc.step()
        check(svc.status()["planes"] and svc.tickets() == [t0, t1]
              and not svc.ready(t0) and not svc.ready(t1),
              f"service: both lanes must be live after the first step: {svc.status()}")
        d = os.path.join(root, "service")
        t = time.perf_counter()
        path = svc.checkpoint(d)
        write_s = time.perf_counter() - t
        t = time.perf_counter()
        back = SolveService.restore(d, cache=PlaneCache(), device=dev)
        torch.cuda.synchronize(dev)
        restore_s = time.perf_counter() - t
        before = back.stats()["supersteps"]
        counts.reset()
        t = time.perf_counter()
        back.drain()
        drain_s = time.perf_counter() - t
        launches = counts.snapshot()
        r0, r1 = back.result(t0), back.result(t1)
        check(record(r0) == paper, f"restored service seed 0: {record(r0)} != phase 7's")
        check(r1.stats.service.deadline_hit and r1.rounds == 32 and record(r1) == capped_seed1,
              f"restored service seed 1: {record(r1)}, deadline_hit="
              f"{r1.stats.service.deadline_hit}: want an eviction at 32 supersteps "
              f"equal to its capped solo solve")
        ran = back.stats()["supersteps"] - before
        check(launches == {"vc_expand": cfg.steps_per_round * ran},
              f"restored service launched {launches} in {ran} plane supersteps: want "
              f"one vc_expand per explore round and nothing else")
        out["vc_expand"] += launches.get("vc_expand", 0)
        print(f"[smoke] durability service (paper size, 2 lanes of {PAPER_WORKERS}): "
              f"checkpoint after step 1 {_dir_bytes(path)} bytes in {1e3 * write_s:.3f} ms, "
              f"restore {1e3 * restore_s:.3f} ms; drained {ran} plane supersteps in "
              f"{drain_s:.3f} s: seed 0 == phase 7, seed 1 evicted at 32 == its capped "
              f"solo solve; launches={launches}")

        # (e) a checkpoint written by the JAX package, resumed on the card
        fixture = ROOT / "src" / "repro_torch" / "data" / "ckpt_jax_vc"
        doc = json.loads((fixture / "record.json").read_text())
        launches, _ = _resume_checked("JAX-written checkpoint", fixture / f"step_{doc['step']}",
                                      [doc["result"]], "vc_expand", dev)
        out["vc_expand"] += launches.get("vc_expand", 0)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


# -- frontier spill on the card (phase 13) ----------------------------------------
#
# The hot capacity C of the spilled solves is taken from the unsaturated run
# itself: its peak per-worker pending over the chunk boundaries (where the
# pump looks), C = 3/4 of it.  Below the peak, the same solve without spill
# must drop tasks; C must also leave the no-drop headroom of one chunk
# (chunk_headroom + 2 slots), so the spilled paths run a chunk a superstep
# and fewer explore rounds a superstep than phase 7.

SPILL_FRACTION = 0.75
# the spilled paths' chunk shapes: at 32 explore rounds a superstep the paper
# size's peak is under the headroom of one chunk even at a chunk a superstep
# (34 + 2 slots; phase 13 (a) shows it), at 8 the headroom is 10; max
# clique's per-worker pending at 128 workers stays under 10, so its spilled
# path runs 2 explore rounds a superstep (headroom 4)
SPILL_VC = dict(steps_per_round=8, chunk_rounds=1)
SPILL_CLIQUE = dict(steps_per_round=2, chunk_rounds=1)


def spill_record(r) -> dict:
    """``record`` plus the drop and spill counters (the keys of
    ``golden_spill.json`` and ``ckpt_jax_vc_spill/record.json``)."""
    s = r.stats
    return {**record(r), "overflow_count": int(s.overflow_count),
            "spilled_tasks": int(s.spilled_tasks),
            "readmitted_tasks": int(s.readmitted_tasks),
            "cold_bytes_peak": int(s.cold_bytes_peak)}


def _spill_extra(r) -> dict:
    return {k: v for k, v in spill_record(r).items() if k not in record(r)}


def _hot_cache():
    """A plane cache whose planes (solo and batched) record, per chunk, the
    largest per-worker pending count (``hot``) in ``peaks``, and add the
    chunk's superstep count to ``ran``."""
    from repro_torch.api import PlaneCache

    class HotCache(PlaneCache):
        def __init__(self):
            super().__init__()
            self.peaks = []
            self.ran = 0

        def _get(self, *a):
            plane = super()._get(*a)

            def recorded(*args, **kw):
                out = plane(*args, **kw)
                self.peaks.append(int(out[-1].max()))
                self.ran += int(out[-2])
                return out

            return recorded

    return HotCache()


@contextlib.contextmanager
def _pump_meter():
    """Count and time the spill pumps (each synchronised at its end) and the
    bytes their pool reads and write-backs move between the card and the
    host; yields the running totals."""
    import numpy as np
    import torch

    from repro_torch.core import frontier, spill

    m = {"pumps": 0, "pump_s": 0.0, "reads": 0, "d2h_bytes": 0, "writes": 0,
         "h2d_bytes": 0}
    saved = {name: getattr(owner, name) for owner, name in (
        (spill.FrontierSpiller, "pump_frontier"), (spill.FrontierSpiller, "pump_lane"),
        (frontier, "read_pool"), (frontier, "write_pool"))}

    def pump(fn):
        def timed(*a, **kw):
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            m["pumps"] += 1
            m["pump_s"] += time.perf_counter() - t
            return out
        return timed

    def read(f, lane=None):
        arrays = saved["read_pool"](f, lane)
        m["reads"] += 1
        m["d2h_bytes"] += sum(a.nbytes for a in arrays)
        return arrays

    def write(f, masks, sols, depths, active, lane=None):
        m["writes"] += 1
        m["h2d_bytes"] += sum(np.asarray(a).nbytes for a in (masks, sols, depths, active))
        return saved["write_pool"](f, masks, sols, depths, active, lane)

    spill.FrontierSpiller.pump_frontier = pump(saved["pump_frontier"])
    spill.FrontierSpiller.pump_lane = pump(saved["pump_lane"])
    frontier.read_pool = read
    frontier.write_pool = write
    try:
        yield m
    finally:
        spill.FrontierSpiller.pump_frontier = saved["pump_frontier"]
        spill.FrontierSpiller.pump_lane = saved["pump_lane"]
        frontier.read_pool = saved["read_pool"]
        frontier.write_pool = saved["write_pool"]


def _meter_line(m: dict) -> str:
    return (f"{m['pumps']} pumps in {m['pump_s']:.3f} s; {m['reads']} pool reads "
            f"{m['d2h_bytes']} bytes to the host, {m['writes']} write-backs "
            f"{m['h2d_bytes']} bytes to the card")


def _reference(label: str, problem: str, g, kw: dict, dev, need_room: bool = True) -> tuple:
    """The unsaturated reference of a spilled path: its solve at ``kw``,
    with the peak per-worker pending over its chunk boundaries (where the
    pump looks).  Returns (its spill_record, the peak, the capacity C =
    SPILL_FRACTION of the peak, its wall); where C would not lie between
    the no-drop headroom and the peak, C is None, and with ``need_room``
    the phase fails."""
    from repro_torch.api import SolveConfig, SolverSession
    from repro_torch.core.spill import chunk_headroom

    cfg = SolveConfig(**kw)
    head = chunk_headroom(chunk_rounds=cfg.chunk_rounds, steps_per_round=cfg.steps_per_round,
                          lanes=cfg.lanes, donate_k=cfg.donate_k)
    cache = _hot_cache()
    t = time.perf_counter()
    r = SolverSession(problem=problem, config=cfg, cache=cache, device=dev).solve(g)
    wall = time.perf_counter() - t
    rec = spill_record(r)
    check(rec["overflow_count"] == 0, f"{label} unsaturated dropped tasks: {rec}")
    peak = max(cache.peaks)
    C = max(head + 2, int(SPILL_FRACTION * peak))
    if C >= peak:
        check(not need_room, f"{label}: the unsaturated peak {peak} leaves no capacity "
                             f"between the headroom {head} + 2 and the peak")
        C = None
    print(f"[smoke] spill {label} unsaturated at {kw}: best={rec['best_size']} "
          f"rounds={rec['rounds']} in {wall:.3f} s; peak per-worker pending over "
          f"{len(cache.peaks)} chunk boundaries {peak}, headroom {head}: C = "
          f"{C if C is not None else 'none (no room under the peak)'}")
    return rec, peak, C, wall


def _spilled(label: str, problem: str, g, cfg, dev, kernel: str) -> tuple:
    """One spilled solve on the card: no drop, every spilled task readmitted,
    one ``kernel`` launch per explore round.  Returns (result, spill_record,
    wall, pump meter)."""
    from repro_torch.api import SolverSession
    from repro_torch.kernels import counts

    counts.reset()
    with _pump_meter() as m:
        t = time.perf_counter()
        r = SolverSession(problem=problem, config=cfg, device=dev).solve(g)
        wall = time.perf_counter() - t
    launches = counts.snapshot()
    rec = spill_record(r)
    check(rec["overflow_count"] == 0 and not rec["overflow"],
          f"{label}: the spilled solve dropped {rec['overflow_count']} tasks")
    check(rec["spilled_tasks"] > 0 and rec["readmitted_tasks"] == rec["spilled_tasks"],
          f"{label}: spilled {rec['spilled_tasks']}, readmitted {rec['readmitted_tasks']}")
    explore_rounds = r.rounds * cfg.steps_per_round
    check(launches == {kernel: explore_rounds},
          f"{label}: the spilled solve launched {launches}: want one {kernel} per explore "
          f"round ({explore_rounds}) and nothing else")
    return r, rec, wall, m, launches


def _cold_rows(arrays: dict) -> int:
    return sum(v.shape[0] for k, v in arrays.items()
               if k.rsplit("/", 1)[-1].startswith("spill") and ".w" in k)


def _build_graph(spec: dict):
    from repro_torch.graphs import generators

    return getattr(generators, spec["generator"])(
        **{k: v for k, v in spec.items() if k != "generator"})


def phase_spill(dev, paper: dict, paper_peak: int, max_rounds: int) -> dict:
    """Frontier spill on the card: (a) the paper's size solo, unsaturated,
    starved and spilled (twice); (b) max clique spilled; (c) the paper size
    in 2 lanes through ``solve_many`` and ``SolveService``, spilled; (d) (a)'s
    spilled solve resumed from a checkpoint whose cold tier holds records;
    (e) the JAX-made ``golden_spill.json`` and the JAX-written mid-spill
    checkpoint.  Returns each kernel's launches on the spilled paths and,
    under ``"paper"``, (a)'s spilled solve: its config, record, reduce
    sweeps and wall."""
    from repro_torch.api import SolveConfig, SolverSession, SolveService
    from repro_torch.checkpoint.solve import SolveCheckpoint
    from repro_torch.core.spill import chunk_headroom
    from repro_torch.graphs.generators import erdos_renyi
    from repro_torch.kernels import counts
    from repro_torch.problems.sequential import verify_clique, verify_cover

    out = {"vc_expand": 0, "clique_expand": 0}
    head16 = chunk_headroom(chunk_rounds=16, steps_per_round=32, lanes=1, donate_k=1)
    print(f"[smoke] spill: phase 7's peak per-worker pending over its chunk boundaries "
          f"is {paper_peak}, under one chunk's headroom of {head16} + 2 slots")

    # (a) the paper's size, solo: phase 7's shape a chunk a superstep has no
    # room either; the spilled shape's unsaturated reference, the starved
    # solve and the spilled one, twice
    g = erdos_renyi(**PAPER_GRAPH)
    base = dict(num_workers=PAPER_WORKERS, max_rounds=max_rounds)
    _reference("paper size", "vertex_cover", g, {**base, "chunk_rounds": 1}, dev,
               need_room=False)
    kw = {**base, **SPILL_VC}
    unsat, peak, C, wall_unsat = _reference("paper size", "vertex_cover", g, kw, dev)
    check(unsat["best_size"] == paper["best_size"],
          f"paper size at {kw}: best {unsat['best_size']} != phase 7's {paper['best_size']}")
    cfg = SolveConfig(**kw, capacity=C)
    starved = SolverSession(config=cfg, device=dev).solve(g)
    check(starved.stats.overflow_count > 0,
          f"paper size starved at C={C}: no task dropped (peak {peak})")
    spilled_cfg = cfg.replace(frontier_spill=True)
    runs = []
    for i in range(2):
        r, rec, wall, m, launches = _spilled(f"paper size run {i}", "vertex_cover", g,
                                             spilled_cfg, dev, "vc_expand")
        check(rec["best_size"] == paper["best_size"] and verify_cover(g, r.best_sol),
              f"paper size spilled run {i}: best {rec['best_size']} (want "
              f"{paper['best_size']}) or its cover does not verify")
        if i == 0:
            out["vc_expand"] += launches["vc_expand"]
            out["paper"] = {"cfg": spilled_cfg, "record": rec, "wall": wall,
                            "reduce_sweeps": r.stats.reduce_sweeps}
        runs.append(rec)
        print(f"[smoke] spill paper size run {i}: C={C}: best={rec['best_size']} rounds="
              f"{rec['rounds']} nodes={rec['nodes_expanded']} spilled={rec['spilled_tasks']} "
              f"readmitted={rec['readmitted_tasks']} cold_peak={rec['cold_bytes_peak']}B "
              f"overflow=0; wall {wall:.3f} s = {wall / wall_unsat:.3f}x the unsaturated "
              f"{wall_unsat:.3f} s; {_meter_line(m)}; launches={launches}")
    check(runs[0] == runs[1], f"paper size spilled runs differ: {runs[0]} vs {runs[1]}")
    print(f"[smoke] spill paper size: starved at C={C} dropped "
          f"{starved.stats.overflow_count} tasks (best {starved.best_size}); spilled at the "
          f"same C dropped none, twice identical")

    # (b) max clique, spilled
    golden = json.loads(
        (ROOT / "src" / "repro_torch" / "data" / "golden_clique.json").read_text()
    )["max_clique"]
    gc = _build_graph(golden["graph"])
    ckw = {**golden["solve_kw"], **SPILL_CLIQUE}
    cunsat, cpeak, cC, cwall = _reference("max clique", "max_clique", gc, ckw, dev)
    check(cunsat["best_size"] == golden["result"]["best_size"],
          f"max clique at {ckw}: best {cunsat['best_size']} != phase 4's")
    r, rec, wall, m, launches = _spilled(
        "max clique", "max_clique", gc, SolveConfig(**ckw, capacity=cC, frontier_spill=True),
        dev, "clique_expand")
    check(rec["best_size"] == golden["result"]["best_size"] and verify_clique(gc, r.best_sol),
          f"max clique spilled: best {rec['best_size']} != phase 4's or no clique")
    out["clique_expand"] += launches["clique_expand"]
    print(f"[smoke] spill max clique {golden['graph']}: C={cC}: best={rec['best_size']} "
          f"== phase 4, rounds={rec['rounds']} spilled={rec['spilled_tasks']} "
          f"cold_peak={rec['cold_bytes_peak']}B overflow=0; wall {wall:.3f} s = "
          f"{wall / cwall:.3f}x the unsaturated {cwall:.3f} s; {_meter_line(m)}; "
          f"launches={launches}")

    # (c) the paper size in 2 lanes, solve_many and the service, spilled.
    # Seed 1 does not finish exact in 1,600 supersteps of 32 explore rounds
    # (an H100 run), so its anytime lane is held to its solve_many twin;
    # seed 0's lane equals its spilled solo solve
    g1 = erdos_renyi(**{**PAPER_GRAPH, "seed": 1})
    counts.reset()
    with _pump_meter() as m:
        t = time.perf_counter()
        batch = SolverSession(config=spilled_cfg, device=dev).solve_many([g, g1])
        wall = time.perf_counter() - t
    launches = counts.snapshot()
    recs = [spill_record(x) for x in batch.results]
    ran = max(x["rounds"] for x in recs)  # 2 lanes never compact
    check(batch.compactions == 0 and launches == {"vc_expand": ran * cfg.steps_per_round},
          f"spilled batch: {launches} in {ran} plane supersteps")
    out["vc_expand"] += launches["vc_expand"]
    check(recs[0] == runs[0], f"spilled batch seed 0: {recs[0]} != its solo {runs[0]}")
    check(recs[1]["overflow_count"] == 0 and recs[1]["spilled_tasks"] > 0
          and verify_cover(g1, batch.results[1].best_sol),
          f"spilled batch seed 1: {recs[1]}")
    print(f"[smoke] spill solve_many G(600, 4/599, seeds 0, 1), 2 lanes: seed 0 == its "
          f"spilled solo solve (best {recs[0]['best_size']}), seed 1 best "
          f"{recs[1]['best_size']} in {recs[1]['rounds']} supersteps (cap {max_rounds}), spilled "
          f"{[x['spilled_tasks'] for x in recs]}, no drop; wall {wall:.3f} s; "
          f"{_meter_line(m)}; launches={launches}")
    svc = SolveService("vertex_cover", spilled_cfg.replace(service_lanes=2), device=dev)
    tickets = [svc.submit(x) for x in (g, g1)]
    counts.reset()
    with _pump_meter() as m:
        t = time.perf_counter()
        svc.drain()
        wall = time.perf_counter() - t
    launches = counts.snapshot()
    srecs = [spill_record(svc.result(tk)) for tk in tickets]
    check(srecs == recs, f"spilled service: {srecs} != solve_many's {recs}")
    _per_explore_round(launches, "vc_expand", cfg.steps_per_round, svc,
                       [x["rounds"] for x in srecs])
    out["vc_expand"] += launches["vc_expand"]
    print(f"[smoke] spill service, 2 lanes: both tickets == solve_many's lanes, spilled "
          f"counts included; wall {wall:.3f} s; {_meter_line(m)}; launches={launches}")

    # (d) durability: (a)'s spilled solve with a checkpoint every 16 chunks,
    # resumed from a checkpoint whose cold tier holds records
    root = tempfile.mkdtemp(prefix="smoke_spill_")
    try:
        d = os.path.join(root, "paper")
        r = SolverSession(config=spilled_cfg.replace(checkpoint_every=16), device=dev).solve(
            g, checkpoint_dir=d)
        check(spill_record(r) == runs[0], "durable spilled solve differs from (a)'s")
        cold = [(p, _cold_rows(SolveCheckpoint.load(str(p)).arrays)) for p in _step_dirs(d)]
        held = [p for p, n in cold if n]
        check(held, f"no checkpoint of the spilled solve holds a cold record: {cold}")
        step_dir = held[len(held) // 2]
        launches, _ = _resume_checked("spilled paper size", step_dir, [runs[0]], "vc_expand",
                                      dev, extra=_spill_extra)
        out["vc_expand"] += launches["vc_expand"]
        sizes = [_dir_bytes(p) for p, _ in cold]
        print(f"[smoke] spill durability: {len(cold)} checkpoints of {min(sizes)}-{max(sizes)} "
              f"bytes, {len(held)} with cold records; resumed from {step_dir.name} "
              f"({dict(cold)[step_dir]} cold records, {_dir_bytes(step_dir)} bytes)")
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # (e) held against the JAX package: golden_spill.json and its checkpoint
    data = ROOT / "src" / "repro_torch" / "data"
    for name, case in json.loads((data / "golden_spill.json").read_text()).items():
        session = SolverSession(config=SolveConfig(**case["solve_kw"]), device=dev)
        graphs = [_build_graph(x) for x in case["graphs"]]
        counts.reset()
        if len(graphs) == 1:
            got = [spill_record(session.solve(graphs[0]))]
        else:
            got = [spill_record(x) for x in session.solve_many(graphs).results]
        launches = counts.snapshot()
        check(got == case["results"], f"golden_spill {name}: {got} != {case['results']}")
        check(set(launches) == {"vc_expand"}, f"golden_spill {name}: launched {launches}")
        out["vc_expand"] += launches["vc_expand"]
    fixture = data / "ckpt_jax_vc_spill"
    doc = json.loads((fixture / "record.json").read_text())
    check(_cold_rows(SolveCheckpoint.load(str(fixture / f"step_{doc['step']}")).arrays)
          == doc["cold_records"] > 0, "the JAX-written spill checkpoint holds no cold record")
    launches, _ = _resume_checked("JAX-written spill checkpoint", fixture / f"step_{doc['step']}",
                                  [doc["result"]], "vc_expand", dev, extra=_spill_extra)
    out["vc_expand"] += launches["vc_expand"]
    print(f"[smoke] spill: golden_spill.json's cases reproduce exactly; the JAX-written "
          f"checkpoint (step {doc['step']}, {doc['cold_records']} cold records) resumes to "
          f"its record")
    return out


# -- faults on the card (phase 14) ------------------------------------------------
#
# The fault plans fire at host-sync boundaries only, as in the JAX package, so
# every faulted path launches the fused kernels of the plain one: exactly one
# expansion an explore round the plane actually runs, a replayed prefix
# included.  The plane supersteps run are counted by ``_hot_cache``.

# (b): the paper size, phase 13's spilled shape, a checkpoint every 32 chunks
# (a chunk a superstep); the crash comes after six checkpoints, the read error
# hits its recovery's load, the write error the checkpoint of chunk 128
FAULT_PAPER_EVERY = 32
FAULT_PAPER_EVENTS = (
    ("transfer_corrupt", 20, {}), ("cold_corrupt", 40, {}), ("transfer_corrupt", 60, {}),
    ("cold_corrupt", 80, {}), ("io_error", 100, {"op": "write"}),
    ("io_error", 150, {"op": "read"}), ("crash", 200, {}),
)
# (c): phase 11a's stream at 4 supersteps a chunk (at its 16 the stream is 14
# chunks, no room for a stall window and 8 fault-free chunks after it).  The
# events come early, while tickets wait for lanes: two faults shed a lane, and
# with three quarantined lanes the plane admits no more until it heals, so a
# later event would find one live lane or none (phase 11a's tickets run 7-188
# supersteps: the third event finds 2 live lanes)
FAULT_SERVICE_CHUNK = 4
FAULT_SERVICE_EVENTS = (
    ("stall", 3, {"lane": 2, "duration": 4}), ("crash", 5, {"lane": 0}),
    ("crash", 6, {"lane": 1}),
)
FAULT_SERVICE_STALL_CHUNKS = 2
# (d): the max-clique crash, on lane 1 at the second boundary (a chunk of 16)
FAULT_CLIQUE_EVENTS = (("crash", 2, {"lane": 1}),)


def _plan(events, seed: int = 0):
    from repro_torch.faults import FaultEvent, FaultPlan

    return FaultPlan(seed=seed, events=tuple(FaultEvent(k, at=at, **kw) for k, at, kw in events))


def _watched_injector(plan):
    """A FaultInjector that records, for each crash or stall it fires, the
    boundary and the number of live lanes it chose from (one for a solo
    plane)."""
    from repro_torch.faults import FaultInjector

    class Watched(FaultInjector):
        def __init__(self, plan):
            super().__init__(plan)
            self.fired = []

        def take_crash(self):
            hit = super().take_crash()
            self.fired += [("crash", self.t, 1)] * hit
            return hit

        def take_crashes(self, live_lanes):
            out = super().take_crashes(live_lanes)
            self.fired += [("crash", self.t, len(live_lanes))] * len(out)
            return out

        def stalled_lanes(self, live_lanes):
            before = self.injected["stall"]
            out = super().stalled_lanes(live_lanes)
            self.fired += [("stall", self.t, len(live_lanes))] * (self.injected["stall"] - before)
            return out

    return Watched(plan)


def _per_round(label: str, launches: dict, kernel: str, steps_per_round: int, ran: int) -> None:
    check(launches == {kernel: steps_per_round * ran},
          f"{label}: launched {launches} in {ran} plane supersteps: want "
          f"{steps_per_round * ran} {kernel}, one per explore round, and nothing else")


def _chaos_leg(name: str, leg: dict, dev, faults: bool) -> tuple:
    """One leg of golden_chaos.json on the card, with its plan or fault-free;
    returns (its golden_chaos-shaped output, wall, launches, plane supersteps)."""
    import warnings

    from repro_torch.api import SolveConfig, SolverSession
    from repro_torch.faults import FaultInjector, FaultPlan
    from repro_torch.kernels import counts

    inj = FaultInjector(FaultPlan.from_dict(leg["plan"])) if faults else None
    cache = _hot_cache()
    session = SolverSession("vertex_cover", config=SolveConfig(**leg["solve_kw"]),
                            cache=cache, device=dev)
    graphs = [_build_graph(g) for g in leg["graphs"]]

    def rec(r):
        out = spill_record(r)
        if r.stats.service is not None:
            out["ledger"] = {k: int(getattr(r.stats.service, k)) for k in (
                "faults_injected", "faults_recovered", "lanes_quarantined", "retries")}
        return out

    out = {}
    root = tempfile.mkdtemp(prefix="smoke_chaos_")
    counts.reset()
    t = time.perf_counter()
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)  # the store's retry warnings
            if name == "service":
                svc = session.serve(injector=inj, checkpoint_dir=root, **leg["serve_kw"])
                tickets = [svc.submit(g) for g in graphs]
                svc.drain()
                out["results"] = [rec(svc.result(tk)) for tk in tickets]
                st = svc.stats()
                out["stats"] = {k: int(st[k]) for k in (
                    "lanes_quarantined", "lanes_shed", "faults_injected",
                    "faults_recovered", "retries")}
            else:
                extra = {"injector": inj} if inj is not None else {}
                out["results"] = [rec(session.solve(graphs[0], checkpoint_dir=root, **extra))]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    wall = time.perf_counter() - t
    launches = counts.snapshot()
    if inj is not None:
        out["report"] = inj.report()
    return out, wall, launches, cache.ran


DATA = ROOT / "src" / "repro_torch" / "data"


def phase_faults(dev, churn_records: list, spilled: dict) -> dict:
    """Fault injection and self-healing on the card: (a) both chaos legs of
    ``golden_chaos.json`` against the JAX record and the chaos pins of
    ``benchmarks/baseline.json``; (b) phase 13's spilled paper-size solve
    under a crash, payload corruption and checkpoint I/O errors, equal to
    phase 13's record; (c) phase 11a's lane-churn stream under two crashes
    and a stall, equal to phase 11a ticket for ticket; (d) phase 4's max
    clique in ``solve_many`` beside a copy of itself, one lane crashed,
    equal to phase 4's golden.  Returns each kernel's launches on the
    faulted paths."""
    return {
        "vc_expand": (_faults_chaos(dev) + _faults_paper(dev, spilled)
                      + _faults_service(dev, churn_records)),
        "clique_expand": _faults_clique(dev),
    }


def _faults_chaos(dev) -> int:
    """(a) The chaos gate: golden_chaos.json (the JAX package's run of both
    legs) reproduced field for field, and the baseline's exact pins.
    Returns the vc_expand launches."""
    from repro_torch.faults import FAULT_KINDS

    launched = 0
    golden = json.loads((DATA / "golden_chaos.json").read_text())
    totals = {"injected": dict.fromkeys(FAULT_KINDS, 0), "recovered": dict.fromkeys(FAULT_KINDS, 0),
              "retries": 0}
    walls = {}
    for name, case in golden.items():
        leg = {k: case[k] for k in ("graphs", "solve_kw", "serve_kw", "plan") if k in case}
        # warm both trajectories first (as chaos_smoke does), so the walls
        # compare recovery, not first-use costs; the runs are chunk-clocked,
        # so the timed ones repeat the warm ones exactly
        for faults in (False, True):
            _chaos_leg(name, leg, dev, faults)
        clean, clean_wall, clean_launches, clean_ran = _chaos_leg(name, leg, dev, faults=False)
        got, wall, launches, ran = _chaos_leg(name, leg, dev, faults=True)
        want = {k: case[k] for k in ("results", "report", "stats") if k in case}
        check(got == want, f"chaos {name} leg on the card: {got} != the JAX record {want}")
        strip = [{k: v for k, v in r.items() if k != "ledger"} for r in got["results"]]
        check(strip == [{k: v for k, v in r.items() if k != "ledger"} for r in clean["results"]],
              f"chaos {name} leg: the faulted answers differ from the fault-free ones")
        check(got["report"]["pending"] == 0, f"chaos {name} leg: events left pending")
        spr = leg["solve_kw"]["steps_per_round"]
        _per_round(f"chaos {name} leg", launches, "vc_expand", spr, ran)
        _per_round(f"chaos {name} leg fault-free", clean_launches, "vc_expand", spr, clean_ran)
        launched += launches["vc_expand"]
        for key in ("injected", "recovered"):
            for kind in FAULT_KINDS:
                totals[key][kind] += got["report"][key][kind]
        totals["retries"] += got["report"]["retries"]
        walls[name] = (wall, clean_wall)
        print(f"[smoke] faults chaos {name} leg == golden_chaos.json (JAX), answers == the "
              f"fault-free run; report {got['report']}; wall {wall:.3f} s against the "
              f"fault-free {clean_wall:.3f} s = {wall / clean_wall:.3f}x (not gated); "
              f"{ran} plane supersteps against {clean_ran}; launches={launches}")
    reading = {
        "faults_injected": sum(totals["injected"].values()),
        "faults_recovered": sum(totals["recovered"].values()),
        "retries": totals["retries"],
        "lanes_quarantined": golden["service"]["stats"]["lanes_quarantined"],
        "injected_by_kind": totals["injected"],
        "all_kinds_covered": all(v >= 1 for v in totals["injected"].values()),
        "bit_identical": True,  # checked above
        "no_drop": all(r["overflow_count"] == 0 for c in golden.values() for r in c["results"]),
    }
    pins = json.loads((ROOT / "benchmarks" / "baseline.json").read_text())
    for c in pins["benchmarks"]["chaos_smoke"]["checks"]:
        if c["path"] == "wall_ratio":
            continue  # recorded above, not gated
        value = reading
        for part in c["path"].split("."):
            value = value[part]
        check(value == c["eq"], f"chaos pin {c['path']}: {value} != {c['eq']}")
    ratio = sum(w for w, _ in walls.values()) / sum(c for _, c in walls.values())
    print(f"[smoke] faults chaos gate on the card: {reading['faults_injected']} injected, "
          f"{reading['faults_recovered']} recovered, {reading['retries']} retries, "
          f"{reading['lanes_quarantined']} lanes quarantined, by kind "
          f"{totals['injected']} == the baseline pins; both injectors end with nothing "
          f"pending; wall ratio {ratio:.3f}x (JAX's gate 1.5x, not gated here)")
    return launched


def _faults_paper(dev, spilled: dict) -> int:
    """(b) The paper's size, solo, phase 13's spilled shape under every solo
    fault kind; returns the vc_expand launches."""
    import warnings

    from repro_torch.api import SolverSession
    from repro_torch.checkpoint.solve import SolveCheckpoint
    from repro_torch.graphs.generators import erdos_renyi
    from repro_torch.kernels import counts

    g = erdos_renyi(**PAPER_GRAPH)
    cfg = spilled["cfg"].replace(checkpoint_every=FAULT_PAPER_EVERY)
    inj = _watched_injector(_plan(FAULT_PAPER_EVENTS, seed=3))
    cache = _hot_cache()
    session = SolverSession(config=cfg, cache=cache, device=dev)
    root = tempfile.mkdtemp(prefix="smoke_faults_")
    spans = {}
    try:
        counts.reset()
        with warnings.catch_warnings(), _timed_calls(
                spans, {"load": (SolveCheckpoint, "load_latest_good"),
                        "save": (SolveCheckpoint, "save")}):
            warnings.simplefilter("ignore", RuntimeWarning)
            t = time.perf_counter()
            r = session.solve(g, checkpoint_dir=os.path.join(root, "paper"), injector=inj)
            wall = time.perf_counter() - t
        launches = counts.snapshot()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    rep = inj.report()
    rec = spill_record(r)
    check(rec == spilled["record"],
          f"faulted paper-size spilled solve: {rec} != phase 13's {spilled['record']}")
    check(r.stats.reduce_sweeps == spilled["reduce_sweeps"],
          f"faulted paper-size solve: reduce_sweeps {r.stats.reduce_sweeps} != phase 13's "
          f"{spilled['reduce_sweeps']}")
    check(rep["pending"] == 0 and rep["injected"] == rep["recovered"]
          and inj.faults_injected == len(FAULT_PAPER_EVENTS),
          f"faulted paper-size solve: not every event fired and recovered: {rep}")
    replayed = cache.ran - rec["rounds"]
    check(replayed > 0, f"faulted paper-size solve: the crash replayed {replayed} supersteps")
    _per_round("faulted paper-size solve", launches, "vc_expand", cfg.steps_per_round, cache.ran)
    loads = spans.get("load", [])
    check(len(loads) == 1, f"faulted paper-size solve: {len(loads)} checkpoint loads")
    print(f"[smoke] faults paper size G(600, 4/599, seed 0), spilled at C="
          f"{cfg.capacity}, a checkpoint every {FAULT_PAPER_EVERY} chunks: == phase 13's "
          f"spilled record (best {rec['best_size']}, {rec['rounds']} supersteps, "
          f"{rec['spilled_tasks']} spilled and readmitted, reduce_sweeps "
          f"{r.stats.reduce_sweeps}); crash at boundary {inj.fired[0][1]}, "
          f"{replayed} supersteps replayed ({cache.ran} run); the recovery's load "
          f"{1e3 * loads[0]:.3f} ms (its read error retried on the virtual clock, "
          f"{rep['backoff_s']} s), {len(spans.get('save', []))} checkpoint writes "
          f"{1e3 * sum(spans.get('save', [])):.3f} ms; report {rep}; wall {wall:.3f} s = "
          f"{wall / spilled['wall']:.3f}x phase 13's spilled {spilled['wall']:.3f} s; "
          f"launches={launches}")
    return launches["vc_expand"]


def _faults_service(dev, churn_records: list) -> int:
    """(c) The live service: phase 11a's stream under two crashes and a
    stall; returns the vc_expand launches."""
    from repro_torch.api import SolveConfig, SolveService
    from repro_torch.graphs.generators import erdos_renyi
    from repro_torch.kernels import counts

    smoke = json.loads((DATA / "golden_smoke.json").read_text())
    cfg = SolveConfig(**smoke["solve_kw"], service_lanes=4, chunk_rounds=FAULT_SERVICE_CHUNK,
                      lane_stall_chunks=FAULT_SERVICE_STALL_CHUNKS)
    graphs = [erdos_renyi(seed=s, **BATCH_GRAPH) for s in range(8)]
    inj = _watched_injector(_plan(FAULT_SERVICE_EVENTS))
    cache = _hot_cache()
    svc = SolveService("vertex_cover", cfg, cache=cache, injector=inj, device=dev)
    tickets = [svc.submit(x, priority=(3 * s) % 8) for s, x in enumerate(graphs)]
    counts.reset()
    t = time.perf_counter()
    steps = 0
    while not svc.idle():
        svc.step()
        steps += 1
    wall = time.perf_counter() - t
    launches = counts.snapshot()
    results = [svc.result(tk) for tk in tickets]
    got = [record(x) for x in results]
    check(got == churn_records, f"faulted service: {got} != phase 11a's {churn_records}")
    st = svc.stats()
    check(st["lanes_quarantined"] == 3 and st["faults_injected"] == st["faults_recovered"] == 3
          and st["lanes_shed"] == 0 and inj.report()["pending"] == 0,
          f"faulted service: stats {st}, report {inj.report()}")
    check(all(live >= 2 for _, _, live in inj.fired) and len(inj.fired) == 3,
          f"faulted service: events fired at {inj.fired} (kind, boundary, live lanes)")
    last = max(b for _, b, _ in inj.fired)
    check(inj.t - last >= 8, f"faulted service: the last event fired at boundary {last} "
                             f"of {inj.t}: fewer than 8 chunks left to heal")
    for key in ("faults_injected", "faults_recovered", "lanes_quarantined"):
        total = sum(getattr(x.stats.service, key) for x in results)
        check(total == st[key], f"faulted service: tickets' {key} sum to {total}, "
                                f"the service's is {st[key]}")
    check(st["supersteps"] == cache.ran, f"faulted service: {st['supersteps']} != {cache.ran}")
    _per_round("faulted service", launches, "vc_expand", cfg.steps_per_round, cache.ran)
    print(f"[smoke] faults service, 8 x G(300, 4/299, seeds 0-7), 64 workers, 4 lanes, "
          f"{FAULT_SERVICE_CHUNK} supersteps a chunk, lane_stall_chunks "
          f"{FAULT_SERVICE_STALL_CHUNKS}: every ticket == phase 11a; events (kind, boundary, "
          f"live lanes) {inj.fired} of {inj.t} boundaries; lanes_quarantined "
          f"{st['lanes_quarantined']}, injected = recovered = {st['faults_recovered']}, shed 0 "
          f"at drain; {steps} steps, {st['supersteps']} plane supersteps, wall {wall:.3f} s; "
          f"launches={launches}")
    return launches["vc_expand"]


def _faults_clique(dev) -> int:
    """(d) Max clique: phase 4's exact solve beside a copy of itself in
    ``solve_many``, one lane crashed; returns the clique_expand launches."""
    from repro_torch.api import SolveConfig, SolverSession
    from repro_torch.kernels import counts

    golden = json.loads((DATA / "golden_clique.json").read_text())["max_clique"]
    gc = _build_graph(golden["graph"])
    cfg = SolveConfig(**golden["solve_kw"])
    inj = _watched_injector(_plan(FAULT_CLIQUE_EVENTS))
    cache = _hot_cache()
    counts.reset()
    t = time.perf_counter()
    batch = SolverSession(problem="max_clique", config=cfg, cache=cache, device=dev).solve_many(
        [gc, gc], injector=inj)
    wall = time.perf_counter() - t
    launches = counts.snapshot()
    for i, x in enumerate(batch.results):
        got = {**record(x), "overflow_count": int(x.stats.overflow_count)}
        check(got == golden["result"], f"faulted max-clique lane {i}: {got} != phase 4's golden")
    check(inj.injected["crash"] == inj.recovered["crash"] == 1,
          f"faulted max clique: {inj.report()}")
    _per_round("faulted max clique", launches, "clique_expand", cfg.steps_per_round, cache.ran)
    print(f"[smoke] faults max clique {golden['graph']} in solve_many with a copy, lane "
          f"crashed at {inj.fired}: both == phase 4's golden (best "
          f"{batch.results[0].best_size}, {batch.results[0].rounds} supersteps); "
          f"{cache.ran} plane supersteps, {batch.compactions} compaction(s), wall "
          f"{wall:.3f} s; launches={launches}")
    return launches["clique_expand"]



# -- the LM serving path (phases 8-10) ------------------------------------------

# H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet), for the
# attention products' bound; PEAK_OPS_PER_S is the f32 rate
PEAK_BF16_FLOPS = 989e12
# JAX's attention cases (tests/test_kernels_attention.py:22-30) and wkv6
# cases (tests/test_kernels_wkv6.py:23-29), with JAX's tolerances
ATTN_CASES = [
    dict(B=2, Sq=64, Sk=64, Hq=4, Hkv=2, D=32, causal=True, window=None),
    dict(B=1, Sq=128, Sk=128, Hq=4, Hkv=1, D=64, causal=True, window=32),
    dict(B=2, Sq=1, Sk=96, Hq=8, Hkv=4, D=32, causal=True, window=None),
    dict(B=1, Sq=50, Sk=50, Hq=2, Hkv=2, D=16, causal=False, window=None),
    dict(B=1, Sq=70, Sk=70, Hq=2, Hkv=1, D=32, causal=True, window=None),
    dict(B=1, Sq=1, Sk=77, Hq=4, Hkv=2, D=64, causal=True, window=24),
    dict(B=3, Sq=33, Sk=33, Hq=6, Hkv=3, D=8, causal=True, window=16),
]
ATTN_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
VARIANT_SOURCES = {"tensor_core": "flash_attention_wgmma.cu", "cuda_core": "flash_attention.cu"}
# the serving shapes: qwen1.5-0.5b's prefill (B 4, S 1024, 16 heads of 64),
# starcoder2-3b's GQA widths, a window, one query against a 1,057-key cache
QWEN_ATTN = dict(B=4, Sq=1024, Sk=1024, Hq=16, Hkv=16, D=64, causal=True, window=None)
SERVING_ATTN = [
    QWEN_ATTN,
    dict(B=4, Sq=1024, Sk=1024, Hq=24, Hkv=2, D=128, causal=True, window=None),
    dict(B=4, Sq=1024, Sk=1024, Hq=16, Hkv=16, D=64, causal=True, window=256),
    dict(B=4, Sq=1, Sk=1057, Hq=16, Hkv=16, D=64, causal=True, window=None),
]
WKV_CASES = [(2, 64, 2, 16, 16), (1, 128, 4, 32, 32), (2, 96, 1, 8, 24),
             (1, 32, 2, 64, 64), (1, 64, 3, 16, 48), (2, 50, 2, 16, 16)]
RWKV_WKV = (4, 1024, 40, 64, 64)  # RWKV6-3B's prefill: B, T, H, K, V
WKV_TOL = 3e-4
# the golden (f32 throughout, another summation order than JAX's on the CPU;
# tests/test_torch_golden_lm.py holds the port to it on the CPU as well)
GOLDEN_LM_TOL = 1e-4
SERVE = dict(batch=4, prompt_len=1024, gen=32, seed=0)
# bf16 on the card, three routes through the same weights: "kernel" (the
# port's default), "plain" (the JAX package's default: blockwise attention,
# which rounds q.k to bf16 where the kernel keeps f32; wkv6_ref, the f32
# recurrence) and "f64" (the plain op computed in f64 and rounded to the plain
# op's output dtype, a route that differs from "plain" only in the rounding
# inside the op).  Readings are ||a - b|| / ||b||.  Per layer, fed the kernel
# route's input, the attention or time-mix output h (without the residual)
# of the kernel against the f64 route: both round once to bf16 from f32 or
# better, so they differ by at most one bf16 step (2^-8 relative) an element
# (an H100 read 1.7e-4 for qwen1.5-0.5b and 1.3e-4 for rwkv6-3b)
SERVE_H_TOL = 2.0**-8
# Whole bf16 forwards: over 24-32 random layers any rounding difference
# compounds, so a kernel-vs-plain logit gap is held against the witness, the
# gap between "plain" and "f64": the kernel must be no farther from the f64
# route than WITNESS_FACTOR times the plain route is.  On an H100: kernel vs
# plain 1.9% and 11.4%, f64 vs plain 1.9% and 11.1%, kernel vs f64 1.6% and
# 10.9% (qwen1.5-0.5b, rwkv6-3b): a route known to be right diverges as far
WITNESS_FACTOR = 2.0
# f32 at full width (the same weights cast to f32, TF32 off): the kernel
# forward against the plain one over the whole prompt, the decode path
# against the forward over a 64-token prompt (JAX's test_decode_matches_forward),
# and rwkv6's prompt as one chunk against two halves.  Only summation orders
# differ (the recurrence, GEMMs of other row counts), but depth compounds them:
# on an H100 qwen gave 2.5e-6 (forward) and 1.6e-6 (decode), rwkv6 4.4e-5,
# 2.2e-4 and 1.1e-4 (chunks)
F32_REL_TOL = 1e-3
F32_DECODE_PROMPT = 64
# the bf16 decode path's logits at the last of the 1,024 prompt tokens against
# the forward's, about twice the readings of an H100 (1.9% and 10.9%; a
# decode fault -- a wrong position, cache slot or state -- gives errors of
# order 1)
BF16_DECODE_TOL = {"qwen1.5-0.5b": 0.04, "rwkv6-3b": 0.22}


def _attn_inputs(c, dtype, dev, seed):
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(shape, generator=g, device=dev).to(dtype) for shape in (
        (c["B"], c["Sq"], c["Hq"], c["D"]), (c["B"], c["Sk"], c["Hkv"], c["D"]),
        (c["B"], c["Sk"], c["Hkv"], c["D"]))]


def _wkv_inputs(B, T, H, K, V, dev, seed, with_state=True):
    """The JAX test's draws: r, k, v ~ 0.5 N(0, 1), decay exp(-exp(-w)) with
    w ~ U(0.2, 3), u ~ 0.3 N(0, 1), state ~ 0.2 N(0, 1)."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    f = lambda *s: torch.randn(s, generator=g, device=dev) * 0.5
    r, k, v = f(B, T, H, K), f(B, T, H, K), f(B, T, H, V)
    w = torch.rand((B, T, H, K), generator=g, device=dev) * 2.8 + 0.2
    return r, k, v, torch.exp(-torch.exp(-w)), f(H, K) * 0.6, (
        f(B, H, K, V) * 0.4 if with_state else None)


def _attn_work(c, dtype_bytes: int):
    """Bytes (q, k, v read once, out written once) and FLOPs (2 D for q.k and
    2 D for p.v per unmasked query-key pair) of one attention call."""
    q_n = c["B"] * c["Sq"] * c["Hq"] * c["D"]
    kv_n = c["B"] * c["Sk"] * c["Hkv"] * c["D"]
    pairs = 0
    for i in range(c["Sq"]):
        qpos = i + c["Sk"] - c["Sq"]
        hi = qpos + 1 if c["causal"] else c["Sk"]
        lo = max(0, qpos - c["window"] + 1) if c["window"] else 0
        pairs += max(0, hi - lo)
    return dtype_bytes * (2 * q_n + 2 * kv_n), 4 * c["D"] * pairs * c["B"] * c["Hq"]


def phase_lm_kernels(dev) -> dict:
    """flash_attention and wkv6 against their plain versions, then timed.
    Returns their fields of the kernels line (launches aside), by name."""
    import collections

    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import counts
    from repro_torch.kernels.flash_attention import (
        attention_ref,
        flash_attention,
        flash_attention_plain,
    )
    from repro_torch.kernels.flash_attention.kernel import VARIANTS, variant_for
    from repro_torch.kernels.wkv6 import wkv6, wkv6_ref
    from repro_torch.launch.timing import call_ms, time_ms

    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    attn_err = {"float32": 0.0, "bfloat16": 0.0}
    calls = collections.Counter()  # launches the calls below must make, by variant
    counts.reset()
    for i, c in enumerate(ATTN_CASES):
        kw = dict(causal=c["causal"], window=c["window"])
        for name, dt in dtypes.items():
            q, k, v = _attn_inputs(c, dt, dev, i)
            got = flash_attention(q, k, v, **kw).float()
            calls[f"flash_attention.{variant_for(q, k, v)}"] += 1
            torch.cuda.synchronize()
            for want in (flash_attention_plain(q, k, v, **kw).float(),
                         attention_ref(q.float(), k.float(), v.float(), **kw)):
                e = float((got - want).abs().max())
                attn_err[name] = max(attn_err[name], e)
                check(e < ATTN_TOL[name], f"flash_attention {name} {c}: max abs err {e}")
    serving_err = {}
    for i, c in enumerate(SERVING_ATTN):
        kw = dict(causal=c["causal"], window=c["window"])
        for name, dt in dtypes.items():
            q, k, v = _attn_inputs(c, dt, dev, 100 + i)
            want = flash_attention_plain(q, k, v, **kw).float()
            # f32 has one variant; bf16 at these shapes both, the tensor-core
            # one by the rule
            for variant in (("auto",) if name == "float32" else VARIANTS):
                got = flash_attention(q, k, v, **kw, variant=variant).float()
                calls[f"flash_attention.{variant_for(q, k, v) if variant == 'auto' else variant}"] += 1
                torch.cuda.synchronize()
                diff = (got - want).abs()
                e = float(diff.max())
                if name == "float32":
                    check(e < ATTN_TOL[name], f"flash_attention f32 at {c}: max abs err {e}")
                else:
                    # both sides hold f32 and round once to bf16: they may differ
                    # by one bf16 step, at most 2^-7 of the larger value
                    step = 2.0**-7 * torch.maximum(got.abs(), want.abs()) + 1e-6
                    check(bool((diff <= step).all()),
                          f"flash_attention {variant} bf16 at {c}: more than one bf16 step "
                          f"from the plain version (max abs err {e})")
                serving_err[f"{c['Hq']}/{c['Hkv']}x{c['D']} Sq={c['Sq']} "
                            f"w={c['window']} {name} {variant}"] = e
    check(counts.snapshot() == dict(calls),
          f"flash_attention launches {counts.snapshot()} != the calls' variants {dict(calls)}")
    print(f"[smoke] flash_attention == plain version and f32 oracle on "
          f"{len(ATTN_CASES)} JAX cases x 2 dtypes (max abs err {attn_err}); at the "
          f"serving shapes (bf16 within one bf16 step): {serving_err}; launches by "
          f"variant {dict(calls)}")

    wkv_err = 0.0
    for i, (B, T, H, K, V) in enumerate(WKV_CASES + [RWKV_WKV]):
        for with_state in (True, False):
            r, k, v, d, u, s0 = _wkv_inputs(B, T, H, K, V, dev, 200 + i, with_state)
            o, s = wkv6(r, k, v, d, u, s0)
            o_ref, s_ref = wkv6_ref(r, k, v, d, u, s0)
            torch.cuda.synchronize()
            e = max(float((o - o_ref).abs().max()), float((s - s_ref).abs().max()))
            wkv_err = max(wkv_err, e)
            check(e < WKV_TOL, f"wkv6 at {(B, T, H, K, V)} state={with_state}: err {e}")
    print(f"[smoke] wkv6 == wkv6_ref on {2 * (len(WKV_CASES) + 1)} cases "
          f"(JAX's and RWKV6-3B's prefill, with and without a state; max abs err "
          f"{wkv_err:.3g} < {WKV_TOL})")

    out = {}
    # attention at qwen1.5-0.5b's prefill shape, bf16: both variants, the
    # plain version and SDPA in the same call
    c = QWEN_ATTN
    q, k, v = _attn_inputs(c, torch.bfloat16, dev, 300)
    variants = {}
    for variant in VARIANTS:
        fn = lambda: flash_attention(q, k, v, causal=True, variant=variant)
        variants[variant] = {
            "source": f"src/repro_torch/kernels/flash_attention/csrc/{VARIANT_SOURCES[variant]}",
            "ms": time_ms(fn),
            "call_ms": call_ms(fn),
        }
    plain = lambda: flash_attention_plain(q, k, v, causal=True)
    plain_ms, plain_call = time_ms(plain, n=20), call_ms(plain, reps=20)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True).transpose(1, 2)
    mine = flash_attention(q, k, v, causal=True)
    e = float((sdpa.float() - mine.float()).abs().max())
    check(e < ATTN_TOL["bfloat16"], f"scaled_dot_product_attention disagrees: {e}")
    library = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    library_ms, library_call = time_ms(library), call_ms(library)
    moved, flops = _attn_work(c, 2)
    bound, by = _bound_ms(moved, 0)
    bound_ops = flops / PEAK_BF16_FLOPS * 1e3
    if bound_ops > bound:
        bound, by = bound_ops, "operations"
    tc, cc = variants["tensor_core"], variants["cuda_core"]
    print(f"[smoke] flash_attention {c} bf16: tensor_core {tc['ms']:.6f} ms (one call "
          f"{tc['call_ms']:.6f}), cuda_core {cc['ms']:.6f} ms (one call "
          f"{cc['call_ms']:.6f}), plain {plain_ms:.6f} ms (one call {plain_call:.6f}), "
          f"scaled_dot_product_attention {library_ms:.6f} ms (one call {library_call:.6f}; "
          f"agrees within {e:.3g}), bound {bound:.6f} ms ({moved} B, {flops} FLOP)")
    out["flash_attention"] = {
        "name": "flash_attention",
        "route": "cuda",
        "source": tc["source"],
        "replaces": "src/repro/kernels/flash_attention/kernel.py:91",
        "max_abs_err": max(attn_err.values()),
        "ms": tc["ms"],
        "call_ms": tc["call_ms"],
        "plain_ms": plain_ms,
        "plain_call_ms": plain_call,
        "bound_ms": bound,
        "bound_by": by,
        "library_ms": library_ms,
        "library_call_ms": library_call,
        "variants": variants,
    }

    # wkv6 at RWKV6-3B's prefill, f32, no initial state (the forward's call)
    B, T, H, K, V = RWKV_WKV
    r, k, v, d, u, _ = _wkv_inputs(B, T, H, K, V, dev, 400, with_state=False)
    kernel = lambda: wkv6(r, k, v, d, u)
    plain = lambda: wkv6_ref(r, k, v, d, u)
    kernel_ms, kernel_call = time_ms(kernel), call_ms(kernel)
    plain_ms, plain_call = time_ms(plain, n=20, runs=3, warmup=1), call_ms(plain, reps=5, warmup=1)
    # r, k, v, decay, u read once; out and the final state written once; per
    # (b, t, h, k, v) a multiply for k v and two fused multiply-adds (the
    # state's decay-and-add, the output's r-weighted sum): 5 FLOP
    moved = 4 * (4 * B * T * H * K + H * K + B * T * H * V + B * H * K * V)
    ops = 5 * B * T * H * K * V
    bound, by = _bound_ms(moved, ops)
    print(f"[smoke] wkv6 (B, T, H, K, V)={RWKV_WKV} f32: kernel {kernel_ms:.6f} ms (one call "
          f"{kernel_call:.6f}), plain {plain_ms:.6f} ms (one call {plain_call:.6f}), bound "
          f"{bound:.6f} ms ({moved} B, {ops} FLOP)")
    out["wkv6"] = {
        "name": "wkv6",
        "route": "cuda",
        "source": "src/repro_torch/kernels/wkv6/csrc/wkv6.cu",
        "replaces": "src/repro/kernels/wkv6/kernel.py:92",
        "max_abs_err": wkv_err,
        "ms": kernel_ms,
        "call_ms": kernel_call,
        "plain_ms": plain_ms,
        "plain_call_ms": plain_call,
        "bound_ms": bound,
        "bound_by": by,
        "library_ms": None,  # no single PyTorch call computes the recurrence
    }
    return out


def phase_golden_lm(dev) -> None:
    """golden_lm.json (JAX-made, f32 smoke configs) through the kernels."""
    import numpy as np
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import counts
    from repro_torch.launch.serve_lm import greedy_decode
    from repro_torch.models.convert import load_jax_params, numpy_params
    from repro_torch.models.registry import get_model

    golden = json.loads((ROOT / "src" / "repro_torch" / "data" / "golden_lm.json").read_text())
    for arch, run in golden.items():
        cfg = get_smoke_config(arch)
        model = get_model(cfg)
        params = load_jax_params(model.init(device=dev), numpy_params(cfg, run["weights_seed"]))
        rng = np.random.default_rng(run["prompt_seed"])
        toks = torch.from_numpy(
            rng.integers(0, cfg.vocab, (run["batch"], run["prompt_len"]))).to(dev)
        counts.reset()
        logits = model.forward(params, {"tokens": toks})
        torch.cuda.synchronize()
        launches = counts.snapshot()
        # f32: attention runs on the CUDA-core variant
        kernel = "wkv6" if cfg.family == "ssm" else "flash_attention.cuda_core"
        check(launches == {kernel: cfg.n_layers},
              f"golden {arch}: launches {launches}, want {cfg.n_layers} {kernel}")
        want = torch.tensor(run["result"]["last_logits"], device=dev)
        e = float((logits[:, -1] - want).abs().max())
        check(e < GOLDEN_LM_TOL, f"golden {arch}: last logits max abs err {e}")
        gen, _ = greedy_decode(model, params, toks, run["gen"])
        check(gen.tolist() == run["result"]["tokens"],
              f"golden {arch}: greedy tokens {gen.tolist()} != {run['result']['tokens']}")
        print(f"[smoke] golden_lm {cfg.name}: last logits within {e:.3g} of JAX's "
              f"(< {GOLDEN_LM_TOL}), {run['gen']} greedy tokens equal, "
              f"launches per forward {launches}")


def _rel(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


PLAIN_ROUTE = {"dense": ("attn_impl", "blockwise"), "ssm": ("wkv_impl", "ref")}


def _wkv6_f64(r, k, v, decay, u, initial_state=None, *, impl):
    """wkv6_ref's recurrence in f64, rounded to f32."""
    import torch

    B, T, H, K = r.shape
    r, k, v, decay, u = (t.double() for t in (r, k, v, decay, u))
    S = (torch.zeros((B, H, K, v.shape[-1]), dtype=torch.float64, device=r.device)
         if initial_state is None else initial_state.double())
    outs = []
    for t in range(T):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        outs.append(torch.einsum("bhk,bhkv->bhv", r[:, t], S + u[None, :, :, None] * kv))
        S = decay[:, t, :, :, None] * S + kv
    return torch.stack(outs, dim=1).float(), S.float()


def _attention_f64(q, k, v, *, causal, window, impl):
    """Blockwise attention in f64, rounded to q's dtype."""
    from repro_torch.kernels.flash_attention.ops import blockwise_attention

    return blockwise_attention(q.double(), k.double(), v.double(), causal=causal,
                               window=window).to(q.dtype)


@contextlib.contextmanager
def _route(cfg, route):
    """Yields the model functions' keyword for ``route``: "kernel", "plain"
    or "f64" (the plain route with its op swapped, for the duration, for the
    same op in f64)."""
    from unittest import mock

    from repro_torch.models import layers, rwkv6

    key, plain = PLAIN_ROUTE[cfg.family]
    if route == "kernel":
        yield {}
    elif route == "plain":
        yield {key: plain}
    else:
        target = (rwkv6, "wkv6_op", _wkv6_f64) if cfg.family == "ssm" else (
            layers, "attention_op", _attention_f64)
        with mock.patch.object(*target):
            yield {key: plain}


def _forward(cfg, params, toks, route):
    from repro_torch.models import rwkv6, transformer

    fwd = rwkv6.forward if cfg.family == "ssm" else transformer.forward
    with _route(cfg, route) as kw:
        return fwd(params, toks, **kw)


def _layer_h(cfg, params, toks) -> dict:
    """Per layer, fed the kernel route's input: the attention (dense) or
    time-mix (ssm) output h of each route.  Returns, for each pair of
    routes, the largest ||a - b|| / ||b|| over the layers."""
    import torch

    from repro_torch.models import layers as L
    from repro_torch.models import rwkv6, transformer

    pairs = (("kernel", "f64"), ("kernel", "plain"), ("f64", "plain"))
    worst = {f"{a}/{b}": 0.0 for a, b in pairs}
    with torch.no_grad():
        x = params.embed[toks].to(L.torch_dtype(cfg))
        positions = torch.arange(x.shape[1], device=x.device)
        for bp in params.blocks:
            xn = L.rmsnorm(x, bp.ln1, cfg.norm_eps)
            h = {}
            for route in ("kernel", "plain", "f64"):
                with _route(cfg, route) as kw:
                    if cfg.family == "ssm":
                        h[route] = rwkv6.tmix_apply(cfg, bp.tmix, xn, **kw)[0]
                    else:
                        h[route] = L.attention_apply(cfg, bp.attn, xn, positions, **kw)[0]
            for a, b in pairs:
                worst[f"{a}/{b}"] = max(worst[f"{a}/{b}"], _rel(h[a], h[b]))
            if cfg.family == "ssm":
                x, _ = rwkv6.block_apply(cfg, bp, x)
            else:
                x, _ = transformer.block_apply(cfg, bp, x, positions)
    return worst


def _f32_copy(cfg, params, dev):
    """The same weights in an f32 model of the same config."""
    import dataclasses

    from repro_torch.models.registry import get_model

    model = get_model(dataclasses.replace(cfg, dtype="float32"))
    copy = model.init(device="meta").to_empty(device=dev)
    copy.load_state_dict(params.state_dict())
    return model, copy


def phase_serve_lm(dev) -> dict:
    """qwen1.5-0.5b and rwkv6-3b at full width, bf16: prefill and greedy
    decode, then the checks.  Returns the serving runs' launch counts, by
    counter."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import counts
    from repro_torch.launch.serve_lm import greedy_decode
    from repro_torch.models.registry import get_model

    B, P, gen = SERVE["batch"], SERVE["prompt_len"], SERVE["gen"]
    main_launches = {}
    for arch in ("qwen1.5-0.5b", "rwkv6-3b"):
        t0 = time.perf_counter()
        cfg = get_config(arch)
        model = get_model(cfg)
        params = model.init(torch.Generator(device=dev).manual_seed(SERVE["seed"]), dev)
        n_params = sum(p.numel() for p in params.parameters())
        toks = torch.from_numpy(
            np.random.default_rng(SERVE["seed"]).integers(0, cfg.vocab, (B, P))).to(dev)
        # bf16 at D 64: attention runs on the tensor-core variant
        kernel = "wkv6" if cfg.family == "ssm" else "flash_attention.tensor_core"
        model.forward(params, {"tokens": toks})  # warm-up: cuBLAS and kernel loads
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0

        # the serving path: prefill, then greedy decode, launches counted
        counts.reset()
        t0 = time.perf_counter()
        logits = model.forward(params, {"tokens": toks})
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        out, prompt_logits = greedy_decode(model, params, toks, gen)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        launches = counts.snapshot()
        main_launches.update(launches)
        check(launches == {kernel: cfg.n_layers},
              f"{arch}: launches {launches}, want {cfg.n_layers} {kernel} (one per "
              f"layer of the prefill; decode attends/steps in plain torch)")
        check(tuple(out.shape) == (B, gen) and bool(torch.isfinite(logits).all()),
              f"{arch}: generated {tuple(out.shape)}, logits finite "
              f"{bool(torch.isfinite(logits).all())}")
        print(f"[smoke] serve {cfg.name} ({n_params} params, bf16): prefill {B}x{P} in "
              f"{prefill_s:.6f} s = {B * P / prefill_s:.1f} tok/s; greedy decode "
              f"{P}+{gen} steps in {decode_s:.3f} s = {1e3 * decode_s / (P + gen):.3f} "
              f"ms/step, {B * (P + gen) / decode_s:.1f} tok/s ({B * gen / decode_s:.1f} "
              f"generated tok/s); set-up {setup_s:.3f} s; launches {launches}")

        t0 = time.perf_counter()
        e_bf16_decode = _rel(prompt_logits, logits[:, -1])
        check(e_bf16_decode < BF16_DECODE_TOL[arch],
              f"{arch}: bf16 decode vs forward at the last prompt token {e_bf16_decode}")
        del prompt_logits
        e_h = _layer_h(cfg, params, toks)
        check(e_h["kernel/f64"] < SERVE_H_TOL,
              f"{arch}: a layer's h, kernel vs f64 route {e_h['kernel/f64']}")
        # whole bf16 forwards through the three routes, and the witness
        fwd = {"kernel": logits, "plain": _forward(cfg, params, toks, "plain"),
               "f64": _forward(cfg, params, toks, "f64")}
        e_fwd = {f"{a}/{b}": _rel(fwd[a], fwd[b]) for a, b in (
            ("kernel", "plain"), ("f64", "plain"), ("kernel", "f64"))}
        check(e_fwd["kernel/f64"] <= WITNESS_FACTOR * e_fwd["f64/plain"],
              f"{arch}: bf16 forward, kernel vs f64 route {e_fwd['kernel/f64']} > "
              f"{WITNESS_FACTOR} x plain vs f64 route {e_fwd['f64/plain']}")
        del logits, fwd
        model32, params32 = _f32_copy(cfg, params, dev)
        del params
        e_f32_fwd = _rel(_forward(model32.cfg, params32, toks, "kernel"),
                         _forward(model32.cfg, params32, toks, "plain"))
        check(e_f32_fwd < F32_REL_TOL, f"{arch}: f32 forward, kernel vs plain {e_f32_fwd}")
        short = toks[:, :F32_DECODE_PROMPT]
        full32 = model32.forward(params32, {"tokens": short})
        cache = model32.init_decode_cache(B, short.shape[1], device=dev)
        steps = [model32.decode_fn(params32, cache, short[:, t : t + 1])[0]
                 for t in range(short.shape[1])]
        e_f32_decode = _rel(torch.cat(steps, 1), full32)
        check(e_f32_decode < F32_REL_TOL, f"{arch}: f32 decode vs forward {e_f32_decode}")
        fmt = lambda d: ", ".join(f"{k} {v:.4g}" for k, v in d.items())
        line = (f"[smoke] {cfg.name} checks: the layers' h (bf16), largest of {fmt(e_h)}; "
                f"whole bf16 forwards {fmt(e_fwd)}; f32 forward kernel/plain "
                f"{e_f32_fwd:.4g}; decode vs forward, bf16 at the last of {P} prompt "
                f"tokens {e_bf16_decode:.4g}, f32 over {F32_DECODE_PROMPT} tokens "
                f"{e_f32_decode:.4g}")
        if cfg.family == "ssm":
            # decode_fn over the prompt as one chunk and as two halves: the
            # second half runs the kernel from a non-zero state (f32)
            counts.reset()
            fresh = lambda: model32.init_decode_cache(B, 0, device=dev)
            one, c1 = model32.decode_fn(params32, fresh(), toks)
            h1, halves = model32.decode_fn(params32, fresh(), toks[:, : P // 2])
            h2, halves = model32.decode_fn(params32, halves, toks[:, P // 2 :])
            torch.cuda.synchronize()
            check(counts.snapshot() == {"wkv6": 3 * cfg.n_layers},
                  f"{arch}: multi-token decode launches {counts.snapshot()}")
            e_state = _rel(halves["wkv"], c1["wkv"])
            e_chunks = _rel(torch.cat([h1, h2], 1), one)
            for what, e in (("state", e_state), ("logits", e_chunks)):
                check(e < F32_REL_TOL, f"{arch}: one chunk vs two halves, {what}: {e}")
            line += (f"; decode_fn over the prompt, one chunk vs two halves (f32): "
                     f"state {e_state:.4g}, logits {e_chunks:.4g}")
        print(f"{line}; {time.perf_counter() - t0:.3f} s")
        del params32, model32
        torch.cuda.empty_cache()
    return main_launches


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--paper-max-rounds", type=int, default=PAPER_MAX_ROUNDS,
                    help="superstep budget of the paper-size run")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs an NVIDIA GPU")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             f"the root of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    dev = torch.device("cuda")
    smi = nvidia_smi()
    print(f"[smoke] card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    from repro_torch.kernels import build

    t_start = t0 = time.perf_counter()
    logs = build.build_all()
    print(f"[smoke] built {sorted(build.SOURCES)} in {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"[smoke]   {name}: {line.strip()}")
    # the tensor-core attention kernel must hold wgmma (HGMMA in SASS)
    sass = subprocess.run(
        [build.cuda_tool("cuobjdump"), "-sass", str(build.library_path("flash_attention_wgmma"))],
        capture_output=True, text=True, check=True, timeout=300,
    ).stdout
    n_wgmma = sum("HGMMA" in line for line in sass.splitlines())
    check(n_wgmma > 0, "flash_attention_wgmma's SASS holds no HGMMA (wgmma) instruction")
    print(f"[smoke] flash_attention_wgmma: {n_wgmma} HGMMA (wgmma) instructions in its sm_90a SASS")

    walls = {}

    def timed(name, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        walls[name] = round(time.perf_counter() - t, 3)
        return out

    kernels = timed("kernels", phase_kernels, dev)
    kernels.update(timed("expand_kernels", phase_expand_kernels, dev))
    composed = timed("composed", phase_composed, dev)
    solo_n300 = timed("goldens", phase_goldens, dev)
    clique = timed("clique_mis", phase_clique_goldens, dev)
    batch_seed1 = timed("batch", phase_batch, dev, solo_n300)
    launches, paper, paper_peak = timed("paper", phase_paper, dev, args.paper_max_rounds)
    service = timed("service", phase_service, dev, paper, args.paper_max_rounds)
    resumed = timed("durability", phase_durability, dev, paper, batch_seed1,
                    service["capped"], args.paper_max_rounds)
    # the panel kernels serve the composed expansion; the fused ones the
    # solver's main paths (vertex cover's at the paper's size, max clique's)
    for name in ("batched_degrees", "batched_expand_stats"):
        kernels[name]["launches"] = composed.get(name, 0)
        kernels[name]["path"] = "composed expansion (expand_tasks=None), phase 2"
    kernels["vc_expand"]["launches"] = launches.get("vc_expand", 0)
    kernels["vc_expand"]["path"] = "vertex cover at the paper's size, phase 7"
    kernels["clique_expand"]["launches"] = clique.get("clique_expand", 0)
    kernels["clique_expand"]["path"] = "max clique exact solve, phase 4"
    for name in ("batched_degrees", "batched_expand_stats", "vc_expand", "clique_expand"):
        check(kernels[name]["launches"] > 0, f"its path launched no {name} kernel")
    # the live service is the fused kernels' second path
    kernels["vc_expand"]["service_launches"] = sum(
        service[p].get("vc_expand", 0) for p in ("churn", "paper"))
    kernels["vc_expand"]["service_path"] = "live service: lane churn and paper size, phase 11"
    kernels["clique_expand"]["service_launches"] = service["serve"].get("clique_expand", 0)
    kernels["clique_expand"]["service_path"] = "asyncio front end launch.serve, phase 11"
    # and the resumes of checkpoints on the card their third
    kernels["vc_expand"]["resume_launches"] = resumed["vc_expand"]
    kernels["vc_expand"]["resume_path"] = (
        "resumed solves: paper size from 3 checkpoints, the batch, the restored "
        "paper-size service, the JAX-written checkpoint, phase 12")
    kernels["clique_expand"]["resume_launches"] = resumed["clique_expand"]
    kernels["clique_expand"]["resume_path"] = "max clique exact solve resumed mid-solve, phase 12"
    for name in ("vc_expand", "clique_expand"):
        check(kernels[name]["resume_launches"] > 0, f"no resume launched {name}")
    # and the spilled solves their fourth
    spilled = timed("spill", phase_spill, dev, paper, paper_peak, args.paper_max_rounds)
    kernels["vc_expand"]["spill_launches"] = spilled["vc_expand"]
    kernels["vc_expand"]["spill_path"] = (
        "frontier spill: the paper size solo (twice), in 2 lanes through solve_many and "
        "the service, resumed mid-spill, golden_spill.json and the JAX-written spill "
        "checkpoint, phase 13")
    kernels["clique_expand"]["spill_launches"] = spilled["clique_expand"]
    kernels["clique_expand"]["spill_path"] = "max clique exact solve, spilled, phase 13"
    for name in ("vc_expand", "clique_expand"):
        check(kernels[name]["spill_launches"] > 0, f"no spilled path launched {name}")
    # and the faulted solves their fifth
    faulted = timed("faults", phase_faults, dev, service["churn_records"], spilled["paper"])
    kernels["vc_expand"]["fault_launches"] = faulted["vc_expand"]
    kernels["vc_expand"]["fault_path"] = (
        "faults: both chaos legs, the spilled paper size under a crash, corruption and "
        "I/O errors, the lane-churn service under two crashes and a stall, phase 14")
    kernels["clique_expand"]["fault_launches"] = faulted["clique_expand"]
    kernels["clique_expand"]["fault_path"] = "max clique in solve_many, one lane crashed, phase 14"
    for name in ("vc_expand", "clique_expand"):
        check(kernels[name]["fault_launches"] > 0, f"no faulted path launched {name}")

    # every f32 comparison on the card in full f32: no TF32 (the matmul
    # default, stated; cuDNN's default is TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels.update(timed("lm_kernels", phase_lm_kernels, dev))
    timed("golden_lm", phase_golden_lm, dev)
    serving = timed("serve_lm", phase_serve_lm, dev)
    attn = kernels["flash_attention"]
    for variant, fields in attn["variants"].items():
        fields["launches"] = serving.get(f"flash_attention.{variant}", 0)
    attn["launches"] = sum(f["launches"] for f in attn["variants"].values())
    check(attn["variants"]["tensor_core"]["launches"] > 0,
          "the serving path launched no tensor-core flash_attention kernel")
    kernels["wkv6"]["launches"] = serving.get("wkv6", 0)
    check(kernels["wkv6"]["launches"] > 0, "the serving path launched no wkv6 kernel")

    print(f"[smoke] phase walls (s): {walls}; total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": list(kernels.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
