#!/usr/bin/env python3
"""Card smoke of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of the repository, with no arguments:

  python3 chip_smoke.py

Phases (any failed check raises, so the exit code is not 0):

1. card and build — the card's name and power limit from nvidia-smi; every
   CUDA kernel of the port built from the sources in the checkout;
2. kernel vs plain — ``batched_degrees`` against its plain PyTorch version
   on the card, exactly, over n in {1, 31, 33, 300, 600, 2048}, T in
   {1, 2, 7, 128, 1024} and random, empty, full and single-bit masks; then
   both timed with CUDA events at the solve plane's shape;
3. exact solves — ``SolverSession(device="cuda").solve`` reproduces every
   solo and fpt golden of ``tests/golden_vc.json`` and the n = 300 golden
   ``src/repro_torch/data/golden_smoke.json``, all made by the JAX package;
   the covers verify and the port's sequential solver agrees on the optimum;
4. paper size — the main path: G(600, 4/599, seed 0) with 128 workers, a
   bounded anytime solve (``--paper-max-rounds``), run twice.  Kernel launch
   counts are zeroed just before the first run and read just after it.

The last three lines of standard output are the kernels JSON line, the
nvidia-smi line and ``{"ok": true, "device": {...}}``.  The script imports
nothing of JAX and nothing of the JAX package ``repro``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, and the non-tensor-core
# 32-bit rate, used here for the kernel's 32-bit integer operations
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12

PAPER_GRAPH = dict(n=600, p=4.0 / 599, seed=0)
PAPER_WORKERS = 128
PAPER_MAX_ROUNDS = 16  # one chunk: about 60-85 s a run on an H100 at 700 W


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


def time_ms(fn, reps: int = 50, warmup: int = 10) -> float:
    """Median device time of one call, from CUDA events around each call."""
    import torch

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


def phase_kernels(dev):
    """Kernel vs plain version on the card, then their times at the plane's
    shape.  Returns the kernel's fields of the kernels line (launches aside)."""
    import numpy as np
    import torch

    from repro_torch.graphs.bitgraph import mask_full, n_words
    from repro_torch.graphs.generators import erdos_renyi
    from repro_torch.kernels.bitset_ops import batched_degrees, batched_degrees_ref

    max_err = 0
    checked = 0
    for n in (1, 31, 33, 300, 600, 2048):
        W = n_words(n)
        g = erdos_renyi(n, min(1.0, 8.0 / max(n - 1, 1)), n)
        adj = words_on(g.adj, dev)
        full = mask_full(n)
        for T in (1, 2, 7, 128, 1024):
            rng = np.random.default_rng(n * 10_000 + T)
            single = np.zeros((T, W), np.uint32)
            v = np.arange(T) % n
            v[0] = min(31, n - 1)  # bit 31 of a word whenever n > 31
            single[np.arange(T), v // 32] = np.uint32(1) << (v % 32).astype(np.uint32)
            kinds = {
                "random": rng.integers(0, 2**32, size=(T, W), dtype=np.uint32) & full,
                "empty": np.zeros((T, W), np.uint32),
                "full": np.tile(full, (T, 1)),
                "single": single,
            }
            for kind, masks in kinds.items():
                m = words_on(masks, dev)
                got = batched_degrees(adj, m)
                want = batched_degrees_ref(adj, m)
                torch.cuda.synchronize()
                err = int((got.long() - want.long()).abs().max())
                max_err = max(max_err, err)
                checked += 1
                check(
                    torch.equal(got, want),
                    f"batched_degrees != plain at n={n} T={T} masks={kind} "
                    f"(max abs err {err})",
                )
    print(f"[smoke] batched_degrees == plain version on {checked} cases "
          f"(max abs err {max_err})")

    # times at the solve plane's shape: T = P*lanes = 128, n = 600, W = 19
    n, T = PAPER_GRAPH["n"], PAPER_WORKERS
    W = n_words(n)
    g = erdos_renyi(**PAPER_GRAPH)
    rng = np.random.default_rng(0)
    adj = words_on(g.adj, dev)
    m = words_on(rng.integers(0, 2**32, size=(T, W), dtype=np.uint32) & mask_full(n), dev)
    kernel_ms = time_ms(lambda: batched_degrees(adj, m))
    plain_ms = time_ms(lambda: batched_degrees_ref(adj, m))
    moved = 4 * (n * W + T * W + T * n)  # adj and masks read once, out written once
    ops = 3 * T * n * W  # AND, popcount, add per (task, vertex, word)
    bytes_ms = moved / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_OPS_PER_S * 1e3
    print(f"[smoke] batched_degrees T={T} n={n} W={W}: kernel {kernel_ms:.6f} ms, "
          f"plain {plain_ms:.6f} ms, bound {max(bytes_ms, ops_ms):.6f} ms "
          f"({moved} B, {ops} ops)")
    return {
        "name": "batched_degrees",
        "route": "cuda",
        "source": "src/repro_torch/kernels/bitset_ops/csrc/degrees.cu",
        "replaces": "src/repro/kernels/bitset_ops/kernel.py:180",
        "exact": max_err == 0,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        # torch has no popcount, so no single PyTorch call computes this
        "library_ms": None,
    }


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


def phase_goldens(dev) -> None:
    from repro_torch.api import SolveConfig, SolverSession
    from repro_torch.graphs.generators import erdos_renyi
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
        t0 = time.perf_counter()
        r = SolverSession(config=SolveConfig(**kw), device=dev).solve(g)
        wall = time.perf_counter() - t0
        got = record(r)
        check(got == want, f"golden {label}: got {got}, want {want}")
        check(verify_cover(g, r.best_sol), f"golden {label}: cover does not verify")
        opt, _, _ = solve_sequential(g)
        check(opt == r.best_size, f"golden {label}: sequential optimum {opt} != {r.best_size}")
        print(f"[smoke] golden {label}: n={g.n} best={r.best_size} rounds={r.rounds} "
              f"nodes={r.nodes_expanded} transfers={r.tasks_transferred} "
              f"== JAX golden, {wall:.3f} s")


def phase_paper(dev, max_rounds: int) -> dict:
    """The main path at the paper's size, twice; returns its launch counts."""
    from repro_torch.api import SolveConfig, SolverSession
    from repro_torch.graphs.generators import erdos_renyi
    from repro_torch.kernels import counts
    from repro_torch.problems.sequential import verify_cover

    g = erdos_renyi(**PAPER_GRAPH)
    cfg = SolveConfig(num_workers=PAPER_WORKERS, max_rounds=max_rounds)
    session = SolverSession(config=cfg, device=dev)
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
        print(f"[smoke] paper run {i}: best={r.best_size} rounds={r.rounds} "
              f"nodes={r.nodes_expanded} transfers={r.tasks_transferred} "
              f"wall={wall:.3f} s nodes/s={r.nodes_expanded / wall:.1f} "
              f"supersteps/s={r.rounds / wall:.3f} "
              f"reduce_sweeps={r.stats.reduce_sweeps} "
              f"sweeps/explore_round={r.stats.reduce_sweeps / explore_rounds:.2f} "
              f"launches={launches}")
        runs.append(record(r))
    check(runs[0] == runs[1], f"paper runs differ: {runs[0]} vs {runs[1]}")
    check(launches.get("batched_degrees", 0) > 0,
          f"the main path launched no batched_degrees kernel: {launches}")
    return launches


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

    t0 = time.perf_counter()
    logs = build.build_all()
    print(f"[smoke] built {sorted(build.SOURCES)} in {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"[smoke]   {name}: {line.strip()}")

    kernel = phase_kernels(dev)
    phase_goldens(dev)
    launches = phase_paper(dev, args.paper_max_rounds)
    kernel["launches"] = launches.get("batched_degrees", 0)

    print(json.dumps({"kernels": [kernel]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
