#!/usr/bin/env python3
"""Card smoke of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of the repository, with no arguments:

  python3 chip_smoke.py

Phases (any failed check raises, so the exit code is not 0):

1. card and build — the card's name and power limit from nvidia-smi; every
   CUDA kernel of the port built from the sources in the checkout, one nvcc
   per source, all started together;
2. kernels vs plain — ``batched_degrees`` and ``batched_expand_stats``
   against their plain PyTorch versions on the card, exactly, over n in
   {1, 31, 33, 300, 600, 2048}, T in {1, 2, 7, 128, 1024}, random, empty,
   full and single-bit masks (and random, empty and full sols), for one
   instance and for a padded batch of 3 with a task-row map; then both
   timed with CUDA events at the solve plane's shapes;
3. exact vertex-cover solves — ``SolverSession(device="cuda").solve``
   reproduces every solo and fpt golden of ``tests/golden_vc.json`` and the
   n = 300 golden ``src/repro_torch/data/golden_smoke.json``, all made by the
   JAX package; the covers verify and the sequential solver agrees;
4. max clique — the second path: an exact solve of ``p_hat_like(300,
   0.325, seed 0)`` (density 0.2456, the size class of DIMACS p_hat300-1)
   with 128 workers, equal to the JAX golden of
   ``src/repro_torch/data/golden_clique.json``; one ``batched_expand_stats``
   launch per explore round;
5. MIS — the paper's graph G(600, 4/599, seed 0) branched on its dense
   complement (W = 19), 128 workers, 64 supersteps, equal to its JAX golden;
6. the batched plane — ``solve_many`` of vertex cover on G(300, 4/299,
   seeds 0 and 1), 64 workers: instance 0 equals the n = 300 golden,
   instance 1 its own solo solve, one kernel launch per degree panel for the
   whole batch; a batch of two copies of seed 0 launches exactly what one
   solo solve does; and ``clique_smoke``'s configuration gives [4, 6, 4, 4];
7. paper size — the vertex-cover main path: G(600, 4/599, seed 0) with 128
   workers, a bounded anytime solve (``--paper-max-rounds``, 8 supersteps),
   run twice.

Kernel launch counts are zeroed just before each path runs and read just
after it.  The last three lines of standard output are the kernels JSON line,
the nvidia-smi line and ``{"ok": true, "device": {...}}``.  The script imports
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
# supersteps of each paper-size run: 16 took 86-90 s a run on an H100 at
# 700 W, so it is cut to 8 to keep the whole smoke near 5 minutes
PAPER_MAX_ROUNDS = 8
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
    kernel_ms = time_ms(lambda: batched_degrees(adj, m))
    plain_ms = time_ms(lambda: batched_degrees_ref(adj, m))
    moved = 4 * (n * W + T * W + T * n)  # adj and masks read once, out written once
    ops = 3 * T * n * W  # AND, popcount, add per (task, vertex, word)
    bound, by = _bound_ms(moved, ops)
    print(f"[smoke] batched_degrees T={T} n={n} W={W}: kernel {kernel_ms:.6f} ms, "
          f"plain {plain_ms:.6f} ms, bound {bound:.6f} ms ({moved} B, {ops} ops)")
    out["batched_degrees"] = {
        "name": "batched_degrees",
        "route": "cuda",
        "source": "src/repro_torch/kernels/bitset_ops/csrc/degrees.cu",
        "replaces": "src/repro/kernels/bitset_ops/kernel.py:180",
        "exact": err["batched_degrees"] == 0,
        "max_abs_err": err["batched_degrees"],
        "ms": kernel_ms,
        "plain_ms": plain_ms,
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
        kernel_ms = time_ms(lambda: batched_expand_stats(adj, m, s_))
        plain_ms = time_ms(lambda: expand_stats_ref(adj, m, s_))
        # adj, masks and sols read once; deg and pc written once
        moved = 4 * (n * W + 2 * T * W + T * n + 2 * T)
        ops = 3 * T * n * W + 4 * T * W  # + popcount and add per mask and sol word
        bound, by = _bound_ms(moved, ops)
        print(f"[smoke] batched_expand_stats ({label}) T={T} n={n} W={W}: kernel "
              f"{kernel_ms:.6f} ms, plain {plain_ms:.6f} ms, bound {bound:.6f} ms "
              f"({moved} B, {ops} ops)")
        if label == "max_clique":
            out["batched_expand_stats"] = {
                "name": "batched_expand_stats",
                "route": "cuda",
                "source": "src/repro_torch/kernels/bitset_ops/csrc/expand_stats.cu",
                "replaces": "src/repro/kernels/bitset_ops/kernel.py:138",
                "exact": err["batched_expand_stats"] == 0,
                "max_abs_err": err["batched_expand_stats"],
                "ms": kernel_ms,
                "plain_ms": plain_ms,
                "bound_ms": bound,
                "bound_by": by,
                "library_ms": None,  # no single PyTorch call computes a popcount panel
            }
    return out


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
        check(launches.get("batched_expand_stats", 0) == explore_rounds,
              f"{name}: {launches} launches, want one batched_expand_stats per "
              f"explore round ({explore_rounds})")
        print(f"[smoke] {name} full size: {spec}, m={g.num_edges}, "
              f"{cfg.num_workers} workers: best={r.best_size} rounds={r.rounds} "
              f"nodes={r.nodes_expanded} transfers={r.tasks_transferred} == JAX golden; "
              f"wall={wall:.3f} s, {1e3 * wall / r.rounds:.3f} ms/superstep, "
              f"nodes/s={r.nodes_expanded / wall:.1f}, launches={launches} "
              f"({launches['batched_expand_stats'] / explore_rounds:.2f} per explore round)")
        out[name] = launches
    return out["max_clique"]


def phase_batch(dev, solo_n300: dict) -> None:
    """The batched plane: vertex cover on two n = 300 instances, a batch of
    two copies, and clique_smoke's max-clique configuration."""
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

    def per_panel(launches, explore_rounds, sweeps):
        # one launch per degree panel: two per explore round, one per sweep
        check(launches.get("batched_degrees", 0) == 2 * explore_rounds + sweeps,
              f"{launches} launches for {explore_rounds} explore rounds and "
              f"{sweeps} sweeps: not one launch per panel")
        return (launches["batched_degrees"] - sweeps) / explore_rounds

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
    per_round = per_panel(launches, ran * cfg.steps_per_round, sweeps)
    print(f"[smoke] solve_many VC G(300, 4/299, seeds 0, 1), 64 workers: "
          f"instance 0 == golden_smoke, instance 1 == its solo solve "
          f"(best {r1.best_size}, {r1.rounds} rounds, solo wall {wall1:.3f} s, "
          f"sweeps {solo1.stats.reduce_sweeps}); batch wall {wall:.3f} s; "
          f"launches={launches}, sweeps={sweeps}: {per_round:.0f} per explore round "
          f"+ one per sweep, for the whole batch")

    counts.reset()
    twins = session.solve_many([g0, g0])
    launches = counts.snapshot()
    for r in twins.results:
        check(record(r) == smoke["result"], f"twin batch: {record(r)} != golden_smoke")
    check(launches == solo_n300["launches"],
          f"a batch of two copies launched {launches}, one solo solve "
          f"{solo_n300['launches']}: the batch must launch once per panel")
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
    check(launches.get("batched_expand_stats", 0) == ran * cfg.steps_per_round,
          f"clique_smoke: {launches} launches for {ran * cfg.steps_per_round} "
          f"explore rounds of the batch of 4")
    print(f"[smoke] clique_smoke on the card: sizes={sizes} (verified against the "
          f"sequential reference), launches={launches}: one per explore round "
          f"for the batch of {len(graphs)}")


def phase_paper(dev, max_rounds: int) -> dict:
    """The main path at the paper's size, twice; returns its launch counts."""
    from repro_torch.api import SolveConfig, SolverSession
    from repro_torch.graphs.generators import erdos_renyi
    from repro_torch.kernels import counts
    from repro_torch.problems.sequential import verify_cover

    g = erdos_renyi(**PAPER_GRAPH)
    # max_rounds is checked per chunk, so the chunk is cut with it
    cfg = SolveConfig(num_workers=PAPER_WORKERS, max_rounds=max_rounds,
                      chunk_rounds=min(16, max_rounds))
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

    t_start = t0 = time.perf_counter()
    logs = build.build_all()
    print(f"[smoke] built {sorted(build.SOURCES)} in {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"[smoke]   {name}: {line.strip()}")

    walls = {}

    def timed(name, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        walls[name] = round(time.perf_counter() - t, 3)
        return out

    kernels = timed("kernels", phase_kernels, dev)
    solo_n300 = timed("goldens", phase_goldens, dev)
    clique = timed("clique_mis", phase_clique_goldens, dev)
    timed("batch", phase_batch, dev, solo_n300)
    launches = timed("paper", phase_paper, dev, args.paper_max_rounds)
    kernels["batched_degrees"]["launches"] = launches.get("batched_degrees", 0)
    kernels["batched_expand_stats"]["launches"] = clique.get("batched_expand_stats", 0)
    check(kernels["batched_expand_stats"]["launches"] > 0,
          "the max-clique path launched no batched_expand_stats kernel")

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
