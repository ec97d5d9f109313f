"""Paper case study end to end: a DIMACS-style hard instance solved by the
semi-centralized, centralized and SPMD engines, the §4 comparison (byte
counts, failed requests, encoding effect) at laptop scale, every backend
driven through the one ``SolverSession`` façade.

The port's twin of ``examples/solve_dimacs.py``, whole: the simulators run
on the host, the SPMD engine and the batched plane on ``--device`` (the card
by default).

  PYTHONPATH=src python -m repro_torch.examples.solve_dimacs [n] [density] [--device cpu]

Multi-file mode: DIMACS files packed onto ONE batched solve plane
(``session.solve_many``), ``--problem`` picking the registry problem:

  PYTHONPATH=src python -m repro_torch.examples.solve_dimacs --files a.col b.col
  PYTHONPATH=src python -m repro_torch.examples.solve_dimacs --problem mis --files a.col

Memory-tier mode (``--spill``): an instance whose peak frontier exceeds a
tiny hot capacity, solved without spill (tasks dropped, ``overflow_count``)
and with the host cold tier (``frontier_spill=True``): the engine-sized
optimum, no drop, and the cold-tier traffic printed:

  PYTHONPATH=src python -m repro_torch.examples.solve_dimacs --spill
"""

from __future__ import annotations

import argparse

from repro_torch.api import SolveConfig, SolverSession
from repro_torch.graphs.generators import erdos_renyi, p_hat_like, parse_dimacs, to_dimacs
from repro_torch.problems.registry import get_problem


def solve_files(paths, problem="vertex_cover", device="cuda"):
    """Pack several DIMACS instances onto one batched solve plane."""
    spec = get_problem(problem)
    graphs = []
    for path in paths:
        with open(path) as f:
            graphs.append(parse_dimacs(f.read()))
    session = SolverSession(
        problem=spec, config=SolveConfig(num_workers=8, steps_per_round=16),
        device=device,
    )
    res = session.solve_many(graphs)
    print(f"{len(graphs)} instances [{spec.name}] on one plane, "
          f"{len(res.buckets)} (n,W) bucket(s), {res.wall_s:.2f}s total "
          f"({len(graphs) / max(res.wall_s, 1e-9):.2f} inst/s)")
    for path, g, r in zip(paths, graphs, res.results):
        ok = spec.verify(g, r.best_sol)
        print(f"  {path}: n={g.n} m={g.num_edges} best={r.best_size} "
              f"rounds={r.rounds} nodes={r.nodes_expanded} verified={ok}")


def solve_with_spill(device="cuda"):
    """A saturating solve, dropped against spilled, the optimum preserved."""
    g = erdos_renyi(48, 0.28, seed=0)
    cap = 12  # hot slots per worker, far below this search's peak frontier
    base = SolveConfig(
        num_workers=4, steps_per_round=2, chunk_rounds=2, capacity=cap
    )
    print(f"instance: n={g.n} m={g.num_edges}, hot capacity {cap} slots/worker")

    full = SolverSession(config=base.replace(capacity=None), device=device).solve(g)
    print(f"engine-sized capacity: mvc={full.best_size} ({full.rounds} rounds)")

    starved = SolverSession(config=base, device=device).solve(g)
    print(f"capacity={cap}, no spill:  mvc={starved.best_size}  "
          f"DROPPED {starved.stats.overflow_count} tasks "
          f"(overflow={starved.stats.overflow}) — completeness lost")

    spilled = SolverSession(config=base.replace(frontier_spill=True), device=device).solve(g)
    s = spilled.stats
    if spilled.best_size != full.best_size or s.overflow_count != 0:
        raise SystemExit("the spilled solve lost the optimum or dropped tasks")
    print(f"capacity={cap}, --spill:   mvc={spilled.best_size}  dropped 0, "
          f"spilled {s.spilled_tasks} / readmitted {s.readmitted_tasks} "
          f"tasks through a cold tier peaking at {s.cold_bytes_peak}B "
          f"({spilled.rounds} rounds) — optimum preserved")


def compare(n: int, density: float, device="cuda"):
    """The §4 table on ``p_hat_like(n, density, 0)``: both simulators under
    both codecs, the SPMD engine on both transfer paths, and the batched
    plane against solo solves."""
    g = p_hat_like(n, density, seed=0)
    print(f"p_hat-style instance: n={g.n} m={g.num_edges}")
    print(to_dimacs(g).splitlines()[0])

    best = SolverSession(backend="sequential", device=device).solve(g)
    print(f"\nsequential: mvc={best.best_size}, {best.nodes_expanded} nodes")

    print(f"\n{'engine':<22}{'codec':<12}{'ticks/rounds':<14}{'bytes':<12}"
          f"{'center B':<10}{'failed':<7}")
    for codec in ("optimized", "basic"):
        cfg = SolveConfig(num_workers=8, codec=codec)
        semi = SolverSession(backend="protocol_sim", config=cfg, device=device).solve(g)
        cent = SolverSession(backend="centralized", config=cfg, device=device).solve(g)
        if not semi.best_size == cent.best_size == best.best_size:
            raise SystemExit("a simulator missed the sequential optimum")
        print(f"{'semi-centralized':<22}{codec:<12}{semi.rounds:<14}"
              f"{semi.stats.total_bytes:<12}{semi.stats.center_bytes:<10}"
              f"{semi.stats.failed_requests:<7}")
        print(f"{'centralized':<22}{codec:<12}{cent.rounds:<14}"
              f"{cent.stats.total_bytes:<12}{'-':<10}{'-':<7}")

    # SPMD engine: both data-plane paths must agree bit for bit (sparse
    # moves only matched records; gather moves the full P-row table)
    spmd = {}
    for impl in ("sparse", "gather"):
        session = SolverSession(config=SolveConfig(
            num_workers=8, steps_per_round=16, transfer_impl=impl), device=device)
        r = session.solve(g)
        if r.best_size != best.best_size:
            raise SystemExit(f"the SPMD engine [{impl}] missed the optimum")
        spmd[impl] = r
        print(f"\nSPMD engine [{impl:>6}]: mvc={r.best_size}, "
              f"{r.rounds} supersteps, {r.tasks_transferred} transfers, "
              f"{r.stats.control_bytes_per_round} control B/round, "
              f"{r.stats.transfer_bytes_per_round:.1f} payload B/round")
    a, b = spmd["sparse"], spmd["gather"]
    if not (a.best_size == b.best_size and (a.best_sol == b.best_sol).all()):
        raise SystemExit("the transfer paths differ")
    print("transfer paths bit-identical; sparse payload "
          f"{a.stats.transfer_bytes_total}B vs gather "
          f"{b.stats.transfer_bytes_total}B")

    # batched solve plane: mixed-size instances packed onto one plane,
    # per-instance results bit-identical to solo solves
    sizes = [n, max(n - 7, 8), max(n - 13, 6), n]
    graphs = [p_hat_like(m, density, seed=s) for s, m in enumerate(sizes)]
    session = SolverSession(config=SolveConfig(num_workers=8, steps_per_round=16),
                            device=device)
    batch = session.solve_many(graphs)
    print(f"\nsolve_many over {len(graphs)} mixed-size instances "
          f"(n={sizes}, {len(batch.buckets)} bucket(s)):")
    for g, r in zip(graphs, batch.results):
        solo = session.solve(g)
        if (r.best_size, r.rounds) != (solo.best_size, solo.rounds) or not (
            r.best_sol == solo.best_sol
        ).all():
            raise SystemExit(f"n={g.n}: the batch differs from the solo solve")
        print(f"  n={g.n}: mvc={r.best_size} rounds={r.rounds} "
              f"(== solo solve, bit-identical)")
    print(f"session cache after the cross-checks: {session.cache_stats()}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="repro_torch.examples.solve_dimacs")
    ap.add_argument("n", type=int, nargs="?", default=60)
    ap.add_argument("density", type=float, nargs="?", default=0.4)
    ap.add_argument("--files", nargs="+", default=None, help="DIMACS files: one batched plane")
    ap.add_argument("--problem", default="vertex_cover")
    ap.add_argument("--spill", action="store_true", help="the memory-tier example")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.spill:
        solve_with_spill(args.device)
        return
    try:
        get_problem(args.problem)
    except ValueError as e:
        raise SystemExit(f"error: {e}")
    if args.files:
        solve_files(args.files, args.problem, args.device)
        return
    if args.problem != "vertex_cover":
        raise SystemExit(
            "the single-instance §4 comparison is vertex-cover only; "
            "use --problem with --files (the batched generic plane)"
        )
    compare(args.n, args.density, args.device)


if __name__ == "__main__":
    main()
