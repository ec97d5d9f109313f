"""Solver driver of the port: any registry problem, any backend, one config.

  --engine spmd         the superstep engine on the card (P virtual workers)
  --engine protocol_sim the asynchronous MPI-protocol simulator, on the host
                        (alias: protocol)
  --engine centralized  the fully-centralized baseline, on the host (alias:
                        central)
  --engine sequential   the problem's sequential reference (alias: seq)

The port of ``repro/launch/solve.py``: the same graph flags, the same
config flags (a ``--config`` JSON is read by both packages alike), the same
checkpoint flags (``--checkpoint-dir``, ``--checkpoint-every``, and
``--resume DIR``, which rebuilds the solve from a checkpoint of either
package), the same spill flags (``--spill``, ``--spill-codec``: a saturated
frontier spills to the host cold tier instead of dropping tasks), the same
chaos flags (``--chaos N --chaos-seed S``: N seeded faults of
``repro_torch.faults``, healed, with the injector's report printed) and the
same ``[solve] best=... rounds=...`` lines.  Several DIMACS files
(``--files``) and/or ``--batch B`` generated instances (consecutive seeds)
go to ``solve_many``, one batched plane per W bucket.  It runs on the card
unless ``--device cpu`` asks for the CPU.

``--use-mesh`` runs the spmd solve one worker a rank of a
``torch.distributed`` group (:mod:`repro_torch.launch.mesh`): under
``torchrun`` (``RANK``/``WORLD_SIZE`` set) each process joins that group;
otherwise the command starts ``--workers`` ranks on this host itself.
Rank 0 prints the lines, which equal the single-process solve's.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.solve --graph gnp --n 600 \\
      --p 0.00668 --workers 128 --max-rounds 64
  PYTHONPATH=src python -m repro_torch.launch.solve --device cpu --n 40 --workers 4
  PYTHONPATH=src python -m repro_torch.launch.solve --device cpu --n 40 \\
      --problem max_clique --engine protocol_sim --workers 8
  PYTHONPATH=src python -m repro_torch.launch.solve --device cpu \\
      --problem max_clique --n 20 --p 0.4 --workers 4 --batch 4
  PYTHONPATH=src python -m repro_torch.launch.solve --n 600 --p 0.00668 \\
      --workers 128 --checkpoint-dir ckpt --checkpoint-every 4
  PYTHONPATH=src python -m repro_torch.launch.solve --resume ckpt  # after a kill
  PYTHONPATH=src python -m repro_torch.launch.solve --device cpu --n 40 \
      --p 0.28 --workers 4 --steps-per-round 2 --chunk-rounds 2 \
      --capacity 16 --spill
  PYTHONPATH=src python -m repro_torch.launch.solve --device cpu --n 48 \
      --p 0.28 --workers 4 --steps-per-round 2 --chunk-rounds 1 \
      --checkpoint-dir ck --chaos 8 --chaos-seed 3
  PYTHONPATH=src python -m repro_torch.launch.solve --device cpu --n 40 \\
      --workers 4 --use-mesh                      # 4 gloo ranks on the CPU
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.solve \\
      --n 600 --p 0.00668 --workers 4 --use-mesh
"""

from __future__ import annotations

import argparse
import os
import sys

from repro_torch.graphs.generators import erdos_renyi, p_hat_like, parse_dimacs


def build_graph(args, seed=None):
    seed = args.seed if seed is None else seed
    if args.graph == "gnp":
        return erdos_renyi(args.n, args.p if args.p else 4.0 / (args.n - 1), seed)
    if args.graph == "phat":
        return p_hat_like(args.n, args.density, seed)
    if args.graph == "dimacs":
        with open(args.file) as f:
            return parse_dimacs(f.read())
    raise ValueError(args.graph)


def build_graphs(args):
    """The multi-instance work list: every --files entry, plus --batch
    generated instances (consecutive seeds).  Empty unless one of those
    multi-instance flags was used."""
    graphs, labels = [], []
    for path in args.files or []:
        with open(path) as f:
            graphs.append(parse_dimacs(f.read()))
        labels.append(path)
    if args.batch is not None:
        if args.batch < 1:
            raise SystemExit("--batch must be >= 1")
        if args.graph == "dimacs":
            raise SystemExit("--batch needs a generated graph (gnp/phat)")
        for b in range(args.batch):
            graphs.append(build_graph(args, seed=args.seed + b))
            labels.append(f"{args.graph}-n{args.n}-seed{args.seed + b}")
    return graphs, labels


# CLI flag dest -> SolveConfig field.  These flags default to SUPPRESS so
# only EXPLICIT flags override a --config file (load -> override -> dump).
CONFIG_FLAGS = {
    "workers": "num_workers",
    "codec": "codec",
    "policy": "policy",
    "steps_per_round": "steps_per_round",
    "lanes": "lanes",
    "transfer": "transfer_impl",
    "explore": "explore_impl",
    "donate_k": "donate_k",
    "chunk_rounds": "chunk_rounds",
    "use_mesh": "use_mesh",
    "mode": "mode",
    "k": "k",
    "latency": "latency",
    "capacity": "capacity",
    "max_rounds": "max_rounds",
    "checkpoint_dir": "checkpoint_dir",
    "checkpoint_every": "checkpoint_every",
    "spill": "frontier_spill",
    "spill_codec": "spill_codec",
}


def effective_config(args):
    """--config base (or defaults), overridden by explicit CLI flags."""
    from repro_torch.api import SolveConfig

    base = SolveConfig.load(args.config) if args.config else SolveConfig()
    provided = {
        CONFIG_FLAGS[dest]: value
        for dest, value in vars(args).items()
        if dest in CONFIG_FLAGS
    }
    return base.replace(**provided) if provided else base


def resume_solve(args):
    """--resume DIR: rebuild the session FROM the checkpoint (problem,
    config and graphs all live in it) and run to completion.  Explicit CLI
    flags act as config overrides; the fingerprint check refuses any that
    would change the solve trajectory."""
    from repro_torch.api import BatchSolveResult, SolverSession

    overrides = {
        CONFIG_FLAGS[dest]: value
        for dest, value in vars(args).items()
        if dest in CONFIG_FLAGS
    }
    res = SolverSession.resume(args.resume, device=args.device, **overrides)
    if isinstance(res, BatchSolveResult):
        for i, r in enumerate(res.results):
            print(f"[solve]   instance {i}: best={r.best_size} "
                  f"rounds={r.rounds} nodes={r.nodes_expanded}")
        print(f"[solve] resumed batch from {args.resume}: "
              f"{len(res.results)} instances in {res.wall_s:.2f}s")
    else:
        print(f"[solve] resumed from {args.resume}: best={res.best_size} "
              f"rounds={res.rounds} nodes={res.nodes_expanded} "
              f"wall={res.wall_s:.2f}s")
    return res


def _parser() -> argparse.ArgumentParser:
    S = argparse.SUPPRESS
    ap = argparse.ArgumentParser()
    ap.add_argument("--graph", default="gnp", choices=["gnp", "phat", "dimacs"])
    ap.add_argument("--n", type=int, default=60)
    ap.add_argument("--p", type=float, default=0.0)
    ap.add_argument("--density", type=float, default=0.4)
    ap.add_argument("--file", default=None)
    ap.add_argument("--files", nargs="+", default=None,
                    help="several DIMACS files -> one solve_many batch")
    ap.add_argument("--batch", type=int, default=None,
                    help="generate B instances (seeds seed..seed+B-1) and "
                         "solve them on one batched plane (B=1 still uses "
                         "the batched plane)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--engine", default="spmd",
                    help="backend: spmd, protocol_sim (protocol), centralized "
                         "(central), sequential (seq)")
    ap.add_argument("--problem", default="vertex_cover")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; there is no silent "
                         "fallback to the CPU)")
    ap.add_argument("--config", default=None,
                    help="JSON SolveConfig to start from; explicit CLI "
                         "flags override it")
    ap.add_argument("--dump-config", default=None, metavar="PATH",
                    help="write the EFFECTIVE config as JSON ('-' prints) "
                         "and still run the solve")
    # -- SolveConfig knobs (SUPPRESS default = "not explicitly provided") ----
    ap.add_argument("--workers", type=int, default=S)
    ap.add_argument("--codec", default=S)
    ap.add_argument("--policy", default=S, choices=["priority", "random"])
    ap.add_argument("--steps-per-round", type=int, default=S)
    ap.add_argument("--lanes", type=int, default=S)
    ap.add_argument("--transfer", default=S, choices=["sparse", "gather"])
    ap.add_argument("--explore", default=S, choices=["fused", "reference"])
    ap.add_argument("--donate-k", type=int, default=S)
    ap.add_argument("--chunk-rounds", type=int, default=S)
    ap.add_argument("--use-mesh", action="store_true", default=S,
                    help="one worker a torch.distributed rank (spmd): joins "
                         "the torchrun group, else starts --workers ranks")
    ap.add_argument("--mode", default=S, choices=["bnb", "fpt"])
    ap.add_argument("--k", type=int, default=S)
    ap.add_argument("--latency", type=int, default=S,
                    help="simulator message latency in ticks")
    ap.add_argument("--capacity", type=int, default=S,
                    help="hot frontier slots per worker "
                         "(default: engine-sized 4n + 8*lanes)")
    ap.add_argument("--max-rounds", type=int, default=S,
                    help="superstep budget (checked per chunk): a bounded "
                         "anytime solve")
    ap.add_argument("--checkpoint-dir", default=S, metavar="DIR",
                    help="write a resumable SolveCheckpoint every "
                         "--checkpoint-every chunks (spmd)")
    ap.add_argument("--checkpoint-every", type=int, default=S,
                    help="chunks between checkpoint writes (default 8)")
    ap.add_argument("--spill", action="store_true", default=S,
                    help="hierarchical frontier memory: evict past the "
                         "high-water mark to a codec-compressed host cold "
                         "tier instead of dropping tasks (spmd)")
    ap.add_argument("--spill-codec", default=S,
                    choices=["optimized", "basic"],
                    help="record encoding for the cold tier (default: "
                         "optimized, 2W+1 words/task)")
    ap.add_argument("--resume", default=None, metavar="DIR",
                    help="resume a checkpointed solve (dir or step_N subdir); "
                         "problem/config/graphs come from the checkpoint, "
                         "explicit flags override non-trajectory knobs")
    ap.add_argument("--chaos", type=int, default=None, metavar="N",
                    help="deterministic fault injection (spmd): fire N "
                         "random faults from repro_torch.faults (lane "
                         "crashes, stalls, payload corruption, checkpoint "
                         "I/O errors) and self-heal; results stay those of "
                         "a fault-free run")
    ap.add_argument("--chaos-seed", type=int, default=0,
                    help="seed for the --chaos fault plan (default 0)")
    return ap


def _injector(args, cfg, backend, say):
    """The ``--chaos`` injector (None without the flag)."""
    if args.chaos is None:
        return None
    if backend.name != "spmd":
        raise SystemExit("--chaos needs the spmd engine")
    from repro_torch.faults import FaultInjector, FaultPlan

    plan = FaultPlan.random(args.chaos_seed, n_events=args.chaos, lanes=cfg.lanes)
    say(f"[solve] chaos: {args.chaos} seeded fault(s) "
        f"(seed {args.chaos_seed}): {plan.counts()}")
    return FaultInjector(plan)


def _mesh_solve(mesh, argv):
    """One rank of ``--use-mesh``: the command's solve, this rank's worker
    on ``mesh``.  Returns (result, the injector's report or None)."""
    from repro_torch.api import SolverSession, get_backend
    from repro_torch.problems.registry import get_problem

    args = _parser().parse_args(argv)
    cfg = effective_config(args)
    backend = get_backend(args.engine)
    injector = _injector(args, cfg, backend, lambda _: None)
    extra = {"injector": injector} if injector is not None else {}
    session = SolverSession(problem=get_problem(args.problem), backend=backend,
                            config=cfg, device=mesh.device)
    r = session.solve(build_graph(args), mesh=mesh, **extra)
    return r, (injector.report() if injector is not None else None)


# the --use-mesh ranks' time limit when this command starts them: a bound
# on a hung job, not on the solve
MESH_TIMEOUT_S = 24 * 3600.0


def _solve_on_mesh(args, argv, cfg):
    """``--use-mesh``: (result, injector report) of rank 0, from the
    torchrun group this process is a rank of, or from ``--workers`` ranks
    started here."""
    from repro_torch.launch import mesh as _mesh

    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return _mesh.spawn_mesh(_mesh_solve, cfg.num_workers, device=args.device,
                                timeout_s=MESH_TIMEOUT_S, args=(argv,))[0]
    import torch.distributed as dist

    dev = _mesh.rank_device(args.device)
    local = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ["WORLD_SIZE"]))
    dist.init_process_group(_mesh.mesh_backend(dev, local))
    try:
        return _mesh_solve(_mesh.make_solver_mesh(cfg.num_workers, device=dev), argv)
    finally:
        dist.destroy_process_group()


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    args = _parser().parse_args(argv)

    if args.resume:
        return resume_solve(args)

    from repro_torch.api import SolverSession, get_backend
    from repro_torch.problems.registry import get_problem

    try:
        cfg = effective_config(args)
        spec = get_problem(args.problem)
        backend = get_backend(args.engine)
    except ValueError as e:
        raise SystemExit(f"error: {e}")
    on_mesh = cfg.use_mesh and backend.name == "spmd"
    # under torchrun, rank 0 alone prints
    quiet = on_mesh and int(os.environ.get("RANK", "0")) != 0

    def say(line: str) -> None:
        if not quiet:
            print(line)

    if args.dump_config:
        if args.dump_config == "-":
            if not quiet:
                sys.stdout.write(cfg.to_json())
        elif not quiet:
            cfg.save(args.dump_config)
            print(f"[solve] effective config -> {args.dump_config}")

    injector = _injector(args, cfg, backend, say)
    extra = {"injector": injector} if injector is not None else {}

    batch_graphs, batch_labels = build_graphs(args)
    if batch_graphs:
        if cfg.use_mesh:
            raise SystemExit(
                "multi-instance mode has no mesh path yet (vmap virtual "
                "workers only) — drop --use-mesh"
            )
        session = SolverSession(
            problem=spec, backend=backend, config=cfg, device=args.device
        )
        print(f"[solve] batch of {len(batch_graphs)} instances "
              f"[{spec.name}] on {backend.name}, "
              f"workers/instance={cfg.num_workers}")
        res = session.solve_many(batch_graphs, **extra)
        for label, r in zip(batch_labels, res.results):
            print(f"[solve]   {label}: best={r.best_size} rounds={r.rounds} "
                  f"nodes={r.nodes_expanded} transfers={r.tasks_transferred}")
        print(f"[solve] batch done: {len(batch_graphs)} instances in "
              f"{res.wall_s:.2f}s "
              f"({len(batch_graphs) / max(res.wall_s, 1e-9):.2f} inst/s), "
              f"{len(res.buckets)} bucket(s), {res.compactions} "
              f"compaction(s); cache: {session.cache_stats()}")
        if injector is not None:
            print(f"[solve] chaos report: {injector.report()}")
        return

    g = build_graph(args)
    say(f"[solve] graph n={g.n} m={g.num_edges} engine={backend.name} "
        f"problem={spec.name}")
    if on_mesh:
        r, report = _solve_on_mesh(args, argv, cfg)
    else:
        session = SolverSession(
            problem=spec, backend=backend, config=cfg, device=args.device
        )
        r = session.solve(g, **extra)
        report = injector.report() if injector is not None else None
    line = (f"[solve] best={r.best_size} rounds={r.rounds} "
            f"nodes={r.nodes_expanded} transfers={r.tasks_transferred} "
            f"wall={r.wall_s:.2f}s")
    s = r.stats
    if backend.name == "spmd":
        line += (f" overflow={s.overflow} "
                 f"control_B/round={s.control_bytes_per_round} "
                 f"transfer_B/round={s.transfer_bytes_per_round:.1f} "
                 f"(total {s.transfer_bytes_total}B over "
                 f"{s.transfer_rounds} transfer rounds, "
                 f"{cfg.transfer_impl})")
        if s.checkpoints_written:
            line += f" checkpoints={s.checkpoints_written}"
        if s.spilled_tasks:
            line += (f" spilled={s.spilled_tasks} "
                     f"readmitted={s.readmitted_tasks} "
                     f"cold_peak={s.cold_bytes_peak}B")
    elif backend.name in ("protocol_sim", "centralized"):
        line += (f" bytes={s.total_bytes}"
                 + (f" (center {s.center_bytes})"
                    f" failed_requests={s.failed_requests}"
                    if backend.name == "protocol_sim" else ""))
    say(line)
    if report is not None:
        say(f"[solve] chaos report: {report}")


if __name__ == "__main__":
    main()
