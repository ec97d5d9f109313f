"""Run the port's benchmark mirrors and gate a smoke run on the baseline.

  protocol_stats     §3 message accounting (failed requests == 0)
  encoding_bytes     §4.3 serialization sizes
  engine_throughput  engine rounds/transfers budget, chunked A/B, transfer A/B
  batch_throughput   multi-instance solve plane vs a loop of solo solves
  clique_smoke       max clique on the batched plane vs the sequential reference
  session_warm       cold vs warm session solves (the plane cache)
  explore_throughput fused vs reference explore path, nodes/s
  serve_load         continuous-admission service vs fixed batching
  spill_throughput   frontier spill: no drop, the unsaturated optimum
  chaos_smoke        seeded fault schedule: bit-identical self-healing
  resume_smoke       SIGKILL mid-solve and a bit-identical resume
  balancer_bench     beyond-paper serving balancer
  kernel_bench       each kernel's arithmetic intensity (and time on the card)
  speedup            Fig. 4 / Table 1 (semi vs central x encodings)

Each runs its ``benchmarks/`` namesake's work on the port, on ``--device``
(the card unless ``--device cpu`` asks for the CPU; the simulators run on
the host either way).

Usage:
  PYTHONPATH=src python -m repro_torch.bench.run [--smoke] [--device DEV] [name ...]

``--smoke`` runs the shrunken sizes, by default the namesake's smoke set
(``SMOKE_DEFAULT``), and then gates the run with
:mod:`repro_torch.bench.check_regression`: every benchmark of
``benchmarks/baseline.json`` present and each exact pin met (with names
given, only those benchmarks' pins).  The returned dicts go to
``build/repro_torch_bench/BENCH.json``.
"""

from __future__ import annotations

import argparse
import inspect
import json
import sys
import time

from repro_torch.bench import (
    balancer_bench,
    batch_throughput,
    chaos_smoke,
    check_regression,
    clique_smoke,
    encoding_bytes,
    engine_throughput,
    explore_throughput,
    kernel_bench,
    protocol_stats,
    resume_smoke,
    serve_load,
    session_warm,
    speedup,
    spill_throughput,
)

ALL = {
    "encoding_bytes": encoding_bytes,
    "protocol_stats": protocol_stats,
    "engine_throughput": engine_throughput,
    "batch_throughput": batch_throughput,
    "clique_smoke": clique_smoke,
    "session_warm": session_warm,
    "explore_throughput": explore_throughput,
    "serve_load": serve_load,
    "spill_throughput": spill_throughput,
    "chaos_smoke": chaos_smoke,
    "resume_smoke": resume_smoke,
    "balancer_bench": balancer_bench,
    "kernel_bench": kernel_bench,
    "speedup": speedup,
}
# the namesake's smoke set (benchmarks/run.py)
SMOKE_DEFAULT = (
    "encoding_bytes", "batch_throughput", "clique_smoke", "session_warm",
    "explore_throughput", "serve_load", "spill_throughput", "chaos_smoke",
)

BASELINE = check_regression.BASELINE
OUT = check_regression.BENCH


def check_pins(baseline: dict, recorded: dict) -> list:
    """Violations of the baseline's rules by the benchmarks that ran (empty:
    all met): :func:`check_regression.check` over those benchmarks only."""
    ran = {k: v for k, v in baseline["benchmarks"].items() if k in recorded}
    return check_regression.check({"benchmarks": ran}, {"benchmarks": recorded})


def run_all(names, *, smoke: bool = False, device="cuda") -> dict:
    """Run each named benchmark; returns the dicts they return, by name."""
    recorded = {}
    for name in names:
        run_fn = ALL[name].run
        params = inspect.signature(run_fn).parameters
        kwargs = {}
        if smoke and "smoke" in params:
            kwargs["smoke"] = True
        if "device" in params:
            kwargs["device"] = device
        print(f"== {name} ==")
        t0 = time.perf_counter()
        out = run_fn(**kwargs)
        elapsed = time.perf_counter() - t0
        print(f"-- {name} done in {elapsed:.1f}s\n", flush=True)
        if isinstance(out, dict):
            entry = dict(out, elapsed_s=round(elapsed, 1))
            entry.setdefault("problem", "vertex_cover")
            recorded[name] = entry
    return recorded


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="repro_torch.bench.run")
    ap.add_argument("names", nargs="*", help="benchmarks to run (default: all)")
    ap.add_argument("--smoke", action="store_true",
                    help="shrunken sizes, held to the baseline's exact pins")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the SPMD rows (default: cuda)")
    args = ap.parse_args(argv)

    names = args.names or list(SMOKE_DEFAULT if args.smoke else ALL)
    unknown = [n for n in names if n not in ALL]
    if unknown:
        print(f"unknown benchmark(s): {', '.join(unknown)}\n"
              f"available: {', '.join(sorted(ALL))}", file=sys.stderr)
        raise SystemExit(2)

    recorded = run_all(names, smoke=args.smoke, device=args.device)
    run = {"smoke": args.smoke, "device": args.device, "benchmarks": recorded}
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps(run, indent=2) + "\n")
    print(f"wrote {OUT} ({', '.join(recorded) or 'no dict results'})")
    if args.smoke:
        baseline = json.loads(BASELINE.read_text())
        problems = (check_pins(baseline, recorded) if args.names
                    else check_regression.check(baseline, run))
        if problems:
            print(f"PINS VIOLATED: {len(problems)}")
            for p in problems:
                print(f"  - {p}")
            raise SystemExit(1)
        print(f"exact pins of {BASELINE.name} met for {', '.join(recorded)}")


if __name__ == "__main__":
    main()
