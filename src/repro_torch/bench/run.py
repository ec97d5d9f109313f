"""Run the port's benchmark mirrors and check the exact pins of the baseline.

  protocol_stats   §3 message accounting (failed requests == 0)
  encoding_bytes   §4.3 serialization sizes
  speedup          Fig. 4 / Table 1 (semi vs central x encodings); its
                   donation rows run the SPMD engine on ``--device``
  balancer_bench   beyond-paper serving balancer
  clique_smoke     max clique on the batched plane vs the sequential reference

Usage:
  PYTHONPATH=src python -m repro_torch.bench.run [--smoke] [--device DEV] [name ...]

``--smoke`` runs the shrunken sizes of ``benchmarks/run.py --smoke`` (by
default its mirrored benchmarks, ``encoding_bytes`` and ``clique_smoke``) and
then holds every dict a benchmark returns to the exact (``eq``) pins that
``benchmarks/baseline.json`` sets for it: encoded record bytes and the clique
sizes.  Its floors and ceilings are wall-clock readings of the JAX package on
a CPU and are not applied here.  The baseline is read, never written.  The
returned dicts go to ``build/repro_torch_bench/BENCH.json``.  The device is
the card unless ``--device cpu`` asks for the CPU; the simulators run on the
host either way.
"""

from __future__ import annotations

import argparse
import inspect
import json
import sys
import time
from pathlib import Path

from repro_torch.bench import (
    balancer_bench,
    clique_smoke,
    encoding_bytes,
    protocol_stats,
    speedup,
)

ALL = {
    "protocol_stats": protocol_stats,
    "encoding_bytes": encoding_bytes,
    "speedup": speedup,
    "balancer_bench": balancer_bench,
    "clique_smoke": clique_smoke,
}
SMOKE_DEFAULT = ("encoding_bytes", "clique_smoke")

ROOT = Path(__file__).resolve().parents[3]
BASELINE = ROOT / "benchmarks" / "baseline.json"
OUT = ROOT / "build" / "repro_torch_bench" / "BENCH.json"


def _lookup(entry, path: str):
    cur = entry
    for part in path.split("."):
        cur = cur[int(part)] if isinstance(cur, list) else cur[part]
    return cur


def check_pins(baseline: dict, recorded: dict) -> list:
    """Violations of the baseline's exact pins by the benchmarks that ran
    (empty: all pins met)."""
    problems = []
    for name, entry in recorded.items():
        for rule in baseline["benchmarks"].get(name, {}).get("checks", []):
            if "eq" not in rule:
                continue
            try:
                got = _lookup(entry, rule["path"])
            except (KeyError, IndexError, ValueError):
                problems.append(f"{name}.{rule['path']}: missing from the run")
                continue
            if got != rule["eq"]:
                problems.append(f"{name}.{rule['path']}: {got!r} != pinned {rule['eq']!r}")
    return problems


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
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps({"smoke": args.smoke, "device": args.device,
                               "benchmarks": recorded}, indent=2) + "\n")
    print(f"wrote {OUT} ({', '.join(recorded) or 'no dict results'})")
    if args.smoke:
        problems = check_pins(json.loads(BASELINE.read_text()), recorded)
        if problems:
            print(f"PINS VIOLATED: {len(problems)}")
            for p in problems:
                print(f"  - {p}")
            raise SystemExit(1)
        print(f"exact pins of {BASELINE.name} met for {', '.join(recorded)}")


if __name__ == "__main__":
    main()
