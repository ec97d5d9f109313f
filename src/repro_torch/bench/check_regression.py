"""Gate a smoke run of the port's benchmark mirrors against the baseline.

The port's mirror of ``benchmarks/check_regression.py``, with its rule
schema, over the run that ``python -m repro_torch.bench.run --smoke`` writes
to ``build/repro_torch_bench/BENCH.json``::

    PYTHONPATH=src python -m repro_torch.bench.run --smoke [--device cpu]
    PYTHONPATH=src python -m repro_torch.bench.check_regression

Every benchmark that ``benchmarks/baseline.json`` names must be in the run
(a missing entry fails: a silently skipped gate is a regression too), every
rule's reading must be in its entry, and every exact pin (``eq``: encoded
bytes, clique sizes, the plane count, spill and chaos counters) must hold.
The floors and ceilings (``min``/``max`` with ``rtol``) are the JAX
package's wall-clock readings on a CPU and are not applied to the port.
The baseline is read, never written.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]
BASELINE = ROOT / "benchmarks" / "baseline.json"
BENCH = ROOT / "build" / "repro_torch_bench" / "BENCH.json"


def _lookup(entry, path: str):
    cur = entry
    for part in path.split("."):
        if isinstance(cur, list):
            cur = cur[int(part)]
        elif isinstance(cur, dict):
            cur = cur[part]
        else:
            raise KeyError(path)
    return cur


def check(baseline: dict, run: dict) -> list:
    """Every violation, as readable strings (empty: green)."""
    problems = []
    ran = run.get("benchmarks", {})
    for name, spec in baseline["benchmarks"].items():
        entry = ran.get(name)
        if entry is None:
            problems.append(f"{name}: missing from the smoke run")
            continue
        for rule in spec["checks"]:
            path = rule["path"]
            try:
                got = _lookup(entry, path)
            except (KeyError, IndexError, ValueError):
                problems.append(f"{name}.{path}: missing from the run")
                continue
            if "eq" in rule and got != rule["eq"]:
                problems.append(f"{name}.{path}: {got!r} != pinned {rule['eq']!r}")
    return problems


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="repro_torch.bench.check_regression")
    ap.add_argument("--baseline", default=str(BASELINE))
    ap.add_argument("--bench", default=str(BENCH))
    args = ap.parse_args(argv)

    baseline = json.loads(Path(args.baseline).read_text())
    try:
        run = json.loads(Path(args.bench).read_text())
    except FileNotFoundError:
        print(f"no smoke run at {args.bench}: run "
              f"`PYTHONPATH=src python -m repro_torch.bench.run --smoke` first",
              file=sys.stderr)
        raise SystemExit(2)
    problems = check(baseline, run)
    n_pins = sum("eq" in r for s in baseline["benchmarks"].values() for r in s["checks"])
    if problems:
        print(f"REGRESSION: {len(problems)} violations of {Path(args.baseline).name}:")
        for p in problems:
            print(f"  - {p}")
        raise SystemExit(1)
    print(f"bench-smoke within baseline ({n_pins} exact pins met, "
          f"{len(baseline['benchmarks'])} benchmarks present; floors and ceilings not applied)")


if __name__ == "__main__":
    main()
