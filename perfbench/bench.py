"""One run of one cell: load it by name, drive it, judge it, print it.

The cell's entry of ``BENCHMARK.json`` names its configuration and its
traffic; ``configs/<config>.json`` holds the deployment (what it solves,
its graphs and sizes, engine settings, the guarantees, the program's
kernel entry, and the judge of its answers) and ``traffic/<traffic>.json``
the mix and the entry that drives it (``drivers/<entry>.py``, whose
``run`` returns what the window produced and observed).  ``correct`` is
decided by ``judges/<judge>.py``, whose ``judge`` compares that against
the plain reference and returns each number with its limit.  Each metric
is read by ``metrics/<name>.py``, whose ``read(obs)`` returns a number or
None where it finds nothing to read.  Every file is found under the root
of the checkout it is given.
"""

from __future__ import annotations

import importlib.util
import json
import sys
import time
from pathlib import Path

import torch

from perfbench import devtrace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(workload: str, root: Path = ROOT) -> tuple:
    """(workload entry, configuration, traffic, end-to-end metrics,
    per-layer metrics) of a cell, all found by name."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    wl = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if wl is None:
        raise SystemExit(f"perfbench: no workload {workload!r} in BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == wl["config"])
    config = json.loads((root / entry["file"]).read_text())
    traffic = json.loads((root / "perfbench" / "traffic" / f"{wl['traffic']}.json").read_text())

    def applies(m):
        return "workloads" not in m or workload in m["workloads"]

    return (wl, config, traffic, [m for m in bench["end_to_end"] if applies(m)],
            [m for m in bench["per_layer"] if applies(m)])


def find(root: Path, kind: str, name: str):
    """The module ``perfbench/<kind>/<name>.py`` of the checkout at ``root``."""
    return load_module(root / "perfbench" / kind / f"{name}.py")


def read_metrics(metrics: list, obs: dict, root: Path) -> dict:
    out = {}
    for m in metrics:
        value = find(root, "metrics", m["name"]).read(obs)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def forbidden_modules() -> list:
    """Modules of JAX or of the JAX package loaded in this process, by
    whole top-level name (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def result_line(*, correct, attempted, failed, metrics, device, checks, breakdown=None) -> str:
    line = {"correct": correct, "attempted": attempted, "failed": failed,
            "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return json.dumps(line)


def run(workload: str, seed: int, seconds: float, trace: bool, t_start: float,
        root: Path = ROOT) -> tuple:
    """Run a cell on the card and return (result line, checks)."""
    wl, config, traffic, e2e, per_layer = load_cell(workload, root)
    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        raise SystemExit(
            f"perfbench: {workload} needs {wl['chips']} CUDA device(s); "
            f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    dev = torch.device("cuda", 0)
    return run_on(config, traffic, e2e, per_layer, chips=wl["chips"], seed=seed,
                  seconds=seconds, trace=trace, t_start=t_start, device=dev, root=root)


def run_on(config, traffic, e2e, per_layer, *, chips, seed, seconds, trace, t_start,
           device, root: Path = ROOT) -> tuple:
    """Drive, judge and read a cell on ``device`` (the tests' CPU too)."""
    obs = find(root, "drivers", traffic["entry"]).run(
        config, traffic, seed=seed, seconds=seconds, trace=trace, device=device,
        t_start=t_start)
    t = time.perf_counter()
    checks, attempted, failed = find(root, "judges", config["judge"]).judge(
        config, obs, device, root)
    print(f"perfbench: set-up {obs['setup_s']:.3f} s, window {obs['window_s']:.3f} s, "
          f"{attempted} answers, judged in {time.perf_counter() - t:.3f} s", file=sys.stderr)
    if obs.get("setup_marks"):
        marks = ", ".join(f"{name} {at:.3f}" for name, at in obs["setup_marks"])
        print(f"perfbench: set-up marks (s from start): {marks}", file=sys.stderr)
    metrics = read_metrics(per_layer if trace else e2e, obs, root)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": chips, "memory_peak_bytes": obs["memory_peak_bytes"]}
    brk = None
    if trace and obs["trace"] is not None:
        dev["busy_s"] = obs["trace"]["busy_us"] / 1e6
        dev["window_s"] = obs["trace"]["window_s"]
        brk = devtrace.breakdown(obs["trace"])
    correct = all(v <= lim for v, lim in checks.values())
    line = result_line(correct=correct, attempted=attempted, failed=failed,
                       metrics=metrics, device=dev, checks=checks, breakdown=brk)
    return line, checks


def print_result(line: str, checks: dict) -> int:
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: the run loaded {', '.join(bad)}; no result", file=sys.stderr)
        return 4
    for name, (value, limit) in checks.items():
        print(f"check {name} {value} limit {limit}", file=sys.stderr)
    print(line, flush=True)
    return 0

