"""The control and the planted faults that the correctness check must fail.

    python3 perfbench/control.py --workload <cell> --mode control --seeds 1 2 3 --seconds 51

Runs the cell once a seed, in one process, with one plant in the program
(restored after each run), and prints each run's compared numbers and
``correct``.  No benchmark run plants anything; this is how the upper
readings of the limits were taken on the card, and ``tests/`` drives the
same plants on the CPU at a small size.

* ``sound``: nothing planted (the lower readings).
* ``control``: the configuration's feasibility guarantee broken where the
  answer is produced (``engine._extract_result``): every answer comes back
  one better than what was found, a vertex cover less its first vertex, a
  clique with the first vertex outside it added.
* ``unchanged``: a superstep that returns its state unchanged.
* ``half``: a superstep that leaves out the second half of its rows (of
  the lanes; of one instance's workers).
* ``answer``: an answer altered where it is produced: its size one more.
* ``worse``: every answer one worse than what was found, still feasible: a
  clique less its first vertex, a cover with the first vertex outside it
  added.  Only a configuration whose optimum is checked can catch it.
* ``kernel``: the expansion kernel's output altered: row 0's bound one more.

The fault "the exchange between chips left out" has no place in these
one-chip cells.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib
import json
import sys
import time

import numpy as np

MODES = ("sound", "control", "unchanged", "half", "answer", "kernel", "worse")


@contextlib.contextmanager
def _patched(module, name: str, make):
    old = getattr(module, name)
    setattr(module, name, make(old))
    try:
        yield
    finally:
        setattr(module, name, old)


def _moved_one(problem: str, better: bool):
    """Answers with one vertex more or less, reported one better (or one
    worse) than what was found."""
    drop = (problem == "vertex_cover") == better

    def make(extract):
        def altered(host, lane, spec, g, *a, **kw):
            r = extract(host, lane, spec, g, *a, **kw)
            if r.best_sol is None:
                return r
            words = np.asarray(r.best_sol, np.uint32).copy()
            bits = ((words[:, None] >> np.arange(32, dtype=np.uint32)) & 1).reshape(-1)[: g.n]
            if drop:
                v, size = int(np.flatnonzero(bits)[0]), r.best_size - 1
            else:
                v, size = int(np.flatnonzero(bits == 0)[0]), r.best_size + 1
            words[v // 32] ^= np.uint32(1) << np.uint32(v % 32)
            return dataclasses.replace(r, best_sol=words, best_size=size)

        return altered

    return make


def _answer_off(extract):
    def altered(*a, **kw):
        r = extract(*a, **kw)
        return dataclasses.replace(r, best_size=r.best_size + 1)

    return altered


def _unchanged(step):
    def frozen(problem, data, state, **kw):
        import torch

        return state, torch.zeros((data.adj.shape[0],), dtype=torch.bool,
                                  device=state.best_val.device)

    return frozen


def _half(step):
    def half(problem, data, state, **kw):
        import torch

        new, done = step(problem, data, state, **kw)
        BP = state.best_val.shape[0]
        keep = torch.arange(BP, device=state.best_val.device) < BP - BP // 2

        def pick(a, b):
            return torch.where(keep.view(-1, *([1] * (a.dim() - 1))), a, b)

        from repro_torch.core.superstep import map_state

        return map_state(pick, new, state), done

    return half


def _kernel_off(kernel):
    def altered(*a, **kw):
        out = kernel(*a, **kw)
        out.bound[0] += 1
        return out

    return altered


def plant(mode: str, config: dict):
    """A context manager that plants ``mode`` in the program."""
    if mode == "sound":
        return contextlib.nullcontext()
    from repro_torch.core import engine
    from repro_torch.core import superstep

    if mode == "control":
        return _patched(engine, "_extract_result", _moved_one(config["problem"], True))
    if mode == "worse":
        return _patched(engine, "_extract_result", _moved_one(config["problem"], False))
    if mode == "answer":
        return _patched(engine, "_extract_result", _answer_off)
    if mode == "unchanged":
        return _patched(superstep, "superstep", _unchanged)
    if mode == "half":
        return _patched(superstep, "superstep", _half)
    if mode == "kernel":
        module, name = config["kernel_entry"].split(":")
        return _patched(importlib.import_module(module), name, _kernel_off)
    raise ValueError(f"unknown mode {mode!r}; valid: {', '.join(MODES)}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--mode", choices=MODES, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    from perfbench import bench

    _, config, *_ = bench.load_cell(args.workload)
    for seed in args.seeds:
        with plant(args.mode, config):
            line, checks = bench.run(args.workload, seed, args.seconds, False,
                                     time.perf_counter())
        readings = " ".join(f"{k}={v}" for k, (v, _) in checks.items())
        correct = json.loads(line)["correct"]
        print(f"control {args.workload} mode={args.mode} seed={seed} "
              f"correct={str(correct).lower()} {readings}", flush=True)
    return 0


if __name__ == "__main__":
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    sys.path[:0] = [str(root), str(root / "src")]
    sys.exit(main())
