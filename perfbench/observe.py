"""What a driver reads of the program from outside it, shared by the drivers.

* :class:`Hooks` wraps the program's superstep and the configuration's
  expansion-kernel entry (``installed``) before the plane is built.  Armed
  for the window's chunk ``TRACE_CHUNK``, the wrappers count its supersteps
  and launches and copy the sampled ones (inputs and outputs) for the
  check; they change nothing.
* :class:`Profile` is the ``torch.profiler`` sub-window of a traced run,
  the same chunk; the time the profiler spends on its own processing is no
  part of the window.
* :func:`answer` is the anytime answer of one lane, through the program's
  own extraction.
"""

from __future__ import annotations

import contextlib
import importlib
import time
import warnings

import numpy as np
import torch

from perfbench import devtrace, instances

TRACE_CHUNK = 1  # the window's chunk that is profiled and sampled (0 is its first)
SAMPLE_LAUNCHES = 2  # expansion launches of that chunk that the check compares


class Hooks:
    """Counts the program's supersteps and expansion launches in the chunk
    it is armed for, and copies the sampled ones."""

    def __init__(self, seed: int, cfg):
        draws = instances.rng(seed, 1)
        span = cfg.chunk_rounds * cfg.steps_per_round
        self.launch_offsets = {int(x) for x in draws.choice(
            span, size=SAMPLE_LAUNCHES, replace=False)}
        self.superstep_offset = int(draws.integers(cfg.chunk_rounds))
        self.lane_rng = instances.rng(seed, 2)
        self.armed = False
        self.launch = 0
        self.superstep = 0
        self.launches = {}
        self.step_capture = None
        self.lane_tickets = []  # the ticket in each lane during this chunk

    def wrap_kernel(self, kernel):
        def hooked(adj, masks, sols, inst=None):
            out = kernel(adj, masks, sols, inst)
            if self.armed:
                if self.launch in self.launch_offsets:
                    self.launches[self.launch] = {
                        "B": adj.shape[0] if adj.dim() == 3 else 1,
                        "n": adj.shape[-2], "W": adj.shape[-1],
                        "masks": masks.clone(), "sols": sols.clone(),
                        "tickets": list(self.lane_tickets),
                        "out": {k: v.clone() for k, v in out._asdict().items() if v is not None},
                    }
                self.launch += 1
            return out

        return hooked

    def wrap_superstep(self, step):
        def hooked(problem, data, state, **kw):
            cap = self.armed and self.superstep == self.superstep_offset
            if cap:
                B = data.adj.shape[0]
                P = state.best_sol.shape[0] // B
                pending = state.frontier.active.view(B, P, -1).any(-1).any(-1).cpu().numpy()
                occupied = np.array([t is not None for t in self.lane_tickets])
                live = np.flatnonzero(pending & occupied)
                lane = int(self.lane_rng.choice(live)) if live.size else None
                before = leaves(state, lane, P) if lane is not None else None
                rounds_in = state.rounds.clone()
                nodes_in = state.nodes_expanded.clone()
            new, done = step(problem, data, state, **kw)
            if cap:
                self.step_capture = {
                    "B": B, "P": P, "lane": lane, "live_lanes": live,
                    "before": before,
                    "after": leaves(new, lane, P) if lane is not None else None,
                    "done": bool(done[lane]) if lane is not None else None,
                    "rounds": (rounds_in, new.rounds.clone()),
                    "nodes": (nodes_in, new.nodes_expanded.clone()),
                    "ticket": self.lane_tickets[lane] if lane is not None else None,
                }
            if self.armed:
                self.superstep += 1
            return new, done

        return hooked

    def obs(self) -> dict:
        return {"launches": self.launches, "launches_planned": len(self.launch_offsets),
                "superstep": self.step_capture, "armed_launches": self.launch}


@contextlib.contextmanager
def installed(config: dict, hooks: Hooks):
    """The hooks wrapped around the program's superstep and kernel entry,
    and taken off again."""
    from repro_torch.core import superstep

    module, name = config["kernel_entry"].split(":")
    kmod = importlib.import_module(module)
    kernel, step = getattr(kmod, name), superstep.superstep
    setattr(kmod, name, hooks.wrap_kernel(kernel))
    superstep.superstep = hooks.wrap_superstep(step)
    try:
        yield
    finally:
        setattr(kmod, name, kernel)
        superstep.superstep = step


def leaves(state, lane: int, P: int) -> dict:
    rows = slice(lane * P, (lane + 1) * P)
    out = {f"frontier.{k}": v[rows].clone() for k, v in state.frontier._asdict().items()}
    out.update({k: v[rows].clone() for k, v in state._asdict().items() if k != "frontier"})
    return out


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def knobs(cfg) -> dict:
    return {
        "steps_per_round": cfg.steps_per_round, "lanes": cfg.lanes, "policy": cfg.policy,
        "packed_status": cfg.packed_status, "skip_empty_transfer": cfg.skip_empty_transfer,
        "transfer_impl": cfg.transfer_impl, "donate_k": cfg.donate_k,
        "num_workers": cfg.num_workers,
    }


class Profile:
    """The profiled sub-window: ``start`` before chunk ``TRACE_CHUNK``,
    ``stop`` after it; ``paused`` is the profiler's own start-up and
    processing, no part of the run's window."""

    def __init__(self, dev):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.dev, self.prof, self.paused = dev, torch.profiler.profile(activities=acts), 0.0

    def start(self) -> None:
        sync(self.dev)
        t = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # one profiling cycle: nothing to keep across
            self.prof.start()
        self.t0 = time.perf_counter()
        self.paused += self.t0 - t

    def stop(self) -> None:
        sync(self.dev)
        self.t1 = time.perf_counter()
        self.prof.stop()
        self.paused += time.perf_counter() - self.t1

    def summary(self) -> dict:
        out = devtrace.summarize(devtrace.read_events(self.prof))
        out["window_s"] = self.t1 - self.t0
        return out


def answer(engine, host: dict, lane: int, spec, g, rounds: int, cfg, k=None) -> dict:
    """The anytime answer of a lane still solving, by the program's own
    result extraction."""
    r = engine._extract_result(host, lane, spec, g, rounds, 0.0, mode=cfg.mode, k=k,
                               num_workers=cfg.num_workers, packed_status=cfg.packed_status)
    return {"size": r.best_size,
            "words": None if r.best_sol is None else np.asarray(r.best_sol, np.uint32),
            "exact": False, "found": r.best_sol is not None, "retired": False}


def peak_bytes(dev) -> int:
    return int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
