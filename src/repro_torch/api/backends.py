"""The port's backends: the spmd solve plane and the sequential reference.

The port of ``repro/api/backends.py``'s solo ``solve_spmd`` and its
``Backend`` registry.  The spmd driver is the JAX package's loop: startup
scatter, then chunks of up to ``chunk_rounds`` supersteps until quiescence
(or the FPT bound) or ``max_rounds``, then one host fetch.

Features of the JAX driver that the port does not carry yet are refused
with ``NotImplementedError`` naming their ROADMAP item; none is silently
ignored.
"""

from __future__ import annotations

import time

from repro_torch.api.config import SolveConfig
from repro_torch.api.result import SolveResult, from_engine_result, from_sequential
from repro_torch.core import engine as _engine
from repro_torch.core.encoding import make_codec
from repro_torch.core.superstep import build_plane_fn, state_to
from repro_torch.graphs.bitgraph import n_words
from repro_torch.problems import base as problems_base
from repro_torch.problems.base import WorkCounters

# config knobs / arguments the port refuses, with the ROADMAP item that ports them
_NOT_PORTED = {
    "checkpoint_dir": "queue 1, item 9 (checkpoint/resume)",
    "resume_from": "queue 1, item 9 (checkpoint/resume)",
    "frontier_spill": "queue 1, item 10 (codecs + frontier spill)",
    "use_mesh": "queue 1, item 13 (multi-device path)",
    "mesh": "queue 1, item 13 (multi-device path)",
    "injector": "queue 1, item 11 (fault wiring)",
}


def _refuse(what: str) -> None:
    raise NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP {_NOT_PORTED[what]})"
    )


def solve_spmd(
    spec,
    g,
    cfg: SolveConfig,
    *,
    device,
    initial_state=None,
    mesh=None,
    injector=None,
):
    """One instance on the solve plane, on ``device``; returns an
    :class:`~repro_torch.core.engine.EngineResult`.

    ``initial_state`` (a :class:`~repro_torch.core.superstep.WorkerState`,
    e.g. from ``worker_state_from_flat``) starts the loop from that state
    instead of the startup scatter, with ``rounds`` counted from 0."""
    for name in ("checkpoint_dir", "resume_from"):
        if getattr(cfg, name) is not None:
            _refuse(name)
    for name in ("frontier_spill", "use_mesh"):
        if getattr(cfg, name):
            _refuse(name)
    if mesh is not None:
        _refuse("mesh")
    if injector is not None:
        _refuse("injector")

    k = cfg.solo_k()
    W = n_words(g.n)
    cap = cfg.capacity or (4 * g.n + 8 * cfg.lanes)
    initial_best = problems_base.initial_bound(spec, g, cfg.mode, k)
    pad = make_codec(cfg.codec, g.n, problem=spec).pad_words
    counters = WorkCounters()
    use_fpt = cfg.mode == "fpt"
    plane = build_plane_fn(
        spec,
        steps_per_round=cfg.steps_per_round,
        lanes=cfg.lanes,
        policy_priority=cfg.policy_priority,
        transfer_pad_words=pad,
        packed_status=cfg.packed_status,
        skip_empty_transfer=cfg.skip_empty_transfer,
        transfer_impl=cfg.transfer_impl,
        donate_k=cfg.donate_k,
        explore_impl=cfg.explore_impl,
        chunk_rounds=cfg.chunk_rounds,
        use_fpt=use_fpt,
        counters=counters,
    )
    fpt_bound = int(spec.fpt_target(k)) if use_fpt else None

    data = problems_base.make_data(spec, g, device)
    if initial_state is None:
        state = _engine.make_instance_state(
            spec, g, cfg.num_workers, cap, W, initial_best, device
        )
    else:
        state = state_to(initial_state, device)

    t0 = time.perf_counter()
    rounds = 0
    while rounds < cfg.max_rounds:
        state, done, ran, _ = plane(data, state, fpt_bound)
        rounds += ran
        if done:
            break
    host = _engine._fetch_state(state)
    wall = time.perf_counter() - t0

    r = _engine._extract_result(
        host,
        spec,
        g,
        rounds,
        wall,
        mode=cfg.mode,
        k=k,
        num_workers=cfg.num_workers,
        packed_status=cfg.packed_status,
    )
    r.reduce_sweeps = counters.reduce_sweeps
    return r


# -- the Backend protocol ------------------------------------------------------


class Backend:
    """One engine behind the session façade: ``solve`` takes the resolved
    problem spec, the validated config and the device, and returns a
    :class:`SolveResult`."""

    name: str = "?"

    def solve(self, spec, g, cfg: SolveConfig, *, device) -> SolveResult:
        raise NotImplementedError


class SpmdBackend(Backend):
    name = "spmd"

    def solve(self, spec, g, cfg, *, device, initial_state=None, mesh=None,
              injector=None):
        r = solve_spmd(spec, g, cfg, device=device, initial_state=initial_state,
                       mesh=mesh, injector=injector)
        return from_engine_result(r, problem=spec.name, backend=self.name)


class SequentialBackend(Backend):
    """The problem's host reference solver (numpy; ``device`` is unused)."""

    name = "sequential"

    def solve(self, spec, g, cfg, *, device):
        if spec.sequential is None:
            raise ValueError(f"problem {spec.name!r} has no sequential reference")
        t0 = time.perf_counter()
        best, sol, stats = spec.sequential(g, mode=cfg.mode, k=cfg.solo_k())
        wall = time.perf_counter() - t0
        return from_sequential(best, sol, stats, problem=spec.name, wall_s=wall)


BACKENDS = {b.name: b for b in (SpmdBackend(), SequentialBackend())}

BACKEND_ALIASES = {"seq": "sequential"}

# backends of the JAX package that the port does not carry yet
NOT_PORTED_BACKENDS = ("protocol_sim", "protocol", "centralized", "central", "centralised")


def known_backends() -> list:
    return sorted(BACKENDS)


def get_backend(name) -> Backend:
    """Resolve a backend by name (or pass an instance through)."""
    if isinstance(name, Backend):
        return name
    if name in NOT_PORTED_BACKENDS:
        raise ValueError(
            f"backend {name!r} is not ported to repro_torch yet (ROADMAP "
            f"queue 1, item 12: host backends); known backends: "
            f"{', '.join(known_backends())}"
        )
    key = BACKEND_ALIASES.get(name, name)
    if key not in BACKENDS:
        raise ValueError(
            f"unknown backend {name!r}; known backends: "
            f"{', '.join(known_backends())} "
            f"(aliases: {', '.join(sorted(BACKEND_ALIASES))})"
        )
    return BACKENDS[key]
