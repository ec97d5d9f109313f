"""``SolverSession``: the port's public way to solve branching problems.

The port of ``repro/api/session.py``'s constructor, ``solve``,
``solve_many`` (both durable: ``checkpoint_dir``/``resume_from``),
``resume`` and ``cache_stats``.  A session binds (problem, backend,
config, device) once and owns a :class:`~repro_torch.api.cache.PlaneCache`
(or shares one passed in).  The device is the card unless the caller asks
for another: ``device=None`` means ``"cuda"``, and a session on CUDA raises
``RuntimeError`` when CUDA is absent instead of running on the CPU.  The CPU
path (``device="cpu"``) runs the kernels' plain versions; the tests use it.

Asynchronous admission: ``submit(g) -> ticket`` queues into the serving
:class:`~repro_torch.serving.balancer.SolveBatcher`, ``poll()`` solves every
full ``batch_size`` plane and ``flush()`` the rest, and ``result(ticket)``
pops a solved ticket.  ``serve()`` returns the continuous-batching
:class:`~repro_torch.api.service.SolveService` on the session's device and
cache; :func:`solve_stream_session` drives a whole stream through one
service per problem.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.api.backends import Backend, get_backend
from repro_torch.api.cache import PlaneCache
from repro_torch.api.config import SolveConfig
from repro_torch.api.result import BatchSolveResult, SolveResult
from repro_torch.checkpoint.solve import CheckpointError, SolveCheckpoint
from repro_torch.problems.registry import DEFAULT_PROBLEM, get_problem


def resolve_device(device=None) -> torch.device:
    """``None`` -> the card; a CUDA device without CUDA raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and CUDA is not "
            "available here; pass device='cpu' to run the plain torch path "
            "on the CPU"
        )
    return dev


class SolverSession:
    """One façade over the port's backends.

    >>> session = SolverSession(problem="max_clique",
    ...                         config=SolveConfig(num_workers=128))
    >>> session.solve(g).best_size
    >>> session.solve_many(graphs).results
    >>> t = session.submit(g); session.flush(); session.result(t)

    ``problem`` is a registry name or spec; ``backend`` is ``spmd``,
    ``protocol_sim``, ``centralized`` or ``sequential`` (the last three run
    on the host, but the session still resolves its device).  Keyword
    overrides are applied on top of ``config``:
    ``SolverSession(num_workers=4, device="cpu")``.
    """

    def __init__(
        self,
        problem=DEFAULT_PROBLEM,
        backend="spmd",
        config: Optional[SolveConfig] = None,
        *,
        device=None,
        cache: Optional[PlaneCache] = None,
        **overrides,
    ):
        self.device = resolve_device(device)
        self.problem = get_problem(problem)
        self.backend: Backend = get_backend(backend)
        cfg = config if config is not None else SolveConfig()
        if overrides:
            cfg = cfg.replace(**overrides)
        self.config = cfg
        self.cache = cache if cache is not None else PlaneCache()
        self._batcher = None  # lazy serving.balancer.SolveBatcher
        self._results: dict = {}  # ticket -> SolveResult

    def solve(
        self,
        g,
        *,
        checkpoint_dir: Optional[str] = None,
        resume_from: Optional[str] = None,
        **backend_kw,
    ) -> SolveResult:
        """Solve one instance; ``backend_kw`` passes backend-specific extras
        (spmd: ``initial_state``, and ``injector``, a
        :class:`~repro_torch.faults.FaultInjector` whose faults the solve
        heals).

        ``checkpoint_dir``/``resume_from`` override the config's durability
        knobs for THIS call (spmd): a
        :class:`~repro_torch.checkpoint.solve.SolveCheckpoint` every
        ``config.checkpoint_every`` chunks, and a fingerprint-checked
        restore-and-continue."""
        return self.backend.solve(
            self.problem, g, self._call_config(checkpoint_dir, resume_from),
            self.cache, device=self.device, **backend_kw,
        )

    def solve_many(
        self,
        graphs,
        *,
        checkpoint_dir: Optional[str] = None,
        resume_from: Optional[str] = None,
        **backend_kw,
    ) -> BatchSolveResult:
        """Solve B instances: on one batched plane per W bucket (spmd) or
        one after another (sequential); the durability knobs as in
        :meth:`solve`, and ``backend_kw`` too (spmd: ``injector``)."""
        return self.backend.solve_many(
            self.problem, list(graphs),
            self._call_config(checkpoint_dir, resume_from), self.cache,
            device=self.device, **backend_kw,
        )

    def _call_config(self, checkpoint_dir, resume_from) -> SolveConfig:
        overrides = {
            k: v
            for k, v in (
                ("checkpoint_dir", checkpoint_dir),
                ("resume_from", resume_from),
            )
            if v is not None
        }
        return self.config.replace(**overrides) if overrides else self.config

    @classmethod
    def resume(
        cls,
        path: str,
        *,
        backend="spmd",
        cache: Optional[PlaneCache] = None,
        device=None,
        **config_overrides,
    ) -> "SolveResult | BatchSolveResult":
        """Resume a checkpointed solve to completion on ``device`` (None:
        the card) and return its result.

        ``path`` is a checkpoint directory (latest intact step) or one
        ``.../step_<N>`` subdir, written by this package or the JAX one.
        The session is rebuilt FROM the checkpoint (problem, config and
        instance graphs are stored in it), then the solve continues from
        the saved state to the result of the uninterrupted run (modulo
        wall clock).  ``config_overrides`` may adjust post-trajectory knobs
        (``max_rounds``, ``checkpoint_dir``, ...); changing a trajectory
        knob is refused by the fingerprint check.

        Service checkpoints restore through
        :meth:`repro_torch.api.SolveService.restore` (they hold live lanes
        and a queue, not one result)."""
        ck = SolveCheckpoint.load_latest_good(path, what="session")
        if ck.kind == "service":
            raise CheckpointError(
                f"{path} holds a service checkpoint; use "
                f"SolveService.restore(path)"
            )
        cfg = SolveConfig.from_dict(ck.config).replace(
            resume_from=path, **config_overrides
        )
        session = cls(problem=ck.problem, backend=backend, config=cfg,
                      cache=cache, device=device)
        if ck.kind == "solo":
            return session.solve(ck.unpack_graph(0))
        return session.solve_many(ck.unpack_graphs())

    # -- asynchronous admission (the serving front) ----------------------------

    def submit(self, g) -> int:
        """Queue one instance for batched solving; returns its ticket.

        Tickets solve when a full ``config.batch_size`` plane accumulates
        (``poll``) or on ``flush()``; results are kept until ``result`` is
        called (which pops them).
        """
        if self._batcher is None:
            from repro_torch.serving.balancer import SolveBatcher

            self._batcher = SolveBatcher(self.config.batch_size)
        return self._batcher.submit(g, self.problem.name)

    def poll(self) -> list:
        """Solve every currently FULL batch; returns the tickets solved."""
        if self._batcher is None:
            return []
        return self._run_batches(self._batcher.ready_batches())

    def flush(self) -> list:
        """Solve everything still queued (full and partial batches);
        returns the tickets solved."""
        if self._batcher is None:
            return []
        return self._run_batches(self._batcher.flush())

    def result(self, ticket: int) -> SolveResult:
        """Pop a solved ticket's result (KeyError if unknown or unsolved:
        call ``poll``/``flush`` first)."""
        return self._results.pop(ticket)

    def pending(self) -> int:
        """Tickets submitted but not yet solved."""
        if self._batcher is None:
            return 0
        return len(self._batcher.graphs)

    def _run_batches(self, batches) -> list:
        solved = []
        for tickets in batches:
            gs = self._batcher.take(tickets)
            batch = self.solve_many(gs)
            for t, r in zip(tickets, batch.results):
                self._results[t] = r
            solved.extend(tickets)
        return solved

    # -- the continuous-batching service ---------------------------------------

    def serve(self, *, injector=None, **config_overrides):
        """A :class:`~repro_torch.api.service.SolveService` over this
        session's (problem, config, cache, device): a live plane whose freed
        lanes re-admit queued instances continuously, instead of the fixed
        ``batch_size`` planes behind ``submit``/``poll``/``flush``.

        >>> svc = session.serve(service_lanes=8)
        >>> t = svc.submit(g); svc.drain(); svc.result(t)

        spmd backend only; ``injector`` (a
        :class:`~repro_torch.faults.FaultInjector`) fires its plan at the
        service's chunk boundaries, and the service heals it.
        """
        from repro_torch.api.service import SolveService

        if self.backend.name != "spmd":
            raise ValueError(
                f"serve() needs the spmd backend (live batched plane); "
                f"this session uses {self.backend.name!r}"
            )
        cfg = self.config
        if config_overrides:
            cfg = cfg.replace(**config_overrides)
        return SolveService(
            self.problem, cfg, cache=self.cache, injector=injector,
            device=self.device,
        )

    def cache_stats(self) -> dict:
        """Plane-cache accounting (see :class:`~repro_torch.api.cache.CacheStats`)."""
        return self.cache.stats().to_dict()


def solve_stream_session(
    graphs,
    batch_size: int,
    *,
    problem=DEFAULT_PROBLEM,
    config: Optional[SolveConfig] = None,
    cache: Optional[PlaneCache] = None,
    backend="spmd",
    device=None,
) -> list:
    """Session-backed stream solver: one continuous
    :class:`~repro_torch.api.service.SolveService` per problem in the
    stream, ALL sharing one :class:`PlaneCache`, on ``device`` (None: the
    card).  A lane freed by an easy instance re-admits the next queued one
    mid-flight instead of idling until its whole batch drains.
    ``batch_size`` becomes the service's lane count.  Returns per-instance
    :class:`SolveResult` in submission order.

    Non-spmd backends have no live batched plane; they fall back to the
    fixed-batch ``submit``/``flush`` path with identical results.

    This is what :func:`repro_torch.serving.balancer.solve_stream` drives
    when no explicit solver is injected.
    """
    graphs = list(graphs)
    probs = [problem] * len(graphs) if isinstance(problem, str) else list(problem)
    if len(probs) != len(graphs):
        raise ValueError("need one problem, or one per instance")
    cache = cache if cache is not None else PlaneCache()
    cfg = config if config is not None else SolveConfig()
    if get_backend(backend).name != "spmd":
        sessions: dict = {}
        tickets = []
        for g, p in zip(graphs, probs):
            name = get_problem(p).name
            if name not in sessions:
                sessions[name] = SolverSession(
                    problem=name,
                    backend=backend,
                    config=cfg.replace(batch_size=batch_size),
                    cache=cache,
                    device=device,
                )
            tickets.append((name, sessions[name].submit(g)))
        for s in sessions.values():
            s.flush()
        return [sessions[name].result(t) for name, t in tickets]

    from repro_torch.api.service import SolveService

    services: dict = {}
    tickets = []
    for g, p in zip(graphs, probs):
        name = get_problem(p).name
        if name not in services:
            services[name] = SolveService(
                name, cfg.replace(service_lanes=batch_size), cache=cache,
                device=device,
            )
        tickets.append((name, services[name].submit(g)))
    for svc in services.values():
        svc.drain()
    return [services[name].result(t) for name, t in tickets]
