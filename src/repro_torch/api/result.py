"""The result schema of the port's backends.

The port of ``repro/api/result.py``'s ``SolveStats``/``SolveResult``,
``ServiceStats``, ``LaneStats``/``BatchSolveResult`` and their converters,
holding the counters the ported backends write.  The JAX package's
deprecated dict-style access to ``stats`` is not carried over: read
attributes (``r.stats.overflow_count``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class ServiceStats:
    """The service envelope around one completed ticket (the spmd service
    only): which lane and plane solved it, its queue wait and lane
    residency (wall seconds on the service's clock), and whether its
    superstep (``deadline_hit``) or wall-clock (``wall_deadline_hit``)
    deadline evicted it with an anytime result, plus its slice of the
    self-healing ledger: the faults injected into and recovered on its
    lanes, the times it was quarantined and re-queued, and the spill
    deliveries its last lane's spiller retried (``retries``)."""

    lane: int = -1
    plane: str = ""
    wait_s: float = 0.0
    residency_s: float = 0.0
    deadline_hit: bool = False
    wall_deadline_hit: bool = False
    faults_injected: int = 0
    faults_recovered: int = 0
    lanes_quarantined: int = 0
    retries: int = 0

    @classmethod
    def from_dict(cls, d: dict) -> "ServiceStats":
        return cls(**{f.name: d[f.name] for f in dataclasses.fields(cls) if f.name in d})


@dataclasses.dataclass
class SolveStats:
    """Backend-specific counters; fields a backend does not track stay 0."""

    # -- spmd engine (collective-traffic accounting) --------------------------
    overflow: bool = False
    overflow_count: int = 0
    control_bytes_per_round: int = 0
    transfer_rounds: int = 0
    transfer_bytes_total: int = 0
    transfer_bytes_per_round: float = 0.0
    # -- durability (spmd checkpoint/resume) ----------------------------------
    checkpoints_written: int = 0
    resumed_from: Optional[str] = None
    # -- hierarchical frontier memory (spmd, cfg.frontier_spill) --------------
    # tasks evicted to / re-admitted from the host cold tier and its peak
    # encoded size; with spill on, overflow_count stays 0 by construction
    spilled_tasks: int = 0
    readmitted_tasks: int = 0
    cold_bytes_peak: int = 0
    # reduction sweeps: the sum over explore rounds of the largest per-lane
    # trip count of the reduction loop (the JAX package's vmapped
    # while_loop runs that many).  Solo solves only: a batch's rounds serve
    # all its instances and are counted in LaneStats.reduce_sweeps
    reduce_sweeps: int = 0
    # -- sequential reference -------------------------------------------------
    pruned: int = 0
    solutions: int = 0
    max_depth: int = 0
    # -- service envelope (None outside SolveService) -------------------------
    service: Optional[ServiceStats] = None

    @classmethod
    def from_dict(cls, d: dict) -> "SolveStats":
        """From either package's ``to_dict``: fields the port does not
        carry (the JAX package's simulator counters) are ignored."""
        known = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in known and k != "service"}
        service = d.get("service")
        if service is not None:
            kw["service"] = ServiceStats.from_dict(service)
        return cls(**kw)


@dataclasses.dataclass
class LaneStats:
    """Batched-plane occupancy: ``chunk_calls`` (chunk dispatches),
    ``lane_chunks`` (chunk_calls × plane width — paid lane slots),
    ``live_lane_chunks`` (slots that held an unfinished instance) and their
    ratio ``occupancy``.  ``reduce_sweeps`` (the port's own) sums, over the
    batch's explore rounds, the largest per-lane trip count of the
    reduction loop."""

    chunk_calls: int = 0
    lane_chunks: int = 0
    live_lane_chunks: int = 0
    occupancy: float = 0.0
    reduce_sweeps: int = 0


@dataclasses.dataclass
class SolveResult:
    """One instance solved by one backend.

    ``best_size`` is in the problem's EXTERNAL objective (``-1`` for an
    unsatisfiable FPT decision); ``rounds`` counts supersteps for spmd and
    expanded nodes for sequential."""

    problem: str
    backend: str
    best_size: int
    best_sol: Optional[np.ndarray]
    found: bool
    wall_s: float
    rounds: int
    nodes_expanded: int
    tasks_transferred: int
    stats: SolveStats = dataclasses.field(default_factory=SolveStats)

    def to_dict(self) -> dict:
        """JSON-safe view (``best_sol`` as a list of packed u32 words)."""
        d = dataclasses.asdict(self)
        if self.best_sol is not None:
            d["best_sol"] = [int(w) for w in np.asarray(self.best_sol, np.uint32)]
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "SolveResult":
        """Inverse of :meth:`to_dict` (the service checkpoint round trip);
        takes the JAX package's ``to_dict`` too."""
        sol = d.get("best_sol")
        return cls(
            problem=d["problem"],
            backend=d["backend"],
            best_size=d["best_size"],
            best_sol=None if sol is None else np.asarray(sol, np.uint32),
            found=d["found"],
            wall_s=d["wall_s"],
            rounds=d["rounds"],
            nodes_expanded=d["nodes_expanded"],
            tasks_transferred=d["tasks_transferred"],
            stats=SolveStats.from_dict(d.get("stats") or {}),
        )


@dataclasses.dataclass
class BatchSolveResult:
    """Per-instance results of one batched solve; ``results[i]`` corresponds
    to ``graphs[i]`` (submission order survives bucketing and compaction).

    ``buckets`` is the packing record — one ``(W, n_max, [indices])`` triple
    per bucket (empty for backends that solve instance by instance);
    ``compactions`` counts host-side batch compactions; ``lane_stats`` is
    the :class:`LaneStats` occupancy record."""

    problem: str
    backend: str
    results: list
    wall_s: float
    buckets: list = dataclasses.field(default_factory=list)
    compactions: int = 0
    lane_stats: LaneStats = dataclasses.field(default_factory=LaneStats)

    def __len__(self) -> int:
        return len(self.results)

    def __iter__(self):
        return iter(self.results)


def from_engine_result(r, *, problem: str, backend: str = "spmd") -> SolveResult:
    """Wrap a :class:`repro_torch.core.engine.EngineResult`."""
    return SolveResult(
        problem=problem,
        backend=backend,
        best_size=r.best_size,
        best_sol=r.best_sol,
        found=r.best_sol is not None,
        wall_s=r.wall_s,
        rounds=r.rounds,
        nodes_expanded=r.nodes_expanded,
        tasks_transferred=r.tasks_transferred,
        stats=SolveStats(
            overflow=r.overflow,
            overflow_count=r.overflow_count,
            control_bytes_per_round=r.control_bytes_per_round,
            transfer_rounds=r.transfer_rounds,
            transfer_bytes_total=r.transfer_bytes_total,
            transfer_bytes_per_round=r.transfer_bytes_per_round,
            checkpoints_written=r.checkpoints_written,
            resumed_from=r.resumed_from,
            spilled_tasks=r.spilled_tasks,
            readmitted_tasks=r.readmitted_tasks,
            cold_bytes_peak=r.cold_bytes_peak,
            reduce_sweeps=r.reduce_sweeps,
        ),
    )


def from_sequential(best, sol, stats, *, problem: str, wall_s: float) -> SolveResult:
    """Wrap the sequential reference's ``(best, sol, SeqStats)`` triple."""
    return SolveResult(
        problem=problem,
        backend="sequential",
        best_size=best,
        best_sol=sol,
        found=sol is not None,
        wall_s=wall_s,
        rounds=stats.nodes,
        nodes_expanded=stats.nodes,
        tasks_transferred=0,
        stats=SolveStats(
            pruned=stats.pruned,
            solutions=stats.solutions,
            max_depth=stats.max_depth,
        ),
    )
