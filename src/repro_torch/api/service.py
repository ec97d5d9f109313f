"""``SolveService``: the continuous-batching solve front end of the port.

The port of ``repro/api/service.py``.  Instead of admitting B instances,
running the batched plane until all of them finish and returning B results,
the service keeps a *live lane lifecycle*, the branching solver's analogue
of an inference server's continuous batching:

* each ``(problem, plane shape)`` gets ONE long-lived batched plane with
  ``config.service_lanes`` lanes, from the parametric
  :func:`~repro_torch.core.superstep.build_batch_plane_fn` (instance
  tensors are call-time arguments), on the service's device;
* ``submit(g)`` queues a request and returns a ticket; a
  :class:`LaneScheduler` admits queued requests into *vacant* lanes.
  Admission is pure data, written in place
  (:func:`~repro_torch.problems.base.write_instance` and
  :func:`~repro_torch.core.superstep.lane_swap_in` of a
  :func:`~repro_torch.core.engine.make_instance_state`), so admission into
  a freed lane builds no new plane;
* each :meth:`SolveService.step` runs one chunk per live plane, retires
  lanes whose instance finished (streaming the result out while the other
  lanes keep solving) and re-admits into the freed lanes.  The plane is
  never compacted, so a lane index holds for the plane's life.

Finished and vacant lanes are frozen by the plane's per-superstep select,
so every admitted instance's trajectory, branching decisions AND counters,
is bit-identical to its solo ``solve``.  The basic codec's byte accounting
is why basic-codec planes key on exact ``(W, n)``, while the optimized codec
keys on ``W`` alone with a full-width ``n_max = 32·W``.

Scheduling is deterministic: admission order is a pure function of submit
order and completion order (``fifo``), or of the request's ``(priority
desc, deadline asc, submit seq)`` key (``priority``), with an optional
per-tenant cap on occupied lanes.  ``deadline`` is a superstep budget (the
anytime deadline of Avis & Devroye) and ``deadline_s`` its wall-clock twin,
both checked at chunk boundaries: a lane over either budget is evicted with
its best-so-far result and ``r.stats.service.deadline_hit`` /
``.wall_deadline_hit`` set.  Wall time is read from an injectable
``clock``, so deadline behaviour is testable without sleeping.

Durability is the JAX service's: :meth:`SolveService.checkpoint` writes
every live plane's lanes, instance data and FPT bounds, the pending queue,
the finished but unclaimed results and the counters in one atomic
``"service"`` checkpoint (``config.checkpoint_dir`` writes one every
``checkpoint_every`` steps), and :meth:`SolveService.restore` rebuilds a
service from one, written by either package, that finishes every ticket as
the uninterrupted service would.  With ``config.frontier_spill`` each
occupied lane has its own cold tier
(:class:`~repro_torch.core.spill.FrontierSpiller`, created at admission and
dropped at retirement, carried by checkpoints), pumped after every chunk
before the finished verdict, so a lane that went quiescent with a cold
backlog is refilled and resumed instead of retired.

Self-healing is the JAX service's too.  An ``injector``
(:class:`~repro_torch.faults.FaultInjector`) ticks once a chunk, before the
chunk: a crashed lane is quarantined and its request re-queued (it sorts
first and replays from its startup placement, to the undisturbed result),
and a stalled lane is frozen across the chunk (a :func:`lane_slice`
snapshot written back by :func:`lane_write_back`).  The stall watchdog,
with or without an injector, quarantines an occupied, unfinished lane whose
``rounds`` made no progress for ``config.lane_stall_chunks`` chunks; every
2 plane faults shed one admission slot and 8 fault-free chunks heal one,
then rehabilitate one quarantined lane.  The ledger (injected, recovered,
quarantined, retries) rides in each ticket's ``ServiceStats`` and in
``stats()``.  Request timeouts run as in the JAX package.

:class:`AsyncSolveService` wraps a service in an asyncio pump for the
``launch.serve`` front end: ``await svc.solve(g)`` resolves when the
instance's lane retires.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.api.backends import _io_policy, _patch_spill
from repro_torch.api.cache import PlaneCache
from repro_torch.api.config import SolveConfig
from repro_torch.api.result import ServiceStats, SolveResult, from_engine_result
from repro_torch.api.session import resolve_device
from repro_torch.checkpoint import solve as _ckpt
from repro_torch.core import engine as _engine
from repro_torch.core.encoding import make_codec
from repro_torch.core.spill import FrontierSpiller, make_spiller, pump_lanes
from repro_torch.core.superstep import (
    lane_retire,
    lane_slice,
    lane_state_from_flat,
    lane_state_to_flat,
    lane_swap_in,
    lane_write_back,
    make_vacant_lanes,
    step_lanes,
)
from repro_torch.problems import base as problems_base
from repro_torch.problems.base import WorkCounters
from repro_torch.problems.registry import get_problem

# counters of the port's service that the JAX package's has not
PORT_ONLY_STATS = ("supersteps",)


class SolveTimeout(TimeoutError):
    """A request exceeded ``SolveConfig.request_timeout_s`` on the
    service's (injectable) clock.

    Raised by :meth:`SolveService.result` and set as the awaited future's
    exception by :class:`AsyncSolveService`, so ``await svc.solve(g)`` can
    never hang past the budget.  ``result`` carries the partial anytime
    :class:`~repro_torch.api.result.SolveResult` when the request was on a
    lane; ``None`` when it timed out still queued.
    """

    def __init__(self, ticket: int, result=None, waited_s: float = 0.0):
        self.ticket = ticket
        self.result = result
        self.waited_s = waited_s
        where = "on a lane" if result is not None else "still queued"
        super().__init__(
            f"request {ticket} timed out after {waited_s:.3f}s ({where})"
        )


@dataclasses.dataclass
class SolveRequest:
    """One queued instance: the graph plus its scheduling attributes."""

    ticket: int
    g: object
    priority: int = 0
    deadline: Optional[int] = None  # superstep budget (anytime eviction)
    deadline_s: Optional[float] = None  # wall-clock budget since submit
    tenant: Optional[str] = None
    k: Optional[int] = None  # fpt decision target (fpt mode only)
    submit_s: float = 0.0


def _req_meta(req: SolveRequest) -> dict:
    """The scheduling attributes of a request for a checkpoint's meta (the
    graph rides in the checkpoint's arrays, keyed by ticket).  ``submit_s``
    is on the service's own clock, as the JAX package keeps it."""
    return {
        "ticket": req.ticket,
        "priority": req.priority,
        "deadline": req.deadline,
        "deadline_s": req.deadline_s,
        "tenant": req.tenant,
        "k": req.k,
        "submit_s": req.submit_s,
    }


def _req_from_meta(m: dict, graphs: dict) -> SolveRequest:
    return SolveRequest(
        ticket=int(m["ticket"]),
        g=graphs[int(m["ticket"])],
        priority=int(m["priority"]),
        deadline=m["deadline"],
        deadline_s=m.get("deadline_s"),
        tenant=m["tenant"],
        k=m["k"],
        submit_s=float(m["submit_s"]),
    )


class LaneScheduler:
    """Deterministic admission queue over :class:`SolveRequest`.

    ``fifo`` admits in strict submit order; ``priority`` by
    ``(-priority, deadline, seq)`` (unset deadlines sort last).  Admission
    never reads the wall clock, so a replayed submit/completion sequence
    admits identically.  With ``tenant_max_lanes``, callers pass the current
    per-tenant lane occupancy and requests whose tenant is at the cap are
    skipped (they stay queued and later requests may overtake them: that is
    the fairness).
    """

    def __init__(
        self, admission: str = "priority", tenant_max_lanes: Optional[int] = None
    ):
        self.admission = admission
        self.tenant_max_lanes = tenant_max_lanes
        self._queue: list = []

    def __len__(self) -> int:
        return len(self._queue)

    def push(self, req: SolveRequest) -> None:
        self._queue.append(req)

    def ordered(self) -> list:
        """The queue in admission order (a copy; callers iterate and
        :meth:`remove` what they admit)."""
        if self.admission == "fifo":
            return sorted(self._queue, key=lambda r: r.ticket)
        big = float("inf")
        return sorted(
            self._queue,
            key=lambda r: (
                -r.priority,
                r.deadline if r.deadline is not None else big,
                r.ticket,
            ),
        )

    def remove(self, req: SolveRequest) -> None:
        self._queue.remove(req)

    def tenant_blocked(self, req: SolveRequest, tenant_occupied: dict) -> bool:
        if self.tenant_max_lanes is None or req.tenant is None:
            return False
        return tenant_occupied.get(req.tenant, 0) >= self.tenant_max_lanes


class _LivePlane:
    """One long-lived batched plane: ``service_lanes`` lanes over a fixed
    ``(n_max, W, capacity)`` packing on ``device``, plus the host
    bookkeeping (which ticket occupies which lane, when it was admitted)."""

    def __init__(self, spec, cfg: SolveConfig, cache: PlaneCache, key: tuple,
                 device):
        W, n_exact = key
        self.key = key
        self.W = W
        # optimized codec: full-width pad (any n <= 32·W admits; padding rows
        # are isolated never-in-mask vertices); basic codec: exact n (its
        # payload pad is n·W words, so the byte accounting must see the solo n)
        self.n_max = n_exact if n_exact is not None else problems_base.WORD_BITS * W
        self.cap = cfg.capacity or (4 * self.n_max + 8 * cfg.lanes)
        self.pad = make_codec(cfg.codec, self.n_max, problem=spec).pad_words
        self.use_fpt = cfg.mode == "fpt"
        B = cfg.service_lanes
        self.lanes = make_vacant_lanes(B, cfg.num_workers, self.cap, W, device)
        self.datas = problems_base.make_blank_batch_data(B, self.n_max, W, device)
        self.fpt_bounds = None
        if self.use_fpt:
            self.fpt_bounds = torch.zeros((B,), dtype=torch.int32, device=device)
        self.plane = cache.batch_plane(spec, cfg, self.pad, self.use_fpt)
        # the plane runner reduces it at the end of each chunk
        self.counters = WorkCounters()
        # host-side per-lane occupancy records (None = vacant)
        self.requests: list = [None] * B
        self.admit_s: list = [0.0] * B
        # per-lane cold tiers (repro_torch.core.spill), created at admission
        # when cfg.frontier_spill is on; they survive chunks and are dropped
        # at retirement
        self.spillers: list = [None] * B
        # -- self-healing bookkeeping (repro_torch.faults) ---------------------
        # quarantined lanes (their crashed or stalled occupants were
        # re-queued; a lane stays out of admission until rehabilitated,
        # oldest first), load shedding under repeated faults, and the stall
        # watchdog's per-lane progress snapshots
        self.quarantined: list = []
        self.shed = 0
        self.fault_hits = 0  # accumulator: every 2 plane faults shed 1 lane
        self.fault_free = 0  # consecutive fault-free chunks (heals shedding)
        self.last_rounds: list = [0] * B
        self.stall_chunks: list = [0] * B

    def occupied_count(self) -> int:
        return int(self.lanes.occupied().sum())

    def admit_limit(self) -> int:
        """Lanes usable at once under quarantine and load shedding (never
        below one: a degraded plane still makes progress)."""
        return max(1, self.lanes.num_lanes - len(self.quarantined) - self.shed)

    def vacant_lane(self) -> Optional[int]:
        if self.occupied_count() >= self.admit_limit():
            return None
        free = np.flatnonzero(~self.lanes.occupied())
        for lane in free:
            if int(lane) not in self.quarantined:
                return int(lane)
        # every free lane is quarantined yet the (floor-clamped) budget
        # admits: rehabilitate the oldest quarantine, so repeated faults can
        # never darken the whole plane
        if free.size and self.quarantined:
            return self.quarantined.pop(0)
        return None


class SolveService:
    """The continuous-batching service over one (problem, config), on one
    device.

    >>> svc = SolveService(problem="max_clique",
    ...                    config=SolveConfig(service_lanes=4))  # the card
    >>> t = svc.submit(g, priority=1)
    >>> done = svc.drain()          # or step() incrementally
    >>> svc.result(t).best_size     # pops; KeyError if not finished

    ``device=None`` means ``"cuda"`` and raises ``RuntimeError`` without
    CUDA; ``device="cpu"`` runs the kernels' plain versions.  Only the spmd
    engine has a batched plane, so the service is spmd only.
    """

    def __init__(
        self,
        problem,
        config: Optional[SolveConfig] = None,
        *,
        cache: Optional[PlaneCache] = None,
        clock=None,
        injector=None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.spec = get_problem(problem)
        # monotonic-seconds source for submit/admit/deadline bookkeeping;
        # injectable so wall-clock deadline tests advance time themselves
        self._clock = clock if clock is not None else time.perf_counter
        # optional repro_torch.faults.FaultInjector: fires its plan at this
        # service's chunk boundaries; quarantine and re-queueing are the
        # paired recovery (None: nothing injected, but the watchdog and the
        # timeout sweeps still guard against organic faults)
        self.injector = injector
        self.config = config if config is not None else SolveConfig()
        if self.config.use_mesh:
            raise ValueError(
                "SolveService runs on the vmap virtual-worker plane; "
                "use_mesh configs are not servable yet"
            )
        self.cache = cache if cache is not None else PlaneCache()
        self.scheduler = LaneScheduler(
            self.config.admission, self.config.tenant_max_lanes
        )
        self._planes: dict = {}  # (W, n_exact|None) -> _LivePlane
        self._results: dict = {}  # ticket -> SolveResult | SolveTimeout
        self._next_ticket = 0
        self._t0 = self._clock()
        # ticket -> [faults_injected, faults_recovered, lanes_quarantined]:
        # the per-request slice of the self-healing ledger
        self._req_faults: dict = {}
        self._stats = {
            "submitted": 0,
            "completed": 0,
            "evicted": 0,
            "steps": 0,
            "chunk_calls": 0,
            "supersteps": 0,
            "lane_chunks": 0,
            "live_lane_chunks": 0,
            "wait_s_total": 0.0,
            "residency_s_total": 0.0,
            "lanes_quarantined": 0,
            "timed_out": 0,
        }

    # -- submission ------------------------------------------------------------

    def submit(
        self,
        g,
        *,
        priority: int = 0,
        deadline: Optional[int] = None,
        deadline_s: Optional[float] = None,
        tenant: Optional[str] = None,
        k: Optional[int] = None,
    ) -> int:
        """Queue one instance; returns its ticket immediately.

        ``deadline`` is a superstep budget (anytime eviction at chunk
        granularity); ``deadline_s`` a wall-clock budget in seconds since
        submit, on the service's clock, checked at the same chunk
        boundaries; ``k`` overrides the config's fpt target for this
        request (fpt mode only).
        """
        if k is not None and self.config.mode != "fpt":
            raise ValueError("per-request k needs mode='fpt'")
        if deadline is not None and deadline < 1:
            raise ValueError(f"deadline must be a superstep budget >= 1, got {deadline}")
        if deadline_s is not None and not deadline_s > 0:
            raise ValueError(
                f"deadline_s must be a wall-clock budget > 0 seconds, "
                f"got {deadline_s}"
            )
        if self.config.mode == "fpt" and k is None:
            k = self.config.solo_k()
        ticket = self._next_ticket
        self._next_ticket += 1
        self.scheduler.push(
            SolveRequest(
                ticket=ticket,
                g=g,
                priority=priority,
                deadline=deadline,
                deadline_s=deadline_s,
                tenant=tenant,
                k=k,
                submit_s=self._clock() - self._t0,
            )
        )
        self._stats["submitted"] += 1
        return ticket

    # -- the service loop ------------------------------------------------------

    def step(self) -> list:
        """Admit into vacant lanes, run ONE chunk per live plane, retire
        finished lanes; returns the tickets completed this step.

        With ``config.checkpoint_dir`` set, every ``checkpoint_every``-th
        step also writes a service checkpoint (see :meth:`checkpoint`)."""
        self._stats["steps"] += 1
        completed = self._sweep_queue_timeouts()
        self._admit()
        for plane in self._planes.values():
            if plane.occupied_count() == 0:
                continue  # an all-vacant plane costs nothing
            completed.extend(self._step_plane(plane))
        if (
            self.config.checkpoint_dir is not None
            and self._stats["steps"] % self.config.checkpoint_every == 0
        ):
            self.checkpoint(self.config.checkpoint_dir)
        return completed

    def drain(self) -> list:
        """Run :meth:`step` until the queue is empty and every lane is
        vacant; returns all tickets completed (order = completion order)."""
        completed = []
        while not self.idle():
            completed.extend(self.step())
        return completed

    def idle(self) -> bool:
        return not len(self.scheduler) and not any(
            p.occupied_count() for p in self._planes.values()
        )

    # -- results ---------------------------------------------------------------

    def result(self, ticket: int) -> SolveResult:
        """Pop a finished ticket's result; ``KeyError`` if the ticket is
        unknown or still queued/solving (step/drain first).  A ticket that
        hit ``config.request_timeout_s`` raises its :class:`SolveTimeout`
        (carrying the partial anytime result when one exists)."""
        out = self._results.pop(ticket)
        if isinstance(out, SolveTimeout):
            raise out
        return out

    def ready(self, ticket: int) -> bool:
        return ticket in self._results

    def tickets(self) -> list:
        """Every outstanding ticket (queued or on a lane), sorted."""
        out = {r.ticket for r in self.scheduler.ordered()}
        for p in self._planes.values():
            out.update(r.ticket for r in p.requests if r is not None)
        return sorted(out)

    # -- introspection ---------------------------------------------------------

    def status(self) -> dict:
        """Queue depth plus per-plane lane occupancy (vacant lanes are the
        admission capacity the next ``step`` can fill)."""
        planes = {}
        for key, p in self._planes.items():
            occ = p.occupied_count()
            planes[str(key)] = {
                "lanes": p.lanes.num_lanes,
                "occupied": occ,
                "vacant": p.lanes.num_lanes - occ,
                "tickets": sorted(r.ticket for r in p.requests if r is not None),
            }
        return {"queued": len(self.scheduler), "planes": planes}

    def stats(self) -> dict:
        """Service counters: throughput inputs (completed, chunk_calls),
        plane occupancy (live_lane_chunks / lane_chunks), residency,
        timeouts, the self-healing ledger (the injector's faults and
        retries, zeros without one; quarantined and shed lanes) and, the
        port's own, ``supersteps`` (the plane supersteps every
        chunk ran, each one launch of the expansion kernel per explore
        round for the whole plane) and ``reduce_sweeps`` (the reduction
        sweeps of every plane's explore rounds, see
        :class:`~repro_torch.problems.base.WorkCounters`)."""
        s = dict(self._stats)
        s["queued"] = len(self.scheduler)
        s["planes"] = len(self._planes)
        s["occupancy"] = (
            s["live_lane_chunks"] / s["lane_chunks"] if s["lane_chunks"] else 0.0
        )
        n_done = s["completed"]
        s["wait_s_mean"] = s["wait_s_total"] / n_done if n_done else 0.0
        s["residency_s_mean"] = s["residency_s_total"] / n_done if n_done else 0.0
        inj = self.injector
        s["faults_injected"] = inj.faults_injected if inj is not None else 0
        s["faults_recovered"] = inj.faults_recovered if inj is not None else 0
        s["retries"] = inj.retries if inj is not None else 0
        s["lanes_shed"] = sum(p.shed for p in self._planes.values())
        s["reduce_sweeps"] = sum(
            p.counters.reduce_sweeps for p in self._planes.values()
        )
        return s

    def cache_stats(self) -> dict:
        return self.cache.stats().to_dict()

    # -- durability ------------------------------------------------------------

    def checkpoint(
        self, directory: Optional[str] = None, *, blocking: bool = True
    ) -> str:
        """Snapshot the whole service (every live plane's lane state,
        instance data and FPT bounds, the pending queue, finished but
        unclaimed results, the ticket counter and the stats) atomically
        through :mod:`repro_torch.checkpoint.store`; the step number is the
        service's steps.  Returns the ``step_<N>`` path.

        A service restored from it (:meth:`restore`) finishes every ticket
        with the answers of the uninterrupted service: lane state is exact,
        admission is a pure function of the restored queue and occupancy,
        and superstep deadlines ride in the restored per-lane ``rounds``.
        Each plane's running ``reduce_sweeps`` and the service's
        ``supersteps`` (the port's own counters) ride in meta keys that the
        JAX package does not read."""
        directory = directory or self.config.checkpoint_dir
        if directory is None:
            raise ValueError(
                "no checkpoint directory: pass one or set "
                "SolveConfig.checkpoint_dir"
            )
        ck = _ckpt.SolveCheckpoint(
            kind="service",
            problem=self.spec.name,
            config=self.config.replace(resume_from=None).to_dict(),
            fingerprint=_ckpt.config_fingerprint(
                "service", self.spec.name, self.config, []
            ),
            rounds=self._stats["steps"],
            arrays={},
        )
        planes_meta = []
        for pi, (key, plane) in enumerate(self._planes.items()):
            ck.arrays.update(lane_state_to_flat(plane.lanes, f"plane{pi}/lanes"))
            ck.arrays.update(_ckpt.data_to_flat(plane.datas, f"plane{pi}/datas"))
            if plane.use_fpt:
                ck.arrays[f"plane{pi}/fpt_bounds"] = plane.fpt_bounds.cpu().numpy()
            for lane, sp in enumerate(plane.spillers):
                if sp is not None:
                    ck.arrays.update(sp.to_flat(f"plane{pi}/spill{lane}"))
            planes_meta.append(
                {
                    "key": list(key),
                    "requests": [
                        None if r is None else _req_meta(r)
                        for r in plane.requests
                    ],
                    "admit_s": [float(a) for a in plane.admit_s],
                    "reduce_sweeps": plane.counters.reduce_sweeps,
                }
            )
        live = [r for p in self._planes.values() for r in p.requests if r is not None]
        queued = list(self.scheduler._queue)
        ck.pack_graphs(
            [r.ticket for r in live + queued], [r.g for r in live + queued]
        )
        ck.meta.update(
            {
                "planes": planes_meta,
                "queue": [_req_meta(r) for r in queued],
                "results": {
                    str(t): r.to_dict() for t, r in self._results.items()
                },
                "next_ticket": self._next_ticket,
                # the JAX package's restore merges "stats" into its own
                # counters, so it gets exactly JAX's keys; the port's own
                # counters ride apart, where only the port reads them
                "stats": {k: v for k, v in self._stats.items()
                          if k not in PORT_ONLY_STATS},
                "port_stats": {k: self._stats[k] for k in PORT_ONLY_STATS},
            }
        )
        retry, fault_hook = _io_policy(self.injector)
        return ck.save(directory, self._stats["steps"], blocking=blocking,
                       retry=retry, fault_hook=fault_hook)

    @classmethod
    def restore(
        cls,
        path: str,
        *,
        step: Optional[int] = None,
        cache: Optional[PlaneCache] = None,
        device=None,
    ) -> "SolveService":
        """Rebuild a service on ``device`` (None: the card) from a
        :meth:`checkpoint` snapshot of either package (a checkpoint dir,
        latest intact step, or one ``step_<N>`` subdir).

        Each plane is rebuilt at its saved key through the normal
        :class:`_LivePlane` path (its plane function comes from ``cache``,
        so a warm cache builds none) and the saved lanes, instance data and
        FPT bounds are written into it.  The restored service has no
        injector; ``reduce_sweeps`` resumes from a port checkpoint's
        running sums and counts from the restore for a JAX one."""
        if step is None:
            # walk the retained generations past corrupt snapshots, as the
            # solo and batch resumes do
            ck = _ckpt.SolveCheckpoint.load_latest_good(path, what="service")
        else:
            ck = _ckpt.SolveCheckpoint.load(path, step)
        if ck.kind != "service":
            raise _ckpt.CheckpointError(
                f"{path} holds a {ck.kind!r} checkpoint; "
                f"SolveService.restore needs a 'service' checkpoint"
            )
        svc = cls(ck.problem, SolveConfig.from_dict(ck.config), cache=cache,
                  device=device)
        meta = ck.meta
        graphs = {int(t): ck.unpack_graph(int(t)) for t in meta["graph_ns"]}
        for pi, pmeta in enumerate(meta["planes"]):
            W, n_exact = pmeta["key"]
            key = (int(W), None if n_exact is None else int(n_exact))
            plane = _LivePlane(svc.spec, svc.config, svc.cache, key, svc.device)
            plane.lanes = lane_state_from_flat(ck.arrays, svc.device, f"plane{pi}/lanes")
            plane.datas = _ckpt.data_from_flat(ck.arrays, f"plane{pi}/datas", svc.device)
            if plane.use_fpt:
                plane.fpt_bounds = torch.from_numpy(
                    np.asarray(ck.arrays[f"plane{pi}/fpt_bounds"], np.int32).copy()
                ).to(svc.device)
            plane.requests = [
                None if m is None else _req_from_meta(m, graphs)
                for m in pmeta["requests"]
            ]
            plane.admit_s = [float(a) for a in pmeta["admit_s"]]
            plane.counters.reduce_sweeps = int(pmeta.get("reduce_sweeps", 0))
            if svc.config.frontier_spill:
                for lane, r in enumerate(plane.requests):
                    pref = f"plane{pi}/spill{lane}"
                    if r is not None and FrontierSpiller.present_in(ck.arrays, pref):
                        sp = make_spiller(svc.config, svc.spec, r.g, plane.cap,
                                          svc.config.num_workers)
                        sp.load_flat(ck.arrays, pref)
                        plane.spillers[lane] = sp
            svc._planes[key] = plane
        for m in meta["queue"]:
            svc.scheduler.push(_req_from_meta(m, graphs))
        svc._results = {
            int(t): SolveResult.from_dict(d) for t, d in meta["results"].items()
        }
        svc._next_ticket = int(meta["next_ticket"])
        svc._stats.update(meta["stats"])
        svc._stats.update(meta.get("port_stats", {}))
        return svc

    # -- internals -------------------------------------------------------------

    def _plane_key(self, g) -> tuple:
        return (g.W, g.n if self.config.codec == "basic" else None)

    def _plane_for(self, g) -> _LivePlane:
        key = self._plane_key(g)
        plane = self._planes.get(key)
        if plane is None:
            plane = _LivePlane(self.spec, self.config, self.cache, key, self.device)
            self._planes[key] = plane
        return plane

    def _tenant_occupied(self) -> dict:
        occ: dict = {}
        for p in self._planes.values():
            for r in p.requests:
                if r is not None and r.tenant is not None:
                    occ[r.tenant] = occ.get(r.tenant, 0) + 1
        return occ

    def _admit(self) -> None:
        tenant_occ = self._tenant_occupied()
        for req in self.scheduler.ordered():
            if self.scheduler.tenant_blocked(req, tenant_occ):
                continue
            plane = self._plane_for(req.g)
            lane = plane.vacant_lane()
            if lane is None:
                continue  # this plane is full; later keys may still admit
            self._admit_into(plane, lane, req)
            self.scheduler.remove(req)
            if req.tenant is not None:
                tenant_occ[req.tenant] = tenant_occ.get(req.tenant, 0) + 1

    def _admit_into(self, plane: _LivePlane, lane: int, req: SolveRequest) -> None:
        cfg, spec, g = self.config, self.spec, req.g
        # the solo pad for this n must match the plane's (true for the native
        # record schema; a problem with n-sized record extras under the
        # optimized codec would silently skew byte accounting: refuse)
        solo_pad = make_codec(cfg.codec, g.n, problem=spec).pad_words
        if solo_pad != plane.pad:
            raise ValueError(
                f"problem {spec.name!r} has n-dependent record padding "
                f"(pad {solo_pad} at n={g.n} vs plane {plane.pad}); "
                "serve it with codec='basic' (exact-n planes)"
            )
        initial_best = problems_base.initial_bound(spec, g, cfg.mode, req.k)
        worker = _engine.make_instance_state(
            spec, g, cfg.num_workers, plane.cap, plane.W, initial_best, self.device
        )
        lane_swap_in(plane.lanes, lane, worker, req.ticket)
        problems_base.write_instance(plane.datas, lane, spec, g)
        if plane.use_fpt:
            plane.fpt_bounds[lane] = int(spec.fpt_target(req.k))
        plane.requests[lane] = req
        plane.admit_s[lane] = self._clock() - self._t0
        plane.last_rounds[lane] = 0
        plane.stall_chunks[lane] = 0
        if cfg.frontier_spill:
            plane.spillers[lane] = make_spiller(cfg, spec, g, plane.cap, cfg.num_workers,
                                                self.injector)
        self.cache.note(
            "batch",
            spec,
            cfg,
            plane.pad,
            plane.use_fpt,
            (plane.n_max, plane.W, plane.cap, cfg.num_workers, plane.lanes.num_lanes),
        )

    def _sweep_queue_timeouts(self) -> list:
        """Resolve queued requests past ``config.request_timeout_s`` to a
        typed :class:`SolveTimeout` (no partial result: never admitted)."""
        budget = self.config.request_timeout_s
        if budget is None or not len(self.scheduler):
            return []
        now = self._clock() - self._t0
        out = []
        for req in self.scheduler.ordered():
            waited = now - req.submit_s
            if waited >= budget:
                self.scheduler.remove(req)
                self._req_faults.pop(req.ticket, None)
                self._results[req.ticket] = SolveTimeout(
                    req.ticket, result=None, waited_s=waited
                )
                self._stats["timed_out"] += 1
                out.append(req.ticket)
        return out

    def _quarantine(self, plane: _LivePlane, lane: int, *, injected: int,
                    recovered: int) -> None:
        """Retire a crashed or stalled lane, quarantine it and push its
        occupant back through the scheduler.  The old ticket sorts first in
        both admission orders, so re-admission is deterministic, and
        :meth:`_admit_into` rebuilds the instance from the same startup
        placement (fresh spiller, full replay): the re-run's result is the
        undisturbed solve's."""
        req = plane.requests[lane]
        lane_retire(plane.lanes, lane)
        plane.requests[lane] = None
        plane.spillers[lane] = None
        plane.stall_chunks[lane] = 0
        if lane not in plane.quarantined:
            plane.quarantined.append(lane)
        self._stats["lanes_quarantined"] += 1
        if req is not None:
            self.scheduler.push(req)
            ledger = self._req_faults.setdefault(req.ticket, [0, 0, 0])
            ledger[0] += injected
            ledger[1] += recovered
            ledger[2] += 1

    def _step_plane(self, plane: _LivePlane) -> list:
        inj = self.injector
        self._stats["chunk_calls"] += 1
        self._stats["lane_chunks"] += plane.lanes.num_lanes
        self._stats["live_lane_chunks"] += plane.occupied_count()

        n_faults = 0
        frozen: dict = {}
        if inj is not None:
            inj.step_boundary()
            # crashes: the occupant's state is lost at this boundary;
            # quarantine the lane and re-queue the request (the recovery: a
            # replay from its startup placement)
            live = [int(x) for x in np.flatnonzero(plane.lanes.occupied())]
            for lane in inj.take_crashes(live):
                self._quarantine(plane, lane, injected=1, recovered=1)
                inj.note_recovered("crash")
                n_faults += 1
            # stalls: snapshot before the chunk, write back after it, so the
            # lane makes no progress and the watchdog below catches it
            live = [int(x) for x in np.flatnonzero(plane.lanes.occupied())]
            for lane in inj.stalled_lanes(live):
                frozen[lane] = (lane_slice(plane.lanes, lane),
                                bool(plane.lanes.done[lane]),
                                int(plane.lanes.rounds[lane]))

        occupied = plane.lanes.occupied()
        plane.lanes, ran, hot = step_lanes(
            plane.plane, plane.datas, plane.lanes, plane.fpt_bounds, plane.counters
        )
        self._stats["supersteps"] += ran
        for lane, (worker, done_snap, rounds_snap) in frozen.items():
            lane_write_back(plane.lanes, lane, worker, done_snap, rounds_snap)
        # the service's one host read a chunk (the plane read done once a
        # superstep already)
        done_h = plane.lanes.done.cpu().numpy()
        rounds_h = plane.lanes.rounds.cpu().numpy()

        # the stall watchdog: an occupied, unfinished lane whose round counter
        # made no progress for lane_stall_chunks chunks is quarantined and its
        # request re-queued (this also resolves injected stall windows;
        # organic stalls heal the same way)
        for lane in [int(x) for x in np.flatnonzero(occupied & ~done_h)]:
            if int(rounds_h[lane]) == plane.last_rounds[lane]:
                plane.stall_chunks[lane] += 1
            else:
                plane.stall_chunks[lane] = 0
                plane.last_rounds[lane] = int(rounds_h[lane])
            if plane.stall_chunks[lane] >= self.config.lane_stall_chunks:
                cleared = inj.clear_stall(lane) if inj is not None else 0
                self._quarantine(plane, lane, injected=cleared, recovered=cleared)
                occupied[lane] = False
                frozen.pop(lane, None)
                n_faults += 1

        # graceful degradation: every 2 plane faults shed one admission slot
        # (down to one usable lane); 8 fault-free chunks in a row heal one
        # shed slot, then rehabilitate one quarantined lane
        if n_faults:
            plane.fault_free = 0
            plane.fault_hits += n_faults
            while plane.fault_hits >= 2:
                plane.fault_hits -= 2
                if plane.shed < plane.lanes.num_lanes - 1:
                    plane.shed += 1
        else:
            plane.fault_free += 1
            if plane.fault_free >= 8:
                plane.fault_free = 0
                if plane.shed > 0:
                    plane.shed -= 1
                elif plane.quarantined:
                    plane.quarantined.pop(0)

        if self.config.frontier_spill:
            # the pump runs BEFORE the finished verdict: a lane that went
            # quiescent with a cold backlog is refilled and resumed, not
            # retired.  Only occupied lanes hold a spiller; a lane frozen
            # this chunk is skipped (its hot counts are stale)
            pump_lanes(plane.lanes, plane.spillers, done_h, hot, plane.fpt_bounds,
                       frozen)

        now = self._clock() - self._t0
        timeout_s = self.config.request_timeout_s
        finished = np.flatnonzero(occupied & done_h)
        over_wall = set()
        timed_out = set()
        over_budget = []
        for lane in np.flatnonzero(occupied & ~done_h):
            req = plane.requests[lane]
            if rounds_h[lane] >= min(
                req.deadline or self.config.max_rounds, self.config.max_rounds
            ):
                over_budget.append(lane)
            elif req.deadline_s is not None and now - req.submit_s >= req.deadline_s:
                over_budget.append(lane)
                over_wall.add(int(lane))
            elif timeout_s is not None and now - req.submit_s >= timeout_s:
                over_budget.append(lane)
                timed_out.add(int(lane))
        if len(finished) == 0 and not over_budget:
            return []
        return self._retire(plane, finished, over_budget, over_wall, timed_out,
                            rounds_h, now)

    def _retire(self, plane: _LivePlane, finished, over_budget: list,
                over_wall: set, timed_out: set, rounds_h, now: float) -> list:
        """Collect the results of the lanes that finished (``finished``) or
        went over a budget (``over_budget``), free their lanes; returns
        their tickets in that order."""
        host = _engine._fetch_batch_state(plane.lanes.worker)
        completed = []
        for lane in list(finished) + list(over_budget):
            lane = int(lane)
            req = plane.requests[lane]
            evicted = lane not in finished
            r = _engine._extract_result(
                host,
                lane,
                self.spec,
                req.g,
                int(rounds_h[lane]),
                now - plane.admit_s[lane],
                mode=self.config.mode,
                k=req.k,
                num_workers=self.config.num_workers,
                packed_status=self.config.packed_status,
            )
            sp = plane.spillers[lane]
            _patch_spill(r, sp)
            res = from_engine_result(r, problem=self.spec.name, backend="spmd")
            fi, fr, fq = self._req_faults.pop(req.ticket, (0, 0, 0))
            res.stats.service = ServiceStats(
                lane=lane,
                plane=str(plane.key),
                wait_s=plane.admit_s[lane] - req.submit_s,
                residency_s=now - plane.admit_s[lane],
                deadline_hit=(
                    evicted
                    and req.deadline is not None
                    and lane not in over_wall
                    and lane not in timed_out
                ),
                wall_deadline_hit=lane in over_wall,
                faults_injected=fi,
                faults_recovered=fr,
                lanes_quarantined=fq,
                retries=sp.delivery_retries if sp is not None else 0,
            )
            if lane in timed_out:
                self._results[req.ticket] = SolveTimeout(
                    req.ticket, result=res, waited_s=now - req.submit_s
                )
                self._stats["timed_out"] += 1
            else:
                self._results[req.ticket] = res
            completed.append(req.ticket)
            self._stats["completed"] += 1
            self._stats["evicted"] += int(evicted)
            self._stats["wait_s_total"] += plane.admit_s[lane] - req.submit_s
            self._stats["residency_s_total"] += now - plane.admit_s[lane]
            lane_retire(plane.lanes, lane)
            plane.requests[lane] = None
            plane.spillers[lane] = None
        return completed


class AsyncSolveService:
    """asyncio pump over a :class:`SolveService` for the serve front end.

    ``await svc.solve(g, ...)`` submits and resolves when the lane retires;
    the pump runs :meth:`SolveService.step` in the loop's thread pool so the
    event loop stays responsive while chunks run on the device.  Submission
    and stepping share one lock (the service itself is not thread-safe).

    With ``SolveConfig.request_timeout_s`` set, an awaited solve can never
    hang: a request over budget, queued or on a lane, resolves the future
    with a :class:`SolveTimeout` exception (carrying the partial anytime
    result when one exists).
    """

    def __init__(self, service: SolveService, idle_sleep_s: float = 0.002):
        self.service = service
        self.idle_sleep_s = idle_sleep_s
        self._lock = threading.Lock()
        self._futures: dict = {}
        self._task = None
        self._closing = False

    async def __aenter__(self):
        import asyncio

        self._task = asyncio.get_running_loop().create_task(self._pump())
        return self

    async def __aexit__(self, *exc):
        self._closing = True
        if self._task is not None:
            await self._task
            self._task = None
        return False

    async def solve(self, g, **submit_kw) -> SolveResult:
        import asyncio

        with self._lock:
            ticket = self.service.submit(g, **submit_kw)
        fut = asyncio.get_running_loop().create_future()
        self._futures[ticket] = fut
        return await fut

    async def _pump(self):
        import asyncio

        loop = asyncio.get_running_loop()

        def locked_step():
            with self._lock:
                return self.service.step()

        while True:
            with self._lock:
                idle = self.service.idle()
            if idle:
                if self._closing:
                    return
                await asyncio.sleep(self.idle_sleep_s)
                continue
            done = await loop.run_in_executor(None, locked_step)
            for ticket in done:
                fut = self._futures.pop(ticket, None)
                if fut is None:
                    continue
                try:
                    res = self.service.result(ticket)
                except SolveTimeout as exc:
                    if not fut.done():
                        fut.set_exception(exc)
                else:
                    if not fut.done():
                        fut.set_result(res)
            await asyncio.sleep(0)
