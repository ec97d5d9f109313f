"""Host side of the solve plane: startup scatter, batch packing and result
extraction.

The port of the helpers of ``repro/core/engine.py``:

* **startup** (§3.5): expand the root on the host until >= P open tasks
  exist (BFS = the equitable split), order the workers by the Algorithm-7
  waiting-list traversal, and scatter task i to worker ``order[i mod P]``.
  The state is built in numpy and moved to the device once, for one
  instance or stacked for a batch;
* **buckets**: ``solve_many`` groups instances by packed width W;
* **collect**: one host fetch; the best solution is the one of the worker
  with the least local best (the center "fetches it only when the
  exploration has finished", §3.1), per lane of a batch;
* **elasticity**: :func:`snapshot`/:func:`restore` move a worker state
  through host numpy in the JAX package's layout (either package's snapshot
  restores in the other), and :func:`resize` re-splits every pending task
  over another worker count;
* **legacy shims**: the deprecated :func:`solve`/:func:`solve_many` keyword
  surface over the session's solve loops.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import numpy as np

from repro_torch.core.frontier import Frontier
from repro_torch.core.superstep import (
    WorkerState,
    worker_state_from_flat,
    worker_state_to_flat,
)
from repro_torch.core.waiting_list import startup_assignment
from repro_torch.problems import base as problems_base
from repro_torch.problems.registry import DEFAULT_PROBLEM, get_problem


@dataclasses.dataclass
class EngineResult:
    best_size: int
    best_sol: Optional[np.ndarray]
    rounds: int
    nodes_expanded: int
    tasks_transferred: int
    wall_s: float
    overflow: bool
    # exact number of tasks lost to frontier saturation (summed over workers)
    overflow_count: int
    # collective-traffic accounting (bytes), as the JAX package reports it:
    # the control plane's static per-round budget, and the data plane's
    # task-record payload over the rounds that ran it
    control_bytes_per_round: int
    transfer_rounds: int
    transfer_bytes_total: int
    transfer_bytes_per_round: float
    # durability: how many SolveCheckpoints this run wrote, and the
    # checkpoint path it restored from (None = started fresh); set by the
    # solve loops in repro_torch.api.backends
    checkpoints_written: int = 0
    resumed_from: Optional[str] = None
    # hierarchical frontier memory (repro_torch.core.spill): tasks evicted
    # to / re-admitted from the host cold tier, and its peak encoded size;
    # set by the drivers when cfg.frontier_spill is on (overflow_count then
    # stays 0 by construction, so saturation shows here instead)
    spilled_tasks: int = 0
    readmitted_tasks: int = 0
    cold_bytes_peak: int = 0
    # reduction sweeps run over whole lane batches (set by the driver)
    reduce_sweeps: int = 0


def _scatter_startup(
    flat: dict, problem, g, num_workers: int, tasks=None, prefix: str = "worker"
) -> None:
    """BFS-split the root into ~P tasks and place them, in place in the
    numpy ``flat`` state, per the Algorithm-7 order (task i on worker
    ``order[i mod P]``, in its next free slot)."""
    if tasks is None:
        tasks = problems_base.expand_frontier(problem, g, num_tasks=num_workers)
    order = startup_assignment(max_b=2, p=num_workers)  # 1-based worker ids
    masks = flat[f"{prefix}.frontier.masks"]
    sols = flat[f"{prefix}.frontier.sols"]
    depths = flat[f"{prefix}.frontier.depths"]
    active = flat[f"{prefix}.frontier.active"]
    for i, (mask, sol, depth) in enumerate(tasks):
        w = order[i % num_workers] - 1
        slot = int(np.argmin(active[w]))  # next free slot on worker w
        if active[w, slot]:
            raise RuntimeError(
                f"startup overflow: worker {w} has no free slot "
                f"(capacity {active.shape[1]})"
            )
        masks[w, slot] = mask
        sols[w, slot] = sol
        depths[w, slot] = depth
        active[w, slot] = True


def blank_state_flat(
    num_workers: int, cap: int, W: int, initial_best: int, prefix: str = "worker"
) -> dict:
    """A fresh (P, ...) worker state as named numpy arrays."""
    P = num_workers

    def z():
        return np.zeros((P,), np.int32)

    best = np.full((P,), initial_best, np.int32)
    return {
        f"{prefix}.frontier.masks": np.zeros((P, cap, W), np.uint32),
        f"{prefix}.frontier.sols": np.zeros((P, cap, W), np.uint32),
        f"{prefix}.frontier.depths": np.zeros((P, cap), np.int32),
        f"{prefix}.frontier.active": np.zeros((P, cap), bool),
        f"{prefix}.frontier.overflow": np.zeros((P,), bool),
        f"{prefix}.frontier.dropped": z(),
        f"{prefix}.best_val": best,
        f"{prefix}.local_best_val": best.copy(),
        f"{prefix}.best_sol": np.zeros((P, W), np.uint32),
        f"{prefix}.nodes_expanded": z(),
        f"{prefix}.tasks_sent": z(),
        f"{prefix}.tasks_recv": z(),
        f"{prefix}.rounds": z(),
        f"{prefix}.transfer_rounds": z(),
        f"{prefix}.payload_words": z(),
    }


def make_instance_state(
    problem, g, num_workers: int, cap: int, W: int, initial_best: int, device
) -> WorkerState:
    """One instance's (P, ...) worker state, §3.5-startup-scattered on the
    host and moved to ``device`` once."""
    return worker_state_from_flat(
        _startup_flat(problem, g, num_workers, cap, W, initial_best), device
    )


def _startup_flat(problem, g, num_workers, cap, W, initial_best) -> dict:
    flat = blank_state_flat(num_workers, cap, W, initial_best)
    _scatter_startup(flat, problem, g, num_workers)
    return flat


def _make_batch_state(
    problem, graphs, num_workers: int, cap: int, W: int, initial_bests, device
) -> WorkerState:
    """(B, P, ...) stacked worker state: each instance blank-initialized and
    startup-scattered exactly as a solo solve (:func:`make_instance_state`),
    stacked in numpy and moved to ``device`` once."""
    flats = [
        _startup_flat(problem, g, num_workers, cap, W, best)
        for g, best in zip(graphs, initial_bests)
    ]
    return worker_state_from_flat(
        {k: np.stack([f[k] for f in flats]) for k in flats[0]}, device
    )


def _fetch_batch_state(state: WorkerState) -> dict:
    """The fields result extraction reads from a (B, P, ...) state, in one
    host fetch each."""
    return {
        "local_best_val": state.local_best_val.cpu().numpy(),
        "best_sol": state.best_sol.cpu().numpy().view(np.uint32),
        "nodes_expanded": state.nodes_expanded.cpu().numpy(),
        "tasks_sent": state.tasks_sent.cpu().numpy(),
        "overflow": state.frontier.overflow.cpu().numpy(),
        "dropped": state.frontier.dropped.cpu().numpy(),
        "transfer_rounds": state.transfer_rounds.cpu().numpy(),
        "payload_words": state.payload_words.cpu().numpy(),
    }


def _extract_result(
    host_state: dict,
    lane: int,
    problem,
    g,
    rounds: int,
    wall_s: float,
    *,
    mode: str,
    k,
    num_workers: int,
    packed_status: bool,
) -> EngineResult:
    """The EngineResult of lane ``lane`` of a fetched batch state.
    ``best_size`` is in the problem's EXTERNAL objective; "found nothing
    acceptable" is exactly "the internal best never improved on the seed
    bound"."""
    local_bests = host_state["local_best_val"][lane]
    wbest = int(np.argmin(local_bests))
    internal_best = int(local_bests[wbest])
    found = internal_best < problems_base.initial_bound(problem, g, mode, k)
    best_size = int(problem.external_value(internal_best))
    best_sol = host_state["best_sol"][lane][wbest].copy()
    if not found:
        best_sol = None
        if mode == "fpt":
            best_size = -1
    # payload_words / transfer_rounds are the same on every worker
    payload_words = int(host_state["payload_words"][lane][0])
    return EngineResult(
        best_size=best_size,
        best_sol=best_sol,
        rounds=rounds,
        nodes_expanded=int(host_state["nodes_expanded"][lane].sum()),
        tasks_transferred=int(host_state["tasks_sent"][lane].sum()),
        wall_s=wall_s,
        overflow=bool(host_state["overflow"][lane].any()),
        overflow_count=int(host_state["dropped"][lane].sum()),
        control_bytes_per_round=4 * (1 if packed_status else 3) * num_workers,
        transfer_rounds=int(host_state["transfer_rounds"][lane][0]),
        transfer_bytes_total=4 * payload_words,
        transfer_bytes_per_round=4 * payload_words / max(rounds, 1),
    )


# -- the multi-instance solve plane --------------------------------------------


@dataclasses.dataclass
class BatchResult:
    """Per-instance results of one ``solve_many`` call.

    ``results[i]`` corresponds to ``graphs[i]`` (submission order survives
    bucketing).  ``wall_s`` is the total wall time over all buckets; each
    ``EngineResult.wall_s`` inside is the bucket wall over the bucket size
    (instances in a batch are not individually timeable)."""

    results: list
    wall_s: float
    # packing record: one (W, n_max, [instance indices]) triple per bucket
    buckets: list
    compactions: int
    # plane occupancy counters (see api.result.LaneStats)
    lane_stats: dict = dataclasses.field(default_factory=dict)


def _bucket_instances(graphs, by_n: bool = False) -> dict:
    """Group instance indices by packed width W = n_words(n).

    Instances sharing W pad to the bucket's max n with isolated (never
    in-mask) vertices, so the padded trace is bit-identical to the solo one.
    ``by_n`` buckets by exact (W, n) instead: the basic codec's payload pad
    is n·W words, so mixing n under one pad would skew its byte accounting.
    """
    buckets: dict = {}
    for i, g in enumerate(graphs):
        buckets.setdefault((g.W, g.n if by_n else None), []).append(i)
    return buckets


def _pow2_at_least(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


# -- the deprecated keyword surface ----------------------------------------------

# JAX's warning text, with the port's package name
_DEPRECATED = (
    "engine.{verb} is deprecated and will be REMOVED in v1.0; use "
    "repro_torch.api.SolverSession(...).{verb} (see the README migration "
    "table: 'Migrating from the legacy engine API')"
)


def solve(
    g,
    num_workers: int = 8,
    *,
    problem=DEFAULT_PROBLEM,
    steps_per_round: int = 32,
    lanes: int = 1,
    policy_priority: bool = True,
    codec: str = "optimized",
    packed_status: bool = True,
    skip_empty_transfer: bool = True,
    transfer_impl: str = "sparse",
    explore_impl: str = "fused",
    donate_k: int = 1,
    chunk_rounds: int = 16,
    mode: str = "bnb",
    k: Optional[int] = None,
    mesh=None,
    max_rounds: int = 200_000,
    capacity: Optional[int] = None,
    initial_state: Optional[WorkerState] = None,
    compact_threshold: float = 0.25,
    device=None,
) -> EngineResult:
    """DEPRECATED shim over the session's solve loop: one instance of
    ``problem`` with P workers on ``device`` (None: the card).

    Prefer ``SolverSession(problem=..., config=SolveConfig(...),
    device=...).solve(g)``.  The JAX package's legacy keywords map onto a
    :class:`~repro_torch.api.SolveConfig` (``compact_threshold`` is accepted
    and inert, as there), every call shares the process-wide
    ``LEGACY_CACHE``, and the legacy :class:`EngineResult` comes back.  A
    ``mesh`` (a :class:`~repro_torch.launch.mesh.SolverMesh` of
    ``num_workers`` ranks; anything else raises ``ValueError``) runs the
    solve one worker a rank, on the mesh's device."""
    warnings.warn(_DEPRECATED.format(verb="solve"), DeprecationWarning, stacklevel=2)
    from repro_torch.api import backends as _api
    from repro_torch.api.session import resolve_device

    cfg = _api.config_from_legacy(
        policy_priority=policy_priority,
        num_workers=num_workers,
        steps_per_round=steps_per_round,
        lanes=lanes,
        codec=codec,
        packed_status=packed_status,
        skip_empty_transfer=skip_empty_transfer,
        transfer_impl=transfer_impl,
        explore_impl=explore_impl,
        donate_k=donate_k,
        chunk_rounds=chunk_rounds,
        mode=mode,
        k=k,
        max_rounds=max_rounds,
        capacity=capacity,
        compact_threshold=compact_threshold,
    )
    return _api.solve_spmd(
        get_problem(problem), g, cfg, _api.LEGACY_CACHE,
        device=resolve_device(device), initial_state=initial_state, mesh=mesh,
    )


def solve_many(
    graphs,
    num_workers: int = 8,
    *,
    problem=DEFAULT_PROBLEM,
    steps_per_round: int = 32,
    lanes: int = 1,
    policy_priority: bool = True,
    codec: str = "optimized",
    packed_status: bool = True,
    skip_empty_transfer: bool = True,
    transfer_impl: str = "sparse",
    explore_impl: str = "fused",
    donate_k: int = 1,
    chunk_rounds: int = 16,
    mode: str = "bnb",
    k=None,
    mesh=None,
    max_rounds: int = 200_000,
    capacity: Optional[int] = None,
    compact_threshold: float = 0.25,
    device=None,
) -> BatchResult:
    """DEPRECATED shim over the session's batched solve loop: B instances of
    ``problem`` on one plane on ``device`` (None: the card).

    Prefer ``SolverSession(...).solve_many(graphs)``.  ``k`` may be one int
    or one per instance; ``mesh`` must stay None (the batched plane has no
    mesh path, in either package: ``ValueError``).  Returns the legacy
    :class:`BatchResult`."""
    warnings.warn(_DEPRECATED.format(verb="solve_many"), DeprecationWarning,
                  stacklevel=2)
    if mesh is not None:
        raise ValueError(
            "solve_many has no mesh path yet (vmap virtual workers only); "
            "pass mesh=None"
        )
    from repro_torch.api import backends as _api
    from repro_torch.api.session import resolve_device

    cfg = _api.config_from_legacy(
        policy_priority=policy_priority,
        num_workers=num_workers,
        steps_per_round=steps_per_round,
        lanes=lanes,
        codec=codec,
        packed_status=packed_status,
        skip_empty_transfer=skip_empty_transfer,
        transfer_impl=transfer_impl,
        explore_impl=explore_impl,
        donate_k=donate_k,
        chunk_rounds=chunk_rounds,
        mode=mode,
        k=(tuple(k) if hasattr(k, "__len__") else k),
        max_rounds=max_rounds,
        capacity=capacity,
        compact_threshold=compact_threshold,
    )
    return _api.solve_many_spmd(get_problem(problem), graphs, cfg,
                                _api.LEGACY_CACHE, device=resolve_device(device))


# -- elasticity -------------------------------------------------------------------
#
# A snapshot is the JAX package's: ``WorkerState._asdict()`` with every leaf a
# host numpy array and ``frontier`` a Frontier of numpy arrays (the JAX
# snapshot's is its own Frontier class; either restores here, and so does a
# plain dict), packed words uint32.

_SNAP = "snapshot"


def _host_leaves(state: WorkerState) -> dict:
    """Every leaf of ``state`` as a host array, by its flat name
    (``frontier.masks``, ``best_val``, ...)."""
    flat = worker_state_to_flat(state, _SNAP)
    return {k[len(_SNAP) + 1:]: v for k, v in flat.items()}


def snapshot(state: WorkerState) -> dict:
    """Host-side copy of the whole engine state, in the JAX layout."""
    host = _host_leaves(state)
    snap = {k: host[k] for k in WorkerState._fields if k != "frontier"}
    snap["frontier"] = Frontier(*(host[f"frontier.{k}"] for k in Frontier._fields))
    return snap


def restore(snap: dict, device=None) -> WorkerState:
    """A :func:`snapshot` of either package back on ``device`` (None: the
    card)."""
    from repro_torch.api.session import resolve_device

    fr = snap["frontier"]
    fr = fr if isinstance(fr, dict) else fr._asdict()
    flat = {f"{_SNAP}.frontier.{k}": np.asarray(v) for k, v in fr.items()}
    flat.update({f"{_SNAP}.{k}": np.asarray(v) for k, v in snap.items() if k != "frontier"})
    return worker_state_from_flat(flat, resolve_device(device), _SNAP)


def resize(state: WorkerState, new_num_workers: int) -> WorkerState:
    """Re-split every pending task over ``new_num_workers`` workers (elastic
    scale-up or -down, or a failed node's recovery: a task is a record over
    the original instance, so any worker count works), on the state's
    device.

    Tasks are taken in (worker, slot) order and task i goes to slot
    ``i // P_new`` of worker ``i % P_new``, as in the JAX package.  The new
    state carries the best value (every worker's global and local best) and
    the best worker's solution; every counter restarts.  Raises
    ``ValueError`` when the capacity cannot hold the tasks."""
    host = _host_leaves(state)
    masks, sols = host["frontier.masks"], host["frontier.sols"]
    depths, active = host["frontier.depths"], host["frontier.active"]
    cap, W = masks.shape[1], masks.shape[2]
    w_old, s_old = np.nonzero(active)  # (worker, slot) scan order
    i = np.arange(w_old.size)
    w_new, s_new = i % new_num_workers, i // new_num_workers
    if w_old.size and int(s_new[-1]) >= cap:
        raise ValueError(
            f"resize: capacity {cap} too small for {w_old.size} pending tasks "
            f"on {new_num_workers} workers"
        )
    local = host["local_best_val"]
    new = blank_state_flat(new_num_workers, cap, W, int(local.min()), _SNAP)
    for name, src in (("masks", masks), ("sols", sols), ("depths", depths)):
        new[f"{_SNAP}.frontier.{name}"][w_new, s_new] = src[w_old, s_old]
    new[f"{_SNAP}.frontier.active"][w_new, s_new] = True
    new[f"{_SNAP}.best_sol"][:] = host["best_sol"][int(np.argmin(local))]
    return worker_state_from_flat(new, state.best_val.device, _SNAP)
