"""The port's backends: the spmd solve planes, the two discrete-event
simulators and the sequential reference.

The port of ``repro/api/backends.py``'s ``solve_spmd``, ``solve_many_spmd``,
its host backends and its ``Backend`` registry. The spmd drivers are the JAX
package's loops: startup scatter, then chunks of up to ``chunk_rounds``
supersteps until quiescence (or the FPT bound) or ``max_rounds``, then one
host fetch; the batched driver adds bucketing by W, pow2 compaction and
eager per-lane result extraction. Both take their plane from a
:class:`PlaneCache`, and both are durable: ``checkpoint_dir`` writes a
:class:`~repro_torch.checkpoint.solve.SolveCheckpoint` every
``checkpoint_every`` chunks at the host-sync boundary, and ``resume_from``
continues from one (either package's) to the result of a run that never
stopped. With ``frontier_spill`` each instance gets a
:class:`~repro_torch.core.spill.FrontierSpiller`: after a chunk its host
pump evicts above the high-water mark into the cold tier and refills below
the low one, so a saturated frontier drops nothing, and the cold tier rides
in the checkpoints. With an ``injector`` (a
:class:`~repro_torch.faults.FaultInjector`) both drivers heal the faults it
fires at their host-sync boundaries: a crashed solo plane is rebuilt from
the last good checkpoint (or replayed from the startup placement), a crashed
lane of the batch is re-admitted from its startup placement, and checkpoint
I/O errors are retried under the injector's virtual backoff.

Features of the JAX drivers that the port does not carry yet (the mesh) are
refused with ``NotImplementedError`` naming their ROADMAP item; none is
silently ignored.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.api.cache import PlaneCache
from repro_torch.api.config import SolveConfig
from repro_torch.api.result import (
    BatchSolveResult,
    LaneStats,
    SolveResult,
    from_engine_result,
    from_sequential,
    from_sim_result,
)
from repro_torch.checkpoint import solve as _ckpt
from repro_torch.checkpoint import store as _store
from repro_torch.core import engine as _engine
from repro_torch.core.encoding import make_codec
from repro_torch.core.spill import FrontierSpiller, make_spiller, pump_lanes
from repro_torch.core.superstep import (
    LaneState,
    lane_state_from_flat,
    lane_state_to_flat,
    lane_swap_in,
    map_state,
    slice_lanes,
    state_to,
    step_lanes,
    worker_state_from_flat,
    worker_state_to_flat,
)
from repro_torch.graphs.bitgraph import n_words
from repro_torch.problems import base as problems_base
from repro_torch.problems.base import WorkCounters

# config knobs / arguments the port refuses, with the ROADMAP item that ports them
_NOT_PORTED = {
    "use_mesh": "queue 1, item 13 (multi-device path)",
    "mesh": "queue 1, item 13 (multi-device path)",
}


def _refuse(what: str) -> None:
    raise NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP {_NOT_PORTED[what]})"
    )


def _io_policy(injector) -> tuple:
    """``(retry, fault_hook)`` for the checkpoint store: the injector's
    virtual-backoff retry policy and its I/O fault hook, or ``(None,
    None)`` without one."""
    if injector is None:
        return None, None
    return injector.retry_policy(), injector.io_hook


def _load_resume(cfg: SolveConfig, kind: str, fingerprint: str, verb: str,
                 problem: str, retry=None, fault_hook=None):
    """The newest intact ``kind`` checkpoint under ``cfg.resume_from`` whose
    fingerprint is ``fingerprint`` (falling back past corrupt generations
    with a warning), for the solve loop ``verb``; I/O under ``retry`` and
    ``fault_hook``."""
    ck = _ckpt.SolveCheckpoint.load_latest_good(
        cfg.resume_from, expected_fingerprint=fingerprint,
        what=f"{verb}({problem})", retry=retry, fault_hook=fault_hook,
    )
    if ck.kind != kind:
        raise _ckpt.CheckpointError(
            f"{cfg.resume_from} holds a {ck.kind!r} checkpoint; "
            f"{verb}() resumes {kind!r} checkpoints only"
        )
    return ck


def _write_solo_checkpoint(spec, g, cfg, fingerprint, state, rounds,
                           reduce_sweeps, spill=None, retry=None,
                           fault_hook=None) -> None:
    """One atomic SolveCheckpoint of a solo solve at a chunk boundary, the
    cold tier of ``spill`` included; the port's running ``reduce_sweeps``
    rides in its meta.  The write runs under ``retry`` and ``fault_hook``."""
    ck = _ckpt.SolveCheckpoint(
        kind="solo",
        problem=spec.name,
        config=cfg.replace(resume_from=None).to_dict(),
        fingerprint=fingerprint,
        rounds=rounds,
        arrays=worker_state_to_flat(state),
        meta={"reduce_sweeps": reduce_sweeps},
    )
    if spill is not None:
        ck.arrays.update(spill.to_flat())
    ck.pack_graphs([0], [g])
    ck.save(cfg.checkpoint_dir, rounds, retry=retry, fault_hook=fault_hook)


def solve_spmd(
    spec,
    g,
    cfg: SolveConfig,
    cache: PlaneCache,
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
    instead of the startup scatter, with ``rounds`` counted from 0.

    Durability: with ``cfg.checkpoint_dir`` set, a ``"solo"``
    :class:`~repro_torch.checkpoint.solve.SolveCheckpoint` is written
    atomically every ``cfg.checkpoint_every`` chunks at the host-sync
    boundary (step number = rounds completed): the state's copy to the
    host, then CRC32 and ``np.savez``; a chunk that writes nothing pays
    nothing.  With ``cfg.resume_from`` set, the solve restores the
    newest intact generation of that state (fingerprint-checked, falling
    back past corrupt generations with a warning) and continues; the loop
    is deterministic, so the result equals an uninterrupted run's (modulo
    ``wall_s`` and the durability bookkeeping).  ``reduce_sweeps`` resumes
    from the running sum a port checkpoint keeps in its meta; a JAX
    checkpoint has none, so there it counts from the resume.

    Spill: with ``cfg.frontier_spill`` a spiller is built for the state's
    capacity (an undersized capacity raises ``ValueError`` here, at solve
    start), loaded from the checkpoint's cold tier on resume.  After a
    chunk whose (P,) hot counts call for it, the pump runs, unless the FPT
    bound was hit (that finishes the solve whatever the backlog), and the
    solve is done only when the plane was done and the pump left nothing
    pending.

    Faults: ``injector`` (a :class:`~repro_torch.faults.FaultInjector`)
    ticks once a chunk, after the pump and before the checkpoint write.  A
    crash there discards the state: it is rebuilt from the newest good
    checkpoint under ``cfg.checkpoint_dir`` when the solve is durable and has
    written one, else from ``initial_state`` or the startup scatter with
    ``rounds`` 0.  The checkpoint and the startup scatter come with a fresh
    spiller (loaded from the checkpoint's cold tier); a replay from
    ``initial_state`` keeps the spiller, as the JAX package does.  The
    rebuilt solve replays a prefix of the same deterministic trajectory, so
    the result is the undisturbed one's, and ``reduce_sweeps`` rewinds with
    the state (to the checkpoint's running sum, or 0).  Checkpoint reads and
    writes run under the injector's retry policy and I/O hook; the spiller
    heals the corruption it injects."""
    if cfg.use_mesh:
        _refuse("use_mesh")
    if mesh is not None:
        _refuse("mesh")

    k = cfg.solo_k()
    W = n_words(g.n)
    initial_best = problems_base.initial_bound(spec, g, cfg.mode, k)
    pad = make_codec(cfg.codec, g.n, problem=spec).pad_words
    counters = WorkCounters()
    use_fpt = cfg.mode == "fpt"
    fpt_bound = int(spec.fpt_target(k)) if use_fpt else None
    io_retry, io_hook = _io_policy(injector)
    fingerprint = None
    if cfg.checkpoint_dir is not None or cfg.resume_from is not None:
        fingerprint = _ckpt.config_fingerprint(
            "solo", spec.name, cfg, [_ckpt.graph_digest(g)]
        )

    data = problems_base.make_data(spec, g, device)
    rounds = 0
    ck = None
    cap = cfg.capacity or (4 * g.n + 8 * cfg.lanes)

    def build_startup():
        return _engine.make_instance_state(
            spec, g, cfg.num_workers, cap, W, initial_best, device
        )

    def restore(ck):
        """A solo checkpoint's state and rounds; its running
        ``reduce_sweeps`` (a port checkpoint's meta; 0 in a JAX one) goes
        back into the counters."""
        counters.reduce_sweeps = int(ck.meta.get("reduce_sweeps", 0))
        return worker_state_from_flat(ck.arrays, device), ck.rounds

    if cfg.resume_from is not None:
        if initial_state is not None:
            raise ValueError("pass resume_from or initial_state, not both")
        ck = _load_resume(cfg, "solo", fingerprint, "solve", spec.name,
                          io_retry, io_hook)
        state, rounds = restore(ck)
        cap = int(state.frontier.masks.shape[-2])
    elif initial_state is None:
        state = build_startup()
    else:
        state = state_to(initial_state, device)
        cap = int(state.frontier.masks.shape[-2])

    def new_spiller(arrays=None):
        """A spiller of the state's capacity (None without spill), loaded
        from a checkpoint's cold tier when ``arrays`` holds one."""
        if not cfg.frontier_spill:
            return None
        sp = make_spiller(cfg, spec, g, cap, cfg.num_workers, injector)
        if arrays is not None and FrontierSpiller.present_in(arrays):
            sp.load_flat(arrays)
        return sp

    spill = new_spiller(None if ck is None else ck.arrays)
    plane = cache.solo_plane(spec, cfg, pad, use_fpt)
    cache.note("solo", spec, cfg, pad, use_fpt, (g.n, W, cap, cfg.num_workers))

    t0 = time.perf_counter()
    chunks = 0
    checkpoints_written = 0
    while rounds < cfg.max_rounds:
        state, done, ran, hot = plane(data, state, fpt_bound, counters)
        rounds += ran
        chunks += 1
        if spill is not None and spill.wants_pump(hot.cpu().numpy(), done):
            # an FPT bound hit finishes the solve whatever the cold backlog;
            # quiescence without it must refill and continue
            fpt_hit = done and use_fpt and int(state.best_val.min()) <= fpt_bound
            if not fpt_hit:
                _, hot_h = spill.pump_frontier(state.frontier)
                done = done and int(hot_h.sum()) == 0
        if injector is not None:
            injector.step_boundary()
            if injector.take_crash():
                # the plane's state died at this boundary: rebuild it from the
                # last good checkpoint when the solve is durable, else replay
                # from the startup placement; both re-run a prefix of the
                # same trajectory, so the answer is unchanged
                if (cfg.checkpoint_dir is not None
                        and _store.latest_step(cfg.checkpoint_dir) is not None):
                    rck = _ckpt.SolveCheckpoint.load_latest_good(
                        cfg.checkpoint_dir, expected_fingerprint=fingerprint,
                        what=f"solve({spec.name}) crash recovery",
                        retry=io_retry, fault_hook=io_hook,
                    )
                    state, rounds = restore(rck)
                    spill = new_spiller(rck.arrays)
                elif initial_state is not None:
                    # as the JAX package does, the replay from a caller's
                    # state keeps the spiller (ROADMAP section 3)
                    state = map_state(lambda x: x.to(device, copy=True), initial_state)
                    rounds = 0
                    counters.reduce_sweeps = 0
                else:
                    state = build_startup()
                    rounds = 0
                    counters.reduce_sweeps = 0
                    spill = new_spiller()
                injector.note_recovered("crash")
                done = False
        if done:
            break
        if cfg.checkpoint_dir is not None and chunks % cfg.checkpoint_every == 0:
            _write_solo_checkpoint(spec, g, cfg, fingerprint, state, rounds,
                                   counters.reduce_sweeps, spill,
                                   io_retry, io_hook)
            checkpoints_written += 1
    host = _engine._fetch_batch_state(map_state(lambda x: x[None], state))
    wall = time.perf_counter() - t0

    r = _engine._extract_result(
        host,
        0,
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
    r.checkpoints_written = checkpoints_written
    r.resumed_from = cfg.resume_from
    _patch_spill(r, spill)
    return r


def _patch_spill(r, spill) -> None:
    """Copy a spiller's counters into an EngineResult (no-op without one)."""
    if spill is not None:
        r.spilled_tasks = spill.spilled_total
        r.readmitted_tasks = spill.readmitted_total
        r.cold_bytes_peak = spill.cold_bytes_peak


def solve_many_spmd(spec, graphs, cfg: SolveConfig, cache: PlaneCache, *,
                    device, injector=None):
    """B instances on one batched plane per W bucket; returns an
    :class:`~repro_torch.core.engine.BatchResult`.

    The JAX driver's bucketing, padding and compaction: buckets are sorted
    by (W, n), each pads to its max n (exact n under the basic codec, whose
    payload is n·W words), and its frontier capacity is ``4·n_max +
    8·lanes``.  When at most ``compact_threshold`` of a bucket's lanes are
    live, finished lanes' results are extracted and the lanes are resliced
    down to the next power of two (finished lanes fill up to it), and the
    same plane function keeps running.  Results come back in the caller's
    order; each instance's ``wall_s`` is its bucket's wall over the bucket
    size.  ``k`` may be one int or one per instance (fpt).

    Durability mirrors :func:`solve_spmd`: every ``cfg.checkpoint_every``
    chunks a ``"many"`` checkpoint holds the in-flight bucket's lane state,
    instance data and FPT bounds, and in its meta the bucket index, the
    bucket's supersteps, the chunk count (its step number, monotonic across
    buckets), the compactions, the plane counters and every result
    finalized so far.  ``cfg.resume_from`` skips the finished buckets and
    restarts mid-bucket.  Results are finalized eagerly (at compaction and
    at the bucket's end), so a checkpoint never needs a lane that was
    compacted away; ``wall_s`` is the one result field outside the
    bit-identity contract.

    Spill: with ``cfg.frontier_spill`` each lane has its own spiller (built
    at the bucket's start, or from the checkpoint's ``spill{lane}`` arrays
    on resume), pumped after each chunk by
    :func:`~repro_torch.core.spill.pump_lanes` (the service's pump too),
    which resumes a done lane it refilled.  Compaction slices the spillers
    with their lanes, and each collected result carries its lane's spill
    counters.

    Faults: ``injector`` ticks once a chunk, after the pump and before
    compaction and the checkpoint write.  Its crashes map onto the live
    lanes (modulo their count); a crashed lane is re-admitted from its
    instance's startup placement (the center still knows which instance
    the lane held: its tag) with a fresh spiller, a replay whose result is
    the undisturbed one's.  ``lane_stats["reduce_sweeps"]`` counts the work
    done, replays included.  Checkpoint reads and writes run under the
    injector's retry policy and I/O hook."""
    if cfg.use_mesh:
        raise ValueError(
            "solve_many has no mesh path yet (vmap virtual workers only); "
            "use solve() per instance or a config with use_mesh=False"
        )
    graphs = list(graphs)
    B = len(graphs)
    use_fpt = cfg.mode == "fpt"
    if use_fpt:
        ks = list(cfg.k) if isinstance(cfg.k, tuple) else [cfg.k] * B
        if len(ks) != B or any(kk is None for kk in ks):
            raise ValueError("fpt mode needs one k (or one per instance)")
    else:
        ks = [None] * B
    results: dict = {}
    bucket_record = []
    compactions = 0
    wall_total = 0.0
    lane_stats = {"chunk_calls": 0, "lane_chunks": 0, "live_lane_chunks": 0}
    counters = WorkCounters()
    chunks_total = 0
    checkpoints_written = 0
    io_retry, io_hook = _io_policy(injector)

    fingerprint = None
    if cfg.checkpoint_dir is not None or cfg.resume_from is not None:
        fingerprint = _ckpt.config_fingerprint(
            "many", spec.name, cfg, [_ckpt.graph_digest(g) for g in graphs]
        )
    resume_ck = None
    resume_bucket = -1
    if cfg.resume_from is not None:
        resume_ck = _load_resume(cfg, "many", fingerprint, "solve_many", spec.name,
                                 io_retry, io_hook)
        meta = resume_ck.meta
        results = {
            int(i): _ckpt.engine_result_from_dict(d)
            for i, d in meta["results"].items()
        }
        compactions = int(meta["compactions"])
        chunks_total = int(meta["chunks_total"])
        lane_stats.update(
            {k: int(v) for k, v in meta["lane_stats"].items() if k in lane_stats}
        )
        counters.reduce_sweeps = int(meta["lane_stats"].get("reduce_sweeps", 0))
        resume_bucket = int(meta["bucket_idx"])

    def extract(host, lane, oi, rounds_i):
        return _engine._extract_result(
            host, lane, spec, graphs[oi], rounds_i, 0.0,
            mode=cfg.mode, k=ks[oi], num_workers=cfg.num_workers,
            packed_status=cfg.packed_status,
        )

    def collect(lanes, which, spillers):
        host = _engine._fetch_batch_state(lanes.worker)
        rounds_h = lanes.rounds.cpu().numpy()
        for lane in which:
            oi = int(lanes.tag[lane])
            if oi not in results:
                results[oi] = extract(host, lane, oi, int(rounds_h[lane]))
                _patch_spill(results[oi], spillers[lane])

    def make_spillers(lanes, cap, arrays=None):
        """One spiller per lane of capacity ``cap`` (None each without
        spill), loaded from a checkpoint's ``spill{lane}`` arrays when
        ``arrays`` holds them."""
        if not cfg.frontier_spill:
            return [None] * lanes.num_lanes
        spillers = []
        for lane in range(lanes.num_lanes):
            sp = make_spiller(cfg, spec, graphs[int(lanes.tag[lane])], cap,
                              cfg.num_workers, injector)
            if arrays is not None and FrontierSpiller.present_in(arrays, f"spill{lane}"):
                sp.load_flat(arrays, f"spill{lane}")
            spillers.append(sp)
        return spillers

    def write_checkpoint(bi, lanes, datas, fpt_bounds, total_ran, spillers):
        ck = _ckpt.SolveCheckpoint(
            kind="many",
            problem=spec.name,
            config=cfg.replace(resume_from=None).to_dict(),
            fingerprint=fingerprint,
            rounds=total_ran,
            arrays=lane_state_to_flat(lanes),
            meta={
                "bucket_idx": bi,
                "total_ran": total_ran,
                "chunks_total": chunks_total,
                "compactions": compactions,
                "lane_stats": {
                    **{k: int(v) for k, v in lane_stats.items()},
                    "reduce_sweeps": counters.reduce_sweeps,
                },
                "results": {
                    str(i): _ckpt.engine_result_to_dict(r)
                    for i, r in results.items()
                },
            },
        )
        ck.arrays.update(_ckpt.data_to_flat(datas, "datas"))
        if fpt_bounds is not None:
            ck.arrays["fpt_bounds"] = fpt_bounds.cpu().numpy()
        for lane, sp in enumerate(spillers):
            if sp is not None:
                ck.arrays.update(sp.to_flat(f"spill{lane}"))
        ck.pack_graphs(range(B), graphs)
        ck.save(cfg.checkpoint_dir, chunks_total, retry=io_retry, fault_hook=io_hook)

    buckets = _engine._bucket_instances(graphs, by_n=(cfg.codec == "basic"))
    ordered = sorted(buckets.items(), key=lambda kv: (kv[0][0], kv[0][1] or 0))
    for bi, ((W, _), idxs) in enumerate(ordered):
        bucket_graphs = [graphs[i] for i in idxs]
        n_max = max(g.n for g in bucket_graphs)
        bucket_record.append((W, n_max, list(idxs)))
        if bi < resume_bucket:
            continue  # finalized before the checkpoint: restored above
        t0 = time.perf_counter()
        cap = cfg.capacity or (4 * n_max + 8 * cfg.lanes)
        pad = make_codec(cfg.codec, n_max, problem=spec).pad_words
        if bi == resume_bucket:
            lanes = lane_state_from_flat(resume_ck.arrays, device)
            datas = _ckpt.data_from_flat(resume_ck.arrays, "datas", device)
            fpt_bounds = None
            if use_fpt:
                fpt_bounds = torch.from_numpy(
                    np.asarray(resume_ck.arrays["fpt_bounds"], np.int32).copy()
                ).to(device)
            total_ran = int(resume_ck.meta["total_ran"])
            live_h = ~lanes.done.cpu().numpy()
            spillers = make_spillers(lanes, cap, resume_ck.arrays)
        else:
            initial_bests = [
                problems_base.initial_bound(spec, graphs[i], cfg.mode, ks[i])
                for i in idxs
            ]
            datas = problems_base.make_batch_data(spec, bucket_graphs, n_max, W, device)
            lanes = LaneState(
                worker=_engine._make_batch_state(
                    spec, bucket_graphs, cfg.num_workers, cap, W, initial_bests, device
                ),
                done=torch.zeros((len(idxs),), dtype=torch.bool, device=device),
                tag=np.asarray(idxs, np.int32),
                rounds=torch.zeros((len(idxs),), dtype=torch.int32, device=device),
            )
            fpt_bounds = None
            if use_fpt:
                fpt_bounds = torch.tensor(
                    [spec.fpt_target(ks[i]) for i in idxs], dtype=torch.int32,
                    device=device,
                )
            total_ran = 0
            live_h = np.ones(len(idxs), bool)  # live entering the next chunk
            spillers = make_spillers(lanes, cap)
        plane = cache.batch_plane(spec, cfg, pad, use_fpt)

        def note(n_lanes):
            cache.note("batch", spec, cfg, pad, use_fpt,
                       (n_max, W, cap, cfg.num_workers, n_lanes))

        note(lanes.num_lanes)
        while total_ran < cfg.max_rounds:
            lane_stats["chunk_calls"] += 1
            lane_stats["lane_chunks"] += lanes.num_lanes
            lane_stats["live_lane_chunks"] += int(live_h.sum())
            lanes, ran, hot = step_lanes(plane, datas, lanes, fpt_bounds, counters)
            total_ran += ran
            chunks_total += 1
            done_h = lanes.done.cpu().numpy()
            if cfg.frontier_spill:
                pump_lanes(lanes, spillers, done_h, hot, fpt_bounds)
            if injector is not None:
                injector.step_boundary()
                live = [lane for lane in range(lanes.num_lanes) if not done_h[lane]]
                for lane in injector.take_crashes(live):
                    # the lane's occupant died with its state; the center
                    # still knows which instance it held (its tag), so it is
                    # re-admitted from its startup placement, before
                    # compaction can collect the dead state as a result
                    oi = int(lanes.tag[lane])
                    worker = _engine.make_instance_state(
                        spec, graphs[oi], cfg.num_workers, cap, W,
                        problems_base.initial_bound(spec, graphs[oi], cfg.mode, ks[oi]),
                        device,
                    )
                    lane_swap_in(lanes, lane, worker, oi)
                    done_h[lane] = False
                    if cfg.frontier_spill:
                        spillers[lane] = make_spiller(cfg, spec, graphs[oi], cap,
                                                      cfg.num_workers, injector)
                    injector.note_recovered("crash")
            live_h = ~done_h
            if done_h.all():
                break
            n_live = int(live_h.sum())
            target = _engine._pow2_at_least(n_live)
            if (
                cfg.compact_threshold > 0
                and n_live <= cfg.compact_threshold * lanes.num_lanes
                and target < lanes.num_lanes
            ):
                # collect finished lanes now, keep the live ones plus
                # finished fillers up to the pow2 target, and reslice
                fillers = np.flatnonzero(done_h)[: target - n_live]
                collect(lanes, [i for i in np.flatnonzero(done_h) if i not in fillers],
                        spillers)
                sel = np.concatenate([np.flatnonzero(live_h), fillers])
                lanes = slice_lanes(lanes, sel)
                datas = problems_base.slice_instances(datas, sel)
                spillers = [spillers[i] for i in sel]
                if fpt_bounds is not None:
                    fpt_bounds = fpt_bounds[torch.from_numpy(sel).to(device)]
                live_h = live_h[sel]
                compactions += 1
                note(lanes.num_lanes)
            if cfg.checkpoint_dir is not None and chunks_total % cfg.checkpoint_every == 0:
                write_checkpoint(bi, lanes, datas, fpt_bounds, total_ran, spillers)
                checkpoints_written += 1

        collect(lanes, range(lanes.num_lanes), spillers)
        bucket_wall = time.perf_counter() - t0
        wall_total += bucket_wall
        for oi in idxs:
            results[oi].wall_s = bucket_wall / len(idxs)

    lane_stats["occupancy"] = (
        lane_stats["live_lane_chunks"] / lane_stats["lane_chunks"]
        if lane_stats["lane_chunks"]
        else 0.0
    )
    lane_stats["reduce_sweeps"] = counters.reduce_sweeps
    for r in results.values():
        r.checkpoints_written = checkpoints_written
        r.resumed_from = cfg.resume_from
    return _engine.BatchResult(
        results=[results[i] for i in range(B)],
        wall_s=wall_total,
        buckets=bucket_record,
        compactions=compactions,
        lane_stats=lane_stats,
    )


# -- the Backend protocol ------------------------------------------------------


class Backend:
    """One engine behind the session façade.

    ``solve``/``solve_many`` take the resolved problem spec, the validated
    config, the session's plane cache and the device, and return the
    unified schema.  The default ``solve_many`` loops ``solve`` per
    instance (honouring per-instance ``k`` tuples); backends with a real
    batch plane override it."""

    name: str = "?"

    def solve(self, spec, g, cfg: SolveConfig, cache: PlaneCache, *,
              device) -> SolveResult:
        raise NotImplementedError

    def solve_many(self, spec, graphs, cfg: SolveConfig, cache: PlaneCache, *,
                   device) -> BatchSolveResult:
        graphs = list(graphs)
        ks = list(cfg.k) if isinstance(cfg.k, tuple) else [cfg.k] * len(graphs)
        if len(ks) != len(graphs):
            raise ValueError("per-instance k needs one entry per graph")
        out = [
            self.solve(spec, g, cfg.replace(k=kk), cache, device=device)
            for g, kk in zip(graphs, ks)
        ]
        return BatchSolveResult(
            problem=spec.name,
            backend=self.name,
            results=out,
            wall_s=sum(r.wall_s for r in out),
        )


class SpmdBackend(Backend):
    name = "spmd"

    def solve(self, spec, g, cfg, cache, *, device, initial_state=None,
              mesh=None, injector=None):
        r = solve_spmd(spec, g, cfg, cache, device=device,
                       initial_state=initial_state, mesh=mesh, injector=injector)
        return from_engine_result(r, problem=spec.name, backend=self.name)

    def solve_many(self, spec, graphs, cfg, cache, *, device, injector=None):
        br = solve_many_spmd(spec, graphs, cfg, cache, device=device,
                             injector=injector)
        return BatchSolveResult(
            problem=spec.name,
            backend=self.name,
            results=[
                from_engine_result(r, problem=spec.name, backend=self.name)
                for r in br.results
            ],
            wall_s=br.wall_s,
            buckets=br.buckets,
            compactions=br.compactions,
            lane_stats=LaneStats(**br.lane_stats),
        )


class ProtocolSimBackend(Backend):
    """The asynchronous protocol simulator (host; ``device`` is unused)."""

    name = "protocol_sim"

    def solve(self, spec, g, cfg, cache, *, device):
        from repro_torch.core.protocol_sim import run_protocol_sim

        t0 = time.perf_counter()
        r = run_protocol_sim(
            g,
            num_workers=cfg.num_workers,
            latency=cfg.latency,
            policy=cfg.policy,
            codec_name=cfg.codec,
            mode=cfg.mode,
            k=cfg.solo_k(),
            send_metadata=cfg.send_metadata,
            max_ticks=cfg.max_ticks,
            seed=cfg.seed,
            problem=spec,
        )
        wall = time.perf_counter() - t0
        return from_sim_result(r, problem=spec.name, backend=self.name, wall_s=wall)


class CentralizedBackend(Backend):
    """The fully-centralized baseline simulator (host; ``device`` is
    unused)."""

    name = "centralized"

    def solve(self, spec, g, cfg, cache, *, device):
        from repro_torch.core.centralized import run_centralized_sim

        t0 = time.perf_counter()
        r = run_centralized_sim(
            g,
            num_workers=cfg.num_workers,
            latency=cfg.latency,
            codec_name=cfg.codec,
            queue_cap_per_p=cfg.queue_cap_per_p,
            use_priority_queue=cfg.use_priority_queue,
            max_ticks=cfg.max_ticks,
            mode=cfg.mode,
            k=cfg.solo_k(),
            problem=spec,
        )
        wall = time.perf_counter() - t0
        return from_sim_result(r, problem=spec.name, backend=self.name, wall_s=wall)


class SequentialBackend(Backend):
    """The problem's host reference solver (numpy; ``device`` is unused)."""

    name = "sequential"

    def solve(self, spec, g, cfg, cache, *, device):
        if spec.sequential is None:
            raise ValueError(f"problem {spec.name!r} has no sequential reference")
        t0 = time.perf_counter()
        best, sol, stats = spec.sequential(g, mode=cfg.mode, k=cfg.solo_k())
        wall = time.perf_counter() - t0
        return from_sequential(best, sol, stats, problem=spec.name, wall_s=wall)


BACKENDS = {
    b.name: b
    for b in (
        SpmdBackend(),
        ProtocolSimBackend(),
        CentralizedBackend(),
        SequentialBackend(),
    )
}

BACKEND_ALIASES = {
    "protocol": "protocol_sim",
    "central": "centralized",
    "centralised": "centralized",
    "seq": "sequential",
}


def known_backends() -> list:
    return sorted(BACKENDS)


def get_backend(name) -> Backend:
    """Resolve a backend by name (or pass an instance through)."""
    if isinstance(name, Backend):
        return name
    key = BACKEND_ALIASES.get(name, name)
    if key not in BACKENDS:
        raise ValueError(
            f"unknown backend {name!r}; known backends: "
            f"{', '.join(known_backends())} "
            f"(aliases: {', '.join(sorted(BACKEND_ALIASES))})"
        )
    return BACKENDS[key]


# -- legacy engine shim plumbing -----------------------------------------------

#: one process-wide cache for the deprecated ``engine.solve``/``solve_many``
#: shims: legacy callers pool their planes too
LEGACY_CACHE = PlaneCache()


def config_from_legacy(policy_priority: bool = True, **kw) -> SolveConfig:
    """Map the legacy kwargs surface (the ``policy_priority`` bool of the
    goldens' ``solve_kw``) onto :class:`SolveConfig`."""
    return SolveConfig(
        policy=("priority" if policy_priority else "random"), **kw
    )
