"""The port's backends: the spmd solve planes and the sequential reference.

The port of ``repro/api/backends.py``'s ``solve_spmd``, ``solve_many_spmd``
and its ``Backend`` registry.  The spmd drivers are the JAX package's loops:
startup scatter, then chunks of up to ``chunk_rounds`` supersteps until
quiescence (or the FPT bound) or ``max_rounds``, then one host fetch; the
batched driver adds bucketing by W, pow2 compaction and eager per-lane
result extraction.  Both take their plane from a :class:`PlaneCache`, and
both are durable: ``checkpoint_dir`` writes a
:class:`~repro_torch.checkpoint.solve.SolveCheckpoint` every
``checkpoint_every`` chunks at the host-sync boundary, and ``resume_from``
continues from one (either package's) to the result of a run that never
stopped.

Features of the JAX drivers that the port does not carry yet are refused
with ``NotImplementedError`` naming their ROADMAP item; none is silently
ignored.
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
)
from repro_torch.checkpoint import solve as _ckpt
from repro_torch.core import engine as _engine
from repro_torch.core.encoding import make_codec
from repro_torch.core.superstep import (
    LaneState,
    lane_state_from_flat,
    lane_state_to_flat,
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
    "frontier_spill": "queue 1, item 10 (codecs + frontier spill)",
    "spill state in a checkpoint": "queue 1, item 10 (codecs + frontier spill)",
    "use_mesh": "queue 1, item 13 (multi-device path)",
    "mesh": "queue 1, item 13 (multi-device path)",
    "injector": "queue 1, item 11 (fault wiring)",
}


def _refuse(what: str) -> None:
    raise NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP {_NOT_PORTED[what]})"
    )


def _refuse_unported(cfg: SolveConfig, injector) -> None:
    if cfg.frontier_spill:
        _refuse("frontier_spill")
    if injector is not None:
        _refuse("injector")


def _refuse_spill_arrays(arrays: dict) -> None:
    """A checkpoint holding a frontier spiller's cold tier (the JAX
    package's ``spill…`` arrays) cannot resume here without dropping it."""
    if any(name.rsplit("/", 1)[-1].startswith("spill") for name in arrays):
        _refuse("spill state in a checkpoint")


def _load_resume(cfg: SolveConfig, kind: str, fingerprint: str, verb: str,
                 problem: str):
    """The newest intact ``kind`` checkpoint under ``cfg.resume_from`` whose
    fingerprint is ``fingerprint`` (falling back past corrupt generations
    with a warning), for the solve loop ``verb``."""
    ck = _ckpt.SolveCheckpoint.load_latest_good(
        cfg.resume_from, expected_fingerprint=fingerprint,
        what=f"{verb}({problem})",
    )
    if ck.kind != kind:
        raise _ckpt.CheckpointError(
            f"{cfg.resume_from} holds a {ck.kind!r} checkpoint; "
            f"{verb}() resumes {kind!r} checkpoints only"
        )
    _refuse_spill_arrays(ck.arrays)
    return ck


def _write_solo_checkpoint(spec, g, cfg, fingerprint, state, rounds,
                           reduce_sweeps) -> None:
    """One atomic SolveCheckpoint of a solo solve at a chunk boundary; the
    port's running ``reduce_sweeps`` rides in its meta."""
    ck = _ckpt.SolveCheckpoint(
        kind="solo",
        problem=spec.name,
        config=cfg.replace(resume_from=None).to_dict(),
        fingerprint=fingerprint,
        rounds=rounds,
        arrays=worker_state_to_flat(state),
        meta={"reduce_sweeps": reduce_sweeps},
    )
    ck.pack_graphs([0], [g])
    ck.save(cfg.checkpoint_dir, rounds)


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
    checkpoint has none, so there it counts from the resume."""
    _refuse_unported(cfg, injector)
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
    fingerprint = None
    if cfg.checkpoint_dir is not None or cfg.resume_from is not None:
        fingerprint = _ckpt.config_fingerprint(
            "solo", spec.name, cfg, [_ckpt.graph_digest(g)]
        )

    data = problems_base.make_data(spec, g, device)
    rounds = 0
    if cfg.resume_from is not None:
        if initial_state is not None:
            raise ValueError("pass resume_from or initial_state, not both")
        ck = _load_resume(cfg, "solo", fingerprint, "solve", spec.name)
        state = worker_state_from_flat(ck.arrays, device)
        rounds = ck.rounds
        counters.reduce_sweeps = int(ck.meta.get("reduce_sweeps", 0))
        cap = int(state.frontier.masks.shape[-2])
    elif initial_state is None:
        cap = cfg.capacity or (4 * g.n + 8 * cfg.lanes)
        state = _engine.make_instance_state(
            spec, g, cfg.num_workers, cap, W, initial_best, device
        )
    else:
        state = state_to(initial_state, device)
        cap = int(state.frontier.masks.shape[-2])
    plane = cache.solo_plane(spec, cfg, pad, use_fpt)
    cache.note("solo", spec, cfg, pad, use_fpt, (g.n, W, cap, cfg.num_workers))

    t0 = time.perf_counter()
    chunks = 0
    checkpoints_written = 0
    while rounds < cfg.max_rounds:
        state, done, ran, _ = plane(data, state, fpt_bound, counters)
        rounds += ran
        chunks += 1
        if done:
            break
        if cfg.checkpoint_dir is not None and chunks % cfg.checkpoint_every == 0:
            _write_solo_checkpoint(spec, g, cfg, fingerprint, state, rounds,
                                   counters.reduce_sweeps)
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
    return r


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
    bit-identity contract."""
    _refuse_unported(cfg, injector)
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

    fingerprint = None
    if cfg.checkpoint_dir is not None or cfg.resume_from is not None:
        fingerprint = _ckpt.config_fingerprint(
            "many", spec.name, cfg, [_ckpt.graph_digest(g) for g in graphs]
        )
    resume_ck = None
    resume_bucket = -1
    if cfg.resume_from is not None:
        resume_ck = _load_resume(cfg, "many", fingerprint, "solve_many", spec.name)
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

    def collect(lanes, which):
        host = _engine._fetch_batch_state(lanes.worker)
        rounds_h = lanes.rounds.cpu().numpy()
        for lane in which:
            oi = int(lanes.tag[lane])
            if oi not in results:
                results[oi] = extract(host, lane, oi, int(rounds_h[lane]))

    def write_checkpoint(bi, lanes, datas, fpt_bounds, total_ran):
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
        ck.pack_graphs(range(B), graphs)
        ck.save(cfg.checkpoint_dir, chunks_total)

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
        plane = cache.batch_plane(spec, cfg, pad, use_fpt)

        def note(n_lanes):
            cache.note("batch", spec, cfg, pad, use_fpt,
                       (n_max, W, cap, cfg.num_workers, n_lanes))

        note(lanes.num_lanes)
        while total_ran < cfg.max_rounds:
            lane_stats["chunk_calls"] += 1
            lane_stats["lane_chunks"] += lanes.num_lanes
            lane_stats["live_lane_chunks"] += int(live_h.sum())
            lanes, ran, _ = step_lanes(plane, datas, lanes, fpt_bounds, counters)
            total_ran += ran
            chunks_total += 1
            done_h = lanes.done.cpu().numpy()
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
                collect(lanes, [i for i in np.flatnonzero(done_h) if i not in fillers])
                sel = np.concatenate([np.flatnonzero(live_h), fillers])
                lanes = slice_lanes(lanes, sel)
                datas = problems_base.slice_instances(datas, sel)
                if fpt_bounds is not None:
                    fpt_bounds = fpt_bounds[torch.from_numpy(sel).to(device)]
                live_h = live_h[sel]
                compactions += 1
                note(lanes.num_lanes)
            if cfg.checkpoint_dir is not None and chunks_total % cfg.checkpoint_every == 0:
                write_checkpoint(bi, lanes, datas, fpt_bounds, total_ran)
                checkpoints_written += 1

        collect(lanes, range(lanes.num_lanes))
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


def config_from_legacy(policy_priority: bool = True, **kw) -> SolveConfig:
    """Map the legacy kwargs surface (the ``policy_priority`` bool of the
    goldens' ``solve_kw``) onto :class:`SolveConfig`."""
    return SolveConfig(
        policy=("priority" if policy_priority else "random"), **kw
    )
