"""Hierarchical frontier memory: device-hot tier + compressed host cold tier.

The port of ``repro/core/spill.py``.  The device frontier
(:mod:`repro_torch.core.frontier`) is a fixed-capacity pool, so a search
whose peak frontier exceeds it drops tasks (counted in ``overflow_count``,
but dropped).  This module makes that pool the **hot tier** of a two-level
memory:

* a **high-water mark**: when a host sync finds a worker's pool above it,
  the shallowest pending tasks (the paper's donation priority, Alg. 6) are
  evicted, encoded with the §4.3 codec and appended to a per-(worker,
  depth-band) host store;
* a **low-water mark**: when a worker's pool drains below it, cold records
  are decoded and re-admitted — the worker's own bands first, then from the
  globally shallowest band, scanning donors in the Algorithm-7 waiting-list
  order (:func:`repro_torch.core.waiting_list.startup_assignment`).

Everything here runs on the host between device chunks (plain numpy), so
spilled solves are deterministic run to run and the whole cold tier
serializes into a :class:`~repro_torch.checkpoint.solve.SolveCheckpoint` as
a handful of named arrays, the JAX package's layout, so a checkpoint of
either package resumes in the other.

The **no-drop guarantee**: :func:`resolve_watermarks` refuses any watermark
placement that leaves less headroom above the high mark than one chunk can
generate — per superstep a worker nets at most ``steps_per_round·lanes``
new tasks from exploration plus ``donate_k`` received donations (plus a
transient ``lanes`` during the pop/push cycle), so capping the high mark at
``capacity - chunk_rounds·(steps_per_round·lanes + donate_k) - lanes``
means the hot tier cannot overflow between two pump points.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.encoding import Task, checked_record, strip_record, verify_record
from repro_torch.core.waiting_list import startup_assignment

# depth-band granularity of the cold tier: records are stored FIFO inside a
# band and re-admitted shallowest band first, so the cold tier keeps the
# engine's quasi-horizontal priority without a global sorted order
BAND_WIDTH = 8


def chunk_headroom(
    *, chunk_rounds: int, steps_per_round: int, lanes: int, donate_k: int
) -> int:
    """Worst-case growth of ONE worker's pool between two host syncs.

    Each superstep nets at most ``steps_per_round * lanes`` tasks from
    exploration (every popped lane pushes back two children) plus
    ``donate_k`` received donations; the trailing ``+ lanes`` covers the
    transient inside a round where children are pushed before the popped
    parents' slots are reused.
    """
    return chunk_rounds * (steps_per_round * lanes + donate_k) + lanes


def resolve_watermarks(
    capacity: int,
    watermarks,
    *,
    chunk_rounds: int,
    steps_per_round: int,
    lanes: int,
    donate_k: int,
) -> tuple:
    """Turn fractional ``(low, high)`` watermarks into slot counts.

    The high mark is capped at ``capacity - headroom`` so one chunk's growth
    can never overflow the hot tier (the no-drop guarantee); a capacity too
    small to leave >= 2 slots under that cap is a config error, reported
    with the arithmetic spelled out.
    """
    low_frac, high_frac = watermarks
    head = chunk_headroom(
        chunk_rounds=chunk_rounds,
        steps_per_round=steps_per_round,
        lanes=lanes,
        donate_k=donate_k,
    )
    high = min(int(high_frac * capacity), capacity - head)
    if high < 2:
        raise ValueError(
            f"frontier_spill needs hot capacity above the per-chunk growth "
            f"headroom: capacity={capacity} minus headroom={head} "
            f"(chunk_rounds*(steps_per_round*lanes + donate_k) + lanes = "
            f"{chunk_rounds}*({steps_per_round}*{lanes} + {donate_k}) + "
            f"{lanes}) leaves a high-water mark of {high} slots — raise "
            f"capacity or lower chunk_rounds/steps_per_round"
        )
    low = max(1, min(int(low_frac * capacity), high - 1))
    return low, high


class FrontierSpiller:
    """One instance's cold tier plus the host-side spill/refill pump.

    Owns per-(worker, depth-band) FIFO stores of codec-encoded task records
    and the two watermarks; :meth:`pump_host` is the numpy core (spill above
    high, refill below low), :meth:`pump_frontier` / :meth:`pump_lane` are
    the device-boundary wrappers of the solo and batched drivers.  The pump
    order is a fixed function of the pool contents, so spilled solves
    replay exactly, across a checkpoint/resume cut too (:meth:`to_flat` /
    :meth:`load_flat`).
    """

    def __init__(
        self,
        codec,
        num_workers: int,
        capacity: int,
        watermarks,
        *,
        chunk_rounds: int,
        steps_per_round: int,
        lanes: int,
        donate_k: int,
        graph=None,
        injector=None,
    ):
        self.codec = codec
        self.injector = injector
        self.delivery_retries = 0
        self.num_workers = num_workers
        self.low, self.high = resolve_watermarks(
            capacity,
            watermarks,
            chunk_rounds=chunk_rounds,
            steps_per_round=steps_per_round,
            lanes=lanes,
            donate_k=donate_k,
        )
        if getattr(codec, "name", "") == "basic":
            if graph is None:
                raise ValueError(
                    "spill_codec='basic' encodes the induced subgraph, so "
                    "the spiller needs the instance graph"
                )
            self._encode = lambda task: codec.encode(task, graph)
        else:
            self._encode = codec.encode
        self._graph = graph
        # Algorithm-7 startup permutation, 0-based: refill scan order
        self.order = tuple(o - 1 for o in startup_assignment(2, num_workers))
        self._bands = [dict() for _ in range(num_workers)]
        self.spilled_total = 0
        self.readmitted_total = 0
        self.cold_tasks = 0
        self.cold_bytes_peak = 0

    @property
    def cold_bytes(self) -> int:
        return self.cold_tasks * self.codec.record_bytes

    # -- cold-tier store -------------------------------------------------------
    #
    # Records are stored CHECKED (codec payload + trailing CRC32 word, see
    # core/encoding.py) and every host-memory hand-off — the write into the
    # cold tier and the pop back toward the hot frontier — goes through
    # :meth:`_deliver`, where a fault injector may corrupt the delivery copy:
    # the checksum catches it and the intact source record is redelivered.

    def _deliver(self, kind: str, rec: np.ndarray) -> np.ndarray:
        """One checked-record hand-off, with optional fault injection.

        The injector (if any) may corrupt the delivery COPY; verification
        catches it and the intact source record is redelivered (booked as
        one recovery + one retry)."""
        if self.injector is None:
            return rec
        delivered, injected = self.injector.corrupt(kind, rec)
        if injected and not verify_record(delivered):
            self.injector.note_recovered(kind)
            self.injector.note_retry()
            self.delivery_retries += 1
            return rec
        return delivered

    def _push_cold(self, w: int, mask, sol, depth: int) -> None:
        rec = checked_record(
            self._encode(
                Task(
                    mask=np.asarray(mask, np.uint32),
                    sol_mask=np.asarray(sol, np.uint32),
                    depth=int(depth),
                )
            )
        )
        rec = self._deliver("cold_corrupt", rec)
        self._bands[w].setdefault(int(depth) // BAND_WIDTH, []).append(rec)
        self.spilled_total += 1
        self.cold_tasks += 1
        self.cold_bytes_peak = max(self.cold_bytes_peak, self.cold_bytes)

    def _pop_band(self, w: int, band: int) -> np.ndarray:
        fifo = self._bands[w][band]
        rec = self._deliver("transfer_corrupt", fifo[0])
        fifo.pop(0)
        if not fifo:
            del self._bands[w][band]
        self.cold_tasks -= 1
        self.readmitted_total += 1
        return rec

    def _pop_cold(self, w: int):
        """Shallowest record for worker ``w``: its own store first, else
        from the globally shallowest band (donors in Alg-7 order).  Returns
        a decoded :class:`Task`, or None when the tier is empty."""
        if self._bands[w]:
            rec = self._pop_band(w, min(self._bands[w]))
        elif self.cold_tasks:
            best = min(min(b) for b in self._bands if b)
            donor = next(d for d in self.order if self._bands[d].get(best))
            rec = self._pop_band(donor, best)
        else:
            return None
        return self.codec.decode(strip_record(rec), self._graph)

    # -- the pump --------------------------------------------------------------

    def wants_pump(self, hot, done: bool) -> bool:
        """Cheap trigger check from the chunk's per-worker hot counts: any
        worker above high, or cold records waiting while any worker is below
        low (or the plane went quiescent)."""
        hot = np.asarray(hot)
        if (hot > self.high).any():
            return True
        return bool(self.cold_tasks) and (done or bool((hot < self.low).any()))

    def pump_host(self, masks, sols, depths, active) -> bool:
        """Spill/refill pass over one instance's (P, CAP, ...) host pool.

        Mutates the arrays in place; returns True if anything moved.
        Eviction order is (depth asc, slot asc) — the donation priority, by
        numpy's stable sort; refill scans workers in Algorithm-7 order and
        places into the lowest free slot, so the pass is a deterministic
        function of the pool contents.
        """
        counts = active.sum(axis=1).astype(np.int64)
        moved = False
        for w in range(self.num_workers):
            if counts[w] > self.high:
                slots = np.flatnonzero(active[w])
                order = slots[np.argsort(depths[w][slots], kind="stable")]
                for s in order[: counts[w] - self.low]:
                    self._push_cold(w, masks[w, s], sols[w, s], depths[w, s])
                    active[w, s] = False
                counts[w] = self.low
                moved = True
        if self.cold_tasks:
            for w in self.order:
                while counts[w] < self.low and self.cold_tasks:
                    task = self._pop_cold(w)
                    slot = int(np.argmax(~active[w]))
                    masks[w, slot] = task.mask
                    sols[w, slot] = task.sol_mask
                    depths[w, slot] = task.depth
                    active[w, slot] = True
                    counts[w] += 1
                    moved = True
        return moved

    def pump_frontier(self, frontier):
        """Pump a solo (P, CAP, ...) device frontier, written back in place.

        Returns ``(frontier, hot)`` with the post-pump (P,) host pending
        counts — the driver clears its quiescence flag iff any survive."""
        from repro_torch.core.frontier import read_pool, write_pool

        m, s, d, a = read_pool(frontier)
        if self.pump_host(m, s, d, a):
            write_pool(frontier, m, s, d, a)
        return frontier, a.sum(axis=1).astype(np.int64)

    def pump_lane(self, lanes, lane: int):
        """Pump ONE lane of a live (B, P, CAP, ...) plane, written back in
        place.  Returns ``(lanes, hot)`` like :meth:`pump_frontier`."""
        from repro_torch.core.frontier import read_lane_pool, write_lane_pool

        f = lanes.worker.frontier
        m, s, d, a = read_lane_pool(f, lane)
        if self.pump_host(m, s, d, a):
            write_lane_pool(f, lane, m, s, d, a)
        return lanes, a.sum(axis=1).astype(np.int64)

    # -- checkpoint (de)serialization ------------------------------------------

    def to_flat(self, prefix: str = "spill") -> dict:
        """The cold tier as named uint32/int64 arrays (checkpoint leaves):
        one ``(N_w, record_words + 1)`` block per worker (records travel
        CHECKED — payload plus CRC32 word), band-major FIFO order, plus a
        counters vector ``[spilled, readmitted, cold_bytes_peak]``."""
        flat = {}
        rw = self.codec.record_words + 1
        for w in range(self.num_workers):
            recs = [
                rec
                for band in sorted(self._bands[w])
                for rec in self._bands[w][band]
            ]
            flat[f"{prefix}.w{w}"] = (
                np.stack(recs).astype(np.uint32)
                if recs
                else np.zeros((0, rw), np.uint32)
            )
        flat[f"{prefix}.counters"] = np.array(
            [self.spilled_total, self.readmitted_total, self.cold_bytes_peak],
            np.int64,
        )
        return flat

    @staticmethod
    def present_in(flat: dict, prefix: str = "spill") -> bool:
        return f"{prefix}.counters" in flat

    def load_flat(self, flat: dict, prefix: str = "spill") -> None:
        """Rebuild the cold tier from :meth:`to_flat` arrays (either
        package's).  Records are re-banded by their decoded depth; band-major
        FIFO storage order makes the rebuild exact, so a resumed solve
        replays exactly.

        Each record's CRC32 word is re-verified on load (raising
        :class:`~repro_torch.core.encoding.PayloadCorruptionError` on rot);
        bare pre-checksum blocks are accepted and upgraded."""
        counters = np.asarray(flat[f"{prefix}.counters"])
        self.spilled_total = int(counters[0])
        self.readmitted_total = int(counters[1])
        self.cold_bytes_peak = int(counters[2])
        self._bands = [dict() for _ in range(self.num_workers)]
        self.cold_tasks = 0
        rw = self.codec.record_words
        for w in range(self.num_workers):
            for rec in np.asarray(flat[f"{prefix}.w{w}"], np.uint32):
                if rec.size == rw:  # legacy bare record
                    rec = checked_record(rec)
                depth = self.codec.decode(strip_record(rec), self._graph).depth
                self._bands[w].setdefault(depth // BAND_WIDTH, []).append(rec)
                self.cold_tasks += 1


def make_spiller(cfg, problem, graph, capacity: int, num_workers: int,
                 injector=None):
    """Build a :class:`FrontierSpiller` from a SolveConfig — the one shared
    constructor of the solo, batched and service drivers, which must agree
    on the eviction/re-admission contract."""
    from repro_torch.core.encoding import make_codec

    codec = make_codec(cfg.spill_codec, graph.n, problem=problem)
    return FrontierSpiller(
        codec,
        num_workers,
        capacity,
        cfg.spill_watermarks,
        chunk_rounds=cfg.chunk_rounds,
        steps_per_round=cfg.steps_per_round,
        lanes=cfg.lanes,
        donate_k=cfg.donate_k,
        graph=graph,
        injector=injector,
    )


def pump_lanes(lanes, spillers, done_h, hot, fpt_bounds=None, frozen=()) -> None:
    """The per-lane spill pump of a batched plane after a chunk — the one
    shared by ``solve_many`` and the live service.  ``spillers[b]`` is lane
    b's spiller (None: no pump); ``done_h`` the (B,) host done flags,
    ``hot`` the chunk's (B, P) pending counts, ``fpt_bounds`` the (B,) FPT
    targets (None outside FPT).  A lane in ``frozen`` (the service's lanes
    stalled this chunk and written back) is not pumped: its hot counts are
    stale.  A lane whose FPT bound was hit is finished whatever its backlog;
    a done lane that the pump refilled is resumed in place
    (:func:`~repro_torch.core.superstep.lane_resume`) and in ``done_h``."""
    from repro_torch.core.superstep import lane_resume

    hot_h = hot.cpu().numpy()
    best_h = bounds_h = None
    for lane, sp in enumerate(spillers):
        if sp is None or lane in frozen:
            continue
        if not sp.wants_pump(hot_h[lane], bool(done_h[lane])):
            continue
        if bool(done_h[lane]) and fpt_bounds is not None:
            if best_h is None:
                best_h = lanes.worker.best_val[:, 0].cpu().numpy()
                bounds_h = fpt_bounds.cpu().numpy()
            if int(best_h[lane]) <= int(bounds_h[lane]):
                continue  # FPT bound hit: finished for real
        _, hot_lane = sp.pump_lane(lanes, lane)
        if bool(done_h[lane]) and int(hot_lane.sum()) > 0:
            lane_resume(lanes, lane)
            done_h[lane] = False
