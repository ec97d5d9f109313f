"""The runtime half of fault injection: fire a :class:`FaultPlan` at the
host-sync boundaries of a live solve, and account for every recovery.

The port of ``repro/faults/injector.py``, with the same generators, so the
same plan flips the same bit of the same record word and advances the same
virtual ``clock_s`` in both packages.

The injector is a small host-side state machine threaded (optionally)
through ``solve_spmd`` / ``solve_many_spmd`` / :class:`SolveService` /
:class:`FrontierSpiller` / the checkpoint store.  It never touches device
code: every hook sits at a chunk boundary or inside a host-side
encode/deliver/IO call, so the plane launches the same kernels with or
without an injector, and a run with ``injector=None`` is the plain run.

Determinism: the injector is clocked by ``step_boundary()`` (one tick per
host sync), corruption targets are drawn from a generator seeded off the
plan, and backoff "sleeps" advance a virtual ``clock_s`` instead of the
wall — so the full injected-fault/recovery trajectory is reproducible
cross-machine and ``faults_injected`` / ``faults_recovered`` /
``retries`` can be pinned exactly (the JAX package's chaos pins hold in
this one too).

Accounting contract (summed into ``ServiceStats`` / chaos gates):

- ``injected[kind]``  incremented the moment a fault actually fires
- ``recovered[kind]`` incremented when its recovery action lands: a
  crashed/stalled lane re-admitted, a corrupt payload redelivered from
  the intact source, a failed checkpoint I/O retried to success, a stall
  window that drains without harm
- ``retries``         every extra delivery/IO attempt recovery needed
"""

from __future__ import annotations

import random

import numpy as np

from repro_torch.faults.plan import FAULT_KINDS, FaultPlan


class FaultInjector:
    """Fires a :class:`FaultPlan` against a live solve and keeps the
    injected/recovered/retries ledgers.  One injector per solve run; all
    tiers (backend loop, service, spillers, checkpoint store) share it so
    the boundary clock is global."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._pending = list(plan.events)        # sorted by (at, kind, lane)
        self._rng = np.random.default_rng([plan.seed & 0x7FFFFFFF, 0xFA017])
        self._backoff_rng = random.Random(plan.seed)
        self.t = 0                               # chunk-boundary clock
        self.clock_s = 0.0                       # virtual backoff clock
        self.injected = {k: 0 for k in FAULT_KINDS}
        self.recovered = {k: 0 for k in FAULT_KINDS}
        self.retries = 0
        self._active_stalls = []                 # [lane, expires_at] pairs
        self._io_owed = {"write": 0, "read": 0}  # failed attempts awaiting
                                                 # a successful retry

    # -- clocking ---------------------------------------------------------

    def step_boundary(self) -> None:
        """One host-sync boundary elapsed (call once per chunk)."""
        self.t += 1

    # -- ledgers ----------------------------------------------------------

    @property
    def faults_injected(self) -> int:
        return sum(self.injected.values())

    @property
    def faults_recovered(self) -> int:
        return sum(self.recovered.values())

    def note_recovered(self, kind: str, n: int = 1) -> None:
        self.recovered[kind] += n

    def note_retry(self, n: int = 1) -> None:
        self.retries += n

    def report(self) -> dict:
        return dict(
            boundaries=self.t,
            injected=dict(self.injected),
            recovered=dict(self.recovered),
            retries=self.retries,
            backoff_s=round(self.clock_s, 6),
            pending=len(self._pending),
        )

    def _due(self, kind: str, match=None):
        """Pop the first pending event of ``kind`` whose boundary has
        arrived (and that ``match`` accepts), or None."""
        for i, ev in enumerate(self._pending):
            if ev.kind == kind and ev.at <= self.t and (
                match is None or match(ev)
            ):
                return self._pending.pop(i)
        return None

    # -- crash ------------------------------------------------------------

    def take_crash(self) -> bool:
        """Solo-plane crash: did the (single) worker state die at this
        boundary?  Consumes at most one due crash event per call."""
        if self._due("crash") is None:
            return False
        self.injected["crash"] += 1
        return True

    def take_crashes(self, live_lanes) -> list:
        """Batched/service planes: which of ``live_lanes`` die at this
        boundary?  Each due crash event is mapped onto a concrete lane
        modulo the live list (events wait if no lane is live)."""
        targets = []
        live_lanes = list(live_lanes)
        while live_lanes:
            ev = self._due("crash")
            if ev is None:
                break
            lane = live_lanes[ev.lane % len(live_lanes)]
            self.injected["crash"] += 1
            if lane not in targets:
                targets.append(lane)
        return targets

    # -- stall ------------------------------------------------------------

    def stalled_lanes(self, live_lanes) -> set:
        """Lanes frozen at this boundary.  Due stall events bind to a
        concrete live lane and stay active for ``duration`` boundaries;
        a window that drains without the watchdog firing counts as
        recovered (the lane resumed by itself)."""
        live_lanes = list(live_lanes)
        if live_lanes:
            while True:
                ev = self._due("stall")
                if ev is None:
                    break
                lane = live_lanes[ev.lane % len(live_lanes)]
                self.injected["stall"] += 1
                self._active_stalls.append([lane, self.t + ev.duration])
        out = set()
        kept = []
        for lane, until in self._active_stalls:
            if self.t >= until or lane not in live_lanes:
                # window drained (or the lane was already retired/
                # quarantined under it) — the system is healthy again
                self.recovered["stall"] += 1
            else:
                out.add(lane)
                kept.append([lane, until])
        self._active_stalls = kept
        return out

    def clear_stall(self, lane: int) -> int:
        """The watchdog quarantined ``lane``: its active stall windows are
        resolved (recovery = quarantine + re-admission).  Returns how many
        windows were cleared (0 = the stall was organic, not injected)."""
        kept = []
        cleared = 0
        for entry in self._active_stalls:
            if entry[0] == lane:
                self.recovered["stall"] += 1
                cleared += 1
            else:
                kept.append(entry)
        self._active_stalls = kept
        return cleared

    # -- payload corruption ----------------------------------------------

    def corrupt(self, kind: str, rec):
        """Maybe corrupt a delivery copy of a payload record.

        Returns ``(delivered, injected)`` — ``delivered`` is a COPY with
        one deterministic bit flipped when a ``kind`` event was due
        (``transfer_corrupt`` / ``cold_corrupt``), else ``rec`` itself.
        The caller keeps the intact source, so checksum verification plus
        one redelivery always recovers."""
        ev = self._due(kind)
        if ev is None:
            return rec, False
        self.injected[kind] += 1
        bad = np.array(rec, copy=True)
        if bad.size:
            i = int(self._rng.integers(bad.size))
            bit = int(self._rng.integers(32))
            flat = bad.reshape(-1)
            flat[i] = np.uint32(int(flat[i]) ^ (1 << bit))
        return bad, True

    # -- checkpoint-store I/O ---------------------------------------------

    def io_hook(self, op: str) -> None:
        """Checkpoint-store fault hook, called at the top of every I/O
        attempt (``op`` is ``"write"`` or ``"read"``).  Raises ``OSError``
        when an io_error event is due; the store's retry/backoff loop
        re-enters, and the first clean attempt after a failure books the
        recovery + retry."""
        owed = self._io_owed.get(op, 0)
        ev = self._due("io_error", match=lambda e: e.op in ("", op))
        if ev is not None:
            self.injected["io_error"] += 1
            self._io_owed[op] = owed + 1
            raise OSError(
                f"injected checkpoint {op} fault (boundary {self.t})"
            )
        if owed:
            self.recovered["io_error"] += owed
            self.retries += owed
            self._io_owed[op] = 0

    def retry_policy(self):
        """A :class:`repro_torch.checkpoint.store.RetryPolicy` whose backoff
        sleeps advance the injector's virtual clock (no real waiting) and
        whose jitter draws from the plan seed — fully deterministic."""
        from repro_torch.checkpoint.store import RetryPolicy

        return RetryPolicy(sleep=self._virtual_sleep,
                           rng=self._backoff_rng)

    def _virtual_sleep(self, seconds: float) -> None:
        self.clock_s += seconds
