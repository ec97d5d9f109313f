"""Deterministic fault schedules for the self-healing solve plane.

The port of ``repro/faults/plan.py``, unchanged in behaviour: the same seed
draws the same plan in both packages, and ``to_dict``/``from_dict`` carry a
plan from one to the other.

A :class:`FaultPlan` is a seeded, fully reproducible list of
:class:`FaultEvent` entries — WHAT goes wrong and WHEN, where "when" is a
*chunk-boundary index* (the host-sync points of the solve loop), never a
wall clock.  Two runs of the same plan on different machines therefore
inject the exact same faults at the exact same points of the solve
trajectory, which is what lets the chaos legs pin ``faults_injected`` /
``faults_recovered`` as exact numbers.

Five fault kinds (``FAULT_KINDS``):

``crash``             a lane/worker dies at a chunk boundary — its device
                      state is lost and must be re-admitted from the
                      center's tracked placement
``stall``             a lane stops making superstep progress for
                      ``duration`` consecutive boundaries (a wedged host
                      or preempted device), caught by the service's
                      stall watchdog
``transfer_corrupt``  a sparse-transfer payload record is corrupted on
                      delivery (cold tier -> hot frontier leg)
``cold_corrupt``      a codec record is corrupted while being written
                      into the cold tier
``io_error``          a checkpoint-store read/write raises ``OSError``
                      (``op`` narrows it to one side)

The plan is pure data: build one by hand for targeted tests, or use
:meth:`FaultPlan.random` for a seeded randomized schedule; both JSON
round-trip via ``to_dict`` / ``from_dict`` for the launch CLI.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

import numpy as np

FAULT_KINDS = ("crash", "stall", "transfer_corrupt", "cold_corrupt",
               "io_error")

_IO_OPS = ("write", "read")


@dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault.

    ``at`` is the chunk-boundary index (0-based, counted by the
    injector's ``step_boundary``) at or after which the event fires —
    corruption/io events fire at the first matching *operation* once due,
    crash/stall events at the first boundary with a live target lane.
    ``lane`` is a virtual slot, mapped modulo the live-lane list at fire
    time so plans stay valid for any plane width.
    """

    kind: str
    at: int
    lane: int = 0
    duration: int = 1          # stall only: boundaries the lane is wedged
    op: str = ""               # io_error only: "write", "read", or "" (any)

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; valid: {FAULT_KINDS}"
            )
        if self.at < 0 or self.lane < 0 or self.duration < 1:
            raise ValueError(f"bad fault event {self!r}")
        if self.op and self.op not in _IO_OPS:
            raise ValueError(f"io op must be one of {_IO_OPS}: {self!r}")

    def to_dict(self) -> dict:
        return dict(kind=self.kind, at=self.at, lane=self.lane,
                    duration=self.duration, op=self.op)

    @staticmethod
    def from_dict(d: dict) -> "FaultEvent":
        return FaultEvent(**d)


@dataclass(frozen=True)
class FaultPlan:
    """A seeded, ordered fault schedule (pure data, JSON round-trips)."""

    seed: int = 0
    events: Tuple[FaultEvent, ...] = field(default_factory=tuple)

    def __post_init__(self):
        object.__setattr__(
            self, "events",
            tuple(sorted(self.events, key=lambda e: (e.at, e.kind, e.lane))),
        )

    @staticmethod
    def random(seed: int, *, n_events: int = 6, horizon: int = 48,
               lanes: int = 8, kinds=FAULT_KINDS,
               max_stall: int = 4) -> "FaultPlan":
        """A seeded randomized schedule: ``n_events`` faults drawn
        uniformly over ``kinds``, boundaries ``[0, horizon)`` and lane
        slots ``[0, lanes)``.  Same seed -> same plan, everywhere."""
        rng = np.random.default_rng(seed)
        events = []
        for _ in range(n_events):
            kind = kinds[int(rng.integers(len(kinds)))]
            events.append(FaultEvent(
                kind=kind,
                at=int(rng.integers(horizon)),
                lane=int(rng.integers(max(1, lanes))),
                duration=1 + int(rng.integers(max(1, max_stall)))
                if kind == "stall" else 1,
                op=_IO_OPS[int(rng.integers(2))] if kind == "io_error"
                else "",
            ))
        return FaultPlan(seed=seed, events=tuple(events))

    def counts(self) -> dict:
        out = {k: 0 for k in FAULT_KINDS}
        for e in self.events:
            out[e.kind] += 1
        return out

    def to_dict(self) -> dict:
        return dict(seed=self.seed,
                    events=[e.to_dict() for e in self.events])

    @staticmethod
    def from_dict(d: dict) -> "FaultPlan":
        return FaultPlan(
            seed=int(d.get("seed", 0)),
            events=tuple(FaultEvent.from_dict(e)
                         for e in d.get("events", [])),
        )
