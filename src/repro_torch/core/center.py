"""Center logic (paper §3.1-3.2, Algorithm 3).

A copy of ``repro/core/center.py`` (pure Python): the port keeps its own.
The ``random`` policy draws from ``random.Random(seed)`` in the same order
as the JAX package's, so both pick the same donors.

The center owns *no tasks*: its entire state is a status array (one enum per
worker), one integer ``best_val_so_far`` (plus which worker holds the best
solution), the optional per-worker metadata integer, and the assignment chain
used for the cycle check described in §3.2.  Every decision consumes and
produces single integers — this is the object that the SPMD engine replicates
per instance (see ``superstep.py``), which is possible precisely because
the paper makes it this small.
"""

from __future__ import annotations

import dataclasses
import enum
import random
from typing import Optional


class Status(enum.IntEnum):
    RUNNING = 0
    AVAILABLE = 1
    ASSIGNED = 2


@dataclasses.dataclass
class CenterState:
    num_workers: int
    policy: str = "random"  # 'random' | 'priority'
    seed: int = 0

    def __post_init__(self):
        self.status = [Status.RUNNING] * (self.num_workers + 1)  # 1-based
        self.best_val: Optional[int] = None
        self.best_holder: Optional[int] = None
        self.metadata = [0] * (self.num_workers + 1)
        # assigned_to[r] = w  <=>  center told w to send work to r
        self.assigned_to: dict[int, int] = {}
        self._rng = random.Random(self.seed)

    # -- bestval_update ----------------------------------------------------
    def offer_best(self, source: int, value: int) -> bool:
        """Returns True iff the value improves the global best (center always
        re-verifies claims, Alg. 3 line 3)."""
        if self.best_val is None or value < self.best_val:
            self.best_val = value
            self.best_holder = source
            return True
        return False

    # -- cycle check (§3.2) --------------------------------------------------
    def _chain_leads_to(self, start: int, target: int) -> bool:
        seen = set()
        cur = start
        while cur in self.assigned_to:
            cur = self.assigned_to[cur]
            if cur == target:
                return True
            if cur in seen:
                return True  # defensive: existing cycle
            seen.add(cur)
        return False

    # -- getNextWorkingNode ---------------------------------------------------
    def get_next_working_node(self, requester: int) -> Optional[int]:
        """Choose a RUNNING donor for ``requester`` (Alg. 3 line 7).

        policy='random'  : uniform among RUNNING workers (paper's default).
        policy='priority': RUNNING worker with the largest metadata value
                           (= size of its most urgent pending instance)."""
        cands = [
            w
            for w in range(1, self.num_workers + 1)
            if self.status[w] == Status.RUNNING
            and w != requester
            and not self._chain_leads_to(w, requester)
        ]
        if not cands:
            return None
        if self.policy == "priority":
            return max(cands, key=lambda w: (self.metadata[w], -w))
        return self._rng.choice(cands)

    # -- message handlers (Alg. 3 body) ---------------------------------------
    def on_available(self, source: int) -> Optional[int]:
        """Worker ``source`` finished its subtree.  Returns the donor w that
        should be told to send work to it (or None -> stays AVAILABLE)."""
        w = self.get_next_working_node(source)
        if w is not None:
            self.status[source] = Status.ASSIGNED
            self.assigned_to[source] = w
            return w
        self.status[source] = Status.AVAILABLE
        return None

    def on_started_running(self, source: int) -> Optional[tuple[int, int]]:
        """Worker ``source`` received work.  Returns (source, r) if some
        yet-unassigned AVAILABLE worker r should now be fed by source."""
        self.status[source] = Status.RUNNING
        self.assigned_to.pop(source, None)
        for r in range(1, self.num_workers + 1):
            if self.status[r] == Status.AVAILABLE:
                self.status[r] = Status.ASSIGNED
                self.assigned_to[r] = source
                return (source, r)
        return None

    def on_metadata(self, source: int, value: int) -> None:
        self.metadata[source] = value

    def all_idle(self) -> bool:
        """Termination pre-condition: nobody RUNNING (Alg. 3 line 20; ASSIGNED
        counts as idle per §3.3)."""
        return all(
            self.status[w] != Status.RUNNING for w in range(1, self.num_workers + 1)
        )
