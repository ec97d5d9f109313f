"""Semi-centralized request balancer for batched decode serving.

The port's copy of ``repro/serving/balancer.py`` (numpy only, copied rather
than imported: the port imports nothing of ``repro``).  Only
:func:`solve_stream` differs: with no injected solver it drives the port's
:func:`repro_torch.api.solve_stream_session`, on ``device``.

This is the BEYOND-PAPER integration of the paper's contribution into the LM
framework: the center/worker mechanics of §3.1-3.2 reapplied to continuous
batching across data-parallel decode replicas.

Mapping (paper → serving):
  worker                    → one data-parallel decode replica (a model mesh)
  task                      → an in-flight request (prompt + tokens-left)
  task "size" metadata      → the request's remaining-work estimate
  AVAILABLE worker          → replica whose batch occupancy fell below the
                              low-water mark (finished requests drain it)
  heaviest-pending donation → the donor replica hands over its LARGEST
                              remaining-work queued request
  center                    → the replicated matcher: every replica computes
                              the same pairing from an all-gathered O(R)
                              status vector (occupancy ⊕ top queue work);
                              request payloads (prompt ids / KV handles)
                              move replica→replica, never through a center

Failure-free property: a replica below the low-water mark is matched only to
replicas with queue depth ≥ 1, so a match always yields a request.  Exactly
the paper's guarantee, restated for serving.

This module is deliberately runnable at host level (numpy state machine) so
the scheduler can also front a real multi-process deployment; the device
twin is ``repro_torch.core.superstep.match_idle_to_donors``.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class RequestBatch:
    """One replica's continuous-batching state."""

    capacity: int  # max concurrent decode slots
    active_work: list  # remaining tokens per active request
    queued_work: list  # remaining tokens per queued request

    @property
    def occupancy(self) -> int:
        return len(self.active_work)

    def admit(self) -> None:
        """Move queued requests into free slots (largest-work first — the
        paper's priority ordering keeps long requests from starving)."""
        self.queued_work.sort(reverse=True)
        while self.queued_work and self.occupancy < self.capacity:
            self.active_work.append(self.queued_work.pop(0))

    def step(self, tokens: int = 1) -> int:
        """Decode ``tokens`` for every active request; returns # finished."""
        self.active_work = [w - tokens for w in self.active_work]
        done = sum(w <= 0 for w in self.active_work)
        self.active_work = [w for w in self.active_work if w > 0]
        return done


@dataclasses.dataclass
class BalancerState:
    replicas: list  # list[RequestBatch]
    low_water: float = 0.5  # occupancy fraction that triggers an 'available'
    transfers: int = 0
    control_ints_per_round: int = 0

    def status(self) -> np.ndarray:
        """(R, 2) int status table — the center's ENTIRE state (paper §3.1):
        column 0 = deficit (free slots below low-water, 0 if none),
        column 1 = largest queued work (0 if queue empty)."""
        rows = []
        for r in self.replicas:
            lw = int(r.capacity * self.low_water)
            deficit = max(lw - (r.occupancy + len(r.queued_work)), 0)
            top = max(r.queued_work) if r.queued_work else 0
            rows.append((deficit, top))
        self.control_ints_per_round = 2 * len(self.replicas)
        return np.array(rows, dtype=np.int64)


def rebalance(state: BalancerState) -> int:
    """One matching round (the replicated center).  Donors = replicas with a
    queue; receivers = replicas under the low-water mark.  Matching is
    deterministic (sorted by metadata), so every replica computes the same
    answer from the same status table.  Returns # requests moved."""
    table = state.status()
    receivers = [i for i in np.argsort(-table[:, 0]) if table[i, 0] > 0]
    donors = sorted(
        (i for i in range(len(state.replicas)) if table[i, 1] > 0),
        key=lambda i: (-table[i, 1], i),
    )
    moved = 0
    for recv, donor in zip(receivers, donors):
        if recv == donor:
            continue
        dq = state.replicas[donor].queued_work
        dq.sort(reverse=True)
        req = dq.pop(0)  # heaviest pending request (paper §3.4 priority)
        state.replicas[recv].queued_work.append(req)
        moved += 1
    state.transfers += moved
    return moved


# -- solve-plane admission ------------------------------------------------------


@dataclasses.dataclass
class SolveBatcher:
    """Admit a stream of branching-problem solve requests into fixed-size
    batched-solve-plane (``SolverSession.solve_many``) batches.

    This is the serving front of the batched solve plane: a request's
    "replica" is one of the B lanes of a solve batch, so the continuous-
    batching occupancy machinery above applies unchanged — each
    ``(problem, W)`` packing bucket is a :class:`RequestBatch` whose
    ``capacity`` is the plane's batch size, and ``admit()``
    (largest-work-first) decides which queued instances fill the free lanes,
    so big instances never starve behind a stream of small ones.  Queue
    entries are ``(work, -seq)`` pairs — the work estimate is the instance
    size, the same §3.2 single-integer metadata the solver's center runs on;
    the negated sequence makes equal-size requests drain FIFO under the
    descending sort.  Buckets follow the solve plane's packing rule: one
    batch never mixes packed widths W, and never mixes PROBLEMS — a plane
    compiles one problem's brancher (`solve_many` pads n within a bucket).

    Only the admission half of :class:`RequestBatch` (``admit``/
    ``occupancy``) tolerates these tuple entries — never feed a batcher
    bucket to ``step()``/``status()``/``rebalance``, which do integer
    arithmetic on the work values.
    """

    batch_size: int
    # (problem, W) -> RequestBatch
    buckets: dict = dataclasses.field(default_factory=dict)
    graphs: dict = dataclasses.field(default_factory=dict)  # seq -> instance
    problems: dict = dataclasses.field(default_factory=dict)  # seq -> name
    _seq: int = 0
    # tickets drained into a batch but not yet taken by a solver
    _drained: set = dataclasses.field(default_factory=set)

    def submit(self, g, problem: str = "vertex_cover") -> int:
        """Queue one instance; returns its ticket (submission sequence)."""
        seq = self._seq
        self._seq += 1
        self.graphs[seq] = g
        self.problems[seq] = problem
        rb = self.buckets.setdefault(
            (problem, g.W), RequestBatch(self.batch_size, [], [])
        )
        rb.queued_work.append((g.n, -seq))
        return seq

    def _drain(self, rb: RequestBatch) -> list:
        lanes, rb.active_work = rb.active_work, []
        tickets = [-neg_seq for _, neg_seq in lanes]
        self._drained.update(tickets)
        return tickets

    def problem_of(self, ticket) -> str:
        """The problem a queued ticket was submitted under (call before
        ``take``, which evicts the record)."""
        return self.problems[ticket]

    def status(self) -> dict:
        """Per-bucket admission view: ``queued`` (not yet in a lane),
        ``admitted`` (in a lane awaiting drain) and ``vacant`` lanes.  A
        partially-filled bucket's unfilled lanes ARE vacant — a flush()
        solves only the real instances, the plane pads internally and no
        placeholder ticket ever exists for a padded lane."""
        out = {}
        for key, rb in self.buckets.items():
            out[key] = {
                "queued": len(rb.queued_work),
                "admitted": rb.occupancy,
                "vacant": rb.capacity - rb.occupancy,
            }
        return out

    def take(self, tickets) -> list:
        """Hand a drained batch's instances to the solver, EVICTING them —
        the batcher holds a graph only between submit and take, so a
        long-lived admission stream does not accumulate solved instances.

        Only tickets from a drained batch (``ready_batches``/``flush``
        output) are takeable: taking a still-queued ticket would leave its
        stale queue entry to drain later with no instance behind it — a
        placeholder result — so that raises instead."""
        not_ready = [t for t in tickets if t not in self._drained]
        if not_ready:
            raise ValueError(
                f"ticket(s) {not_ready} not in any drained batch yet; "
                "take() only accepts ready_batches()/flush() output"
            )
        self._drained.difference_update(tickets)
        for t in tickets:
            self.problems.pop(t, None)
        return [self.graphs.pop(t) for t in tickets]

    def ready_batches(self) -> list:
        """Every FULL plane currently admissible: lists of tickets, one list
        per batch.  Partially-filled planes stay queued (call ``flush``)."""
        out = []
        for rb in self.buckets.values():
            rb.admit()
            while rb.occupancy == rb.capacity:
                out.append(self._drain(rb))
                rb.admit()
        return out

    def flush(self) -> list:
        """Full planes plus every partially-filled one (end of stream)."""
        out = self.ready_batches()
        for rb in self.buckets.values():
            rb.admit()
            if rb.active_work:
                out.append(self._drain(rb))
        return out


def solve_stream(
    graphs, batch_size: int, solver=None, problem="vertex_cover", *,
    device=None, **solve_kw
) -> list:
    """Drive a request stream through the batcher onto the batched solve
    plane; returns per-instance results in SUBMISSION order.

    ``problem`` is one registry name for the whole stream, or a per-instance
    sequence — mixed streams split into (problem, W) planes and each plane is
    solved under its own problem.  With no ``solver``, the stream delegates
    to :func:`repro_torch.api.solve_stream_session` on ``device`` (None: the
    card): one live service per problem, all sharing ONE plane cache.
    ``solve_kw`` maps onto :class:`repro_torch.api.SolveConfig` knobs (the
    legacy ``policy_priority`` bool is still accepted).  An injected
    ``solver`` keeps the admission logic testable without the solve plane;
    it receives ``problem=`` per batch plus ``solve_kw`` verbatim.
    """
    if solver is None:
        from repro_torch.api import solve_stream_session
        from repro_torch.api.backends import config_from_legacy

        try:
            cfg = config_from_legacy(**solve_kw)
        except TypeError:
            import dataclasses

            from repro_torch.api import SolveConfig

            known = sorted(
                {f.name for f in dataclasses.fields(SolveConfig)}
                | {"policy_priority"}
            )
            unknown = sorted(set(solve_kw) - set(known))
            raise ValueError(
                f"unknown solve_stream option(s): {', '.join(unknown)}; "
                f"known: {', '.join(known)}"
            )
        return solve_stream_session(
            graphs, batch_size, problem=problem, config=cfg, device=device
        )

    graphs = list(graphs)
    probs = (
        [problem] * len(graphs)
        if isinstance(problem, str)
        else list(problem)
    )
    if len(probs) != len(graphs):
        raise ValueError("need one problem, or one per instance")
    batcher = SolveBatcher(batch_size)
    tickets = [batcher.submit(g, p) for g, p in zip(graphs, probs)]
    results = {}
    for batch in batcher.flush():
        batch_problem = batcher.problem_of(batch[0])
        gs = batcher.take(batch)
        for seq, res in zip(batch, solver(gs, problem=batch_problem, **solve_kw)):
            results[seq] = res
    return [results[t] for t in tickets]


def simulate(
    num_replicas: int,
    capacity: int,
    request_works: list[int],
    *,
    balance: bool = True,
    seed: int = 0,
) -> dict:
    """Drive the balancer over a request trace; returns makespan + stats.
    Used by benchmarks to show the idle-slot reduction vs no balancing."""
    rng = np.random.default_rng(seed)
    reps = [RequestBatch(capacity, [], []) for _ in range(num_replicas)]
    # adversarial arrival: all requests land on replica 0 (a hot shard)
    reps[0].queued_work = list(request_works)
    state = BalancerState(reps)
    rounds = 0
    idle_slot_steps = 0
    while any(r.active_work or r.queued_work for r in reps):
        if balance:
            rebalance(state)
        for r in reps:
            r.admit()
            r.step()
            idle_slot_steps += r.capacity - r.occupancy
        rounds += 1
        if rounds > 10_000_000:
            raise RuntimeError("balancer livelock")
    return {
        "rounds": rounds,
        "idle_slot_steps": idle_slot_steps,
        "transfers": state.transfers,
        "control_ints_per_round": state.control_ints_per_round,
    }
