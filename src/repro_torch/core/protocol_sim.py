"""Discrete-event simulation of the full asynchronous GemPBA protocol.

The port of ``repro/core/protocol_sim.py``, on the host (numpy and Python),
tick for tick and message for message the JAX package's: the same heap
order, the same counters, the same best.

This is the *faithful* reproduction of the paper's MPI design (Algorithms 3-6
plus the §3.3 termination safety mechanisms), used to (a) validate the
protocol properties the paper claims — failure-free work requests, no lost
tasks, safe termination under message races — and (b) actually SOLVE vertex
cover instances with P virtual workers, producing the message/byte statistics
reported in the benchmarks.  The SPMD engine (superstep.py) is the
hardware adaptation; this simulator is the semantics reference it is checked
against (same best value as the sequential solver, zero failed requests).

Time model: integer ticks.  Per tick every worker (1) drains its inbox
(updateWorkerIPC, Alg. 4), (2) expands ONE search-tree node, (3) services its
waiting list (updatePendingTasks).  Messages take ``latency`` ticks to arrive
(configurable; >1 exposes the §3.3 in-flight-task termination race).  The
center drains its inbox each tick (Alg. 3 loop).
"""

from __future__ import annotations

import dataclasses
import heapq
from collections import defaultdict
from typing import Any, Optional

import numpy as np

from repro_torch.core.center import CenterState, Status
from repro_torch.core.encoding import Task, make_codec
from repro_torch.core.task_tree import TaskTree
from repro_torch.graphs.bitgraph import BitGraph, mask_full
from repro_torch.problems import base as problems_base
from repro_torch.problems.registry import DEFAULT_PROBLEM, get_problem

CENTER = 0
INT_BYTES = 4  # "each message is small as it only requires sending a single integer"


@dataclasses.dataclass
class SimStats:
    msg_count: dict = dataclasses.field(default_factory=lambda: defaultdict(int))
    msg_bytes: dict = dataclasses.field(default_factory=lambda: defaultdict(int))
    failed_requests: int = 0  # must stay 0: the paper's key guarantee
    tasks_transferred: int = 0
    nodes_expanded: int = 0
    ticks: int = 0
    termination_cancelled: int = 0

    @property
    def total_bytes(self) -> int:
        return sum(self.msg_bytes.values())

    @property
    def center_bytes(self) -> int:
        """Bytes that flowed through the center (control plane only)."""
        return sum(
            b for tag, b in self.msg_bytes.items() if not tag.startswith("work")
        )


@dataclasses.dataclass(order=True)
class _Msg:
    deliver_at: int
    seq: int
    src: int = dataclasses.field(compare=False)
    dst: int = dataclasses.field(compare=False)
    tag: str = dataclasses.field(compare=False)
    data: Any = dataclasses.field(compare=False)


class _Network:
    def __init__(self, latency: int, stats: SimStats, codec):
        self.latency = latency
        self.stats = stats
        self.codec = codec
        self._q: list[_Msg] = []
        self._seq = 0

    def send(self, src: int, dst: int, tag: str, data: Any, now: int) -> None:
        self.stats.msg_count[tag] += 1
        nbytes = self.codec.record_bytes if tag == "work" else INT_BYTES
        self.stats.msg_bytes[tag] += nbytes
        self._seq += 1
        heapq.heappush(
            self._q, _Msg(now + self.latency, self._seq, src, dst, tag, data)
        )

    def deliver(self, dst: int, now: int) -> list[_Msg]:
        out = []
        rest = []
        while self._q and self._q[0].deliver_at <= now:
            m = heapq.heappop(self._q)
            (out if m.dst == dst else rest).append(m)
        for m in rest:
            heapq.heappush(self._q, m)
        return out

    def in_flight(self) -> int:
        return len(self._q)


class _Worker:
    """One virtual worker process (Alg. 4 + the DFS exploration loop).

    Branching and bounding are resolved through the problem's
    :class:`~repro_torch.problems.base.BranchingProblem` host callables
    (``branch_once_host`` / ``host_task_bound`` / ``host_terminal_value``),
    so the simulator runs any registry problem with host plumbing — all
    values are in the plugin's INTERNAL minimization sense.  ``g`` is the
    problem's host VIEW (e.g. the complement graph for MIS)."""

    def __init__(
        self, wid: int, g: BitGraph, net: _Network, stats: SimStats, mode, k,
        problem: problems_base.BranchingProblem,
    ):
        self.wid = wid
        self.g = g
        self.net = net
        self.stats = stats
        self.mode = mode
        self.k = k
        self.problem = problem
        self.tree = TaskTree()
        # DFS stack entries: [task, children(list of Task), next_child_idx]
        self.stack: list[list] = []
        self.local_best: int = problems_base.initial_bound(problem, g, mode, k)
        self.local_best_sol: Optional[np.ndarray] = None
        self.global_best_seen: int = self.local_best
        self.waiting: list[int] = []  # processes center told us to feed
        self.nb_sent_tasks = 0  # §3.3 safety mechanism 1
        self.announced_available = False

    # -- state ----------------------------------------------------------------
    def is_idle(self) -> bool:
        return not self.stack and self.tree.is_empty()

    def bound(self) -> int:
        return min(self.local_best, self.global_best_seen)

    # -- Alg. 4: updateWorkerIPC ------------------------------------------------
    def update_ipc(self, now: int) -> None:
        for m in self.net.deliver(self.wid, now):
            if m.tag == "bestval_update":
                if m.data < self.global_best_seen:
                    self.global_best_seen = m.data
            elif m.tag == "send_work":
                self.waiting.append(m.data)
            elif m.tag == "work":
                # can only be received when no task is running
                task: Task = m.data  # the sender's Task; bytes are the codec's
                self.net.send(self.wid, CENTER, "started_running", self.wid, now)
                self.net.send(self.wid, m.src, "work_ack", None, now)
                self._start_task(task)
                self.announced_available = False
            elif m.tag == "work_ack":
                self.nb_sent_tasks -= 1
            elif m.tag == "term_probe":
                quiescent = self.is_idle() and self.nb_sent_tasks == 0
                self.net.send(self.wid, CENTER, "term_ack", quiescent, now)

    def _start_task(self, task: Task) -> None:
        assert self.is_idle(), f"worker {self.wid} got work while busy"
        self.tree = TaskTree()
        self.tree.set_root(task, depth=task.depth)
        self.stack = [[task, None, 0]]

    # -- exploration: one node expansion per tick --------------------------------
    def explore_step(self, now: int) -> None:
        if not self.stack:
            return
        frame = self.stack[-1]
        task, children, idx = frame
        if children is None:
            # first visit: bound check, then branch (Alg. 2 / Alg. 9)
            self.stats.nodes_expanded += 1
            spec = self.problem
            if spec.host_task_bound(self.g, task.mask, task.sol_mask) >= self.bound():
                self._finish_node(task)
                return
            kids, terminal = spec.branch_once_host(self.g, task.mask, task.sol_mask)
            if terminal is not None:
                tval = int(spec.host_terminal_value(self.g, terminal[0], terminal[1]))
                if tval < self.bound():
                    self.local_best = tval
                    self.local_best_sol = terminal[1]
                    # paper: inform center when a better value is found
                    self.net.send(self.wid, CENTER, "bestval_update", tval, now)
                self._finish_node(task)
                return
            child_tasks = [
                Task(mask=c[0], sol_mask=c[1], depth=task.depth + 1) for c in kids
            ]
            # Alg. 2 line 9 / Alg. 5: register BEFORE exploring
            self.tree.register_child_instances(child_tasks, task)
            frame[1] = child_tasks
            frame[2] = 0
            return
        if idx < len(children):
            frame[2] += 1
            child = children[idx]
            # Alg. 5 'search': claim unless it was donated meanwhile
            if self.tree.try_claim(child):
                self.stack.append([child, None, 0])
            return
        self._finish_node(task)

    def _finish_node(self, task: Task) -> None:
        self.tree.finish(task)
        self.stack.pop()

    # -- Alg. 4: updatePendingTasks ----------------------------------------------
    def update_pending(self, now: int) -> None:
        while self.waiting and self.tree.pending_count() > 0:
            dest = self.waiting.pop(0)
            payload = self.tree.pop_highest_priority()
            rec = payload  # Task object; byte size accounted via codec
            self.net.send(self.wid, dest, "work", rec, now)
            self.nb_sent_tasks += 1
            self.stats.tasks_transferred += 1

    def maybe_announce(self, now: int) -> None:
        if self.is_idle() and not self.announced_available:
            self.net.send(self.wid, CENTER, "available", self.wid, now)
            self.announced_available = True

    def metadata_value(self) -> int:
        """Paper §3.2: size of the largest unexplored instance (one integer).
        We use n - depth of the top-priority task as the size proxy."""
        d = self.tree.top_priority_depth()
        return 0 if d is None else max(self.g.n - d, 1)


@dataclasses.dataclass
class SimResult:
    best_size: int
    best_sol: Optional[np.ndarray]
    stats: SimStats
    ticks: int


def run_protocol_sim(
    g: BitGraph,
    num_workers: int,
    latency: int = 1,
    policy: str = "random",
    codec_name: str = "optimized",
    mode: str = "bnb",
    k: Optional[int] = None,
    send_metadata: bool = False,
    max_ticks: int = 2_000_000,
    seed: int = 0,
    problem=DEFAULT_PROBLEM,
) -> SimResult:
    """Run the full asynchronous protocol until center-verified termination.

    ``problem`` is any registry problem (or spec) with host plumbing — the
    workers explore its host view with its host bounds, so
    ``problem="max_clique"`` runs the same Algorithms 3-6 protocol on the
    clique brancher."""
    spec = problems_base.require_host_bounds(get_problem(problem))
    view = spec.host_view(g)
    stats = SimStats()
    codec = make_codec(codec_name, view.n, problem=spec)
    net = _Network(latency=latency, stats=stats, codec=codec)
    center = CenterState(num_workers=num_workers, policy=policy, seed=seed)
    workers = {
        i: _Worker(i, view, net, stats, mode, k, spec)
        for i in range(1, num_workers + 1)
    }

    # Startup (§3.5): the seed goes to worker 1 (Fig. 1) and the center
    # pre-builds every worker's waiting list with Algorithm 7 (max_b = 2 for
    # vertex cover), so the first tasks spawned approximate the equitable
    # depth-log_b(p) split.  Every non-seed worker starts ASSIGNED to its
    # Alg. 7 assigner -- no startup 'available' storm, no failed requests.
    from repro_torch.core.waiting_list import build_waiting_lists

    seed_task = Task(
        mask=mask_full(view.n), sol_mask=np.zeros(view.W, np.uint32), depth=0
    )
    workers[1]._start_task(seed_task)
    wlists = build_waiting_lists(max_b=2, p=num_workers)
    for wid, lst in wlists.items():
        workers[wid].waiting = list(lst)
        for r in lst:
            center.status[r] = Status.ASSIGNED
            center.assigned_to[r] = wid
            workers[r].announced_available = True  # pinned, must not announce

    termination_probe: Optional[dict] = None
    now = 0
    while now < max_ticks:
        now += 1
        # ---- center loop (Alg. 3) ----
        for m in net.deliver(CENTER, now):
            if m.tag == "bestval_update":
                if center.offer_best(m.src, m.data):
                    for wid in workers:
                        net.send(CENTER, wid, "bestval_update", m.data, now)
            elif m.tag == "available":
                w = center.on_available(m.src)
                if w is not None:
                    net.send(CENTER, w, "send_work", m.src, now)
            elif m.tag == "started_running":
                pair = center.on_started_running(m.src)
                if pair is not None:
                    src, r = pair
                    net.send(CENTER, src, "send_work", r, now)
                if termination_probe is not None:
                    stats.termination_cancelled += 1
                    termination_probe = None  # §3.3: cancel termination
            elif m.tag == "metadata":
                center.on_metadata(m.src, m.data)
            elif m.tag == "term_ack":
                if termination_probe is not None:
                    if m.data:  # worker says it is truly quiescent
                        termination_probe["acks"].add(m.src)
                    else:
                        stats.termination_cancelled += 1
                        termination_probe = None
        # ---- termination detection (§3.3, safety mechanism 1) ----
        if center.all_idle():
            if termination_probe is None:
                termination_probe = {"acks": set()}
                for wid in workers:
                    net.send(CENTER, wid, "term_probe", None, now)
            elif len(termination_probe["acks"]) == num_workers and net.in_flight() == 0:
                break
        else:
            termination_probe = None

        # ---- fpt early stop: reaching the internal decision target ends the
        # exploration (<= k for minimization, >= k for negated maximization) --
        if (
            mode == "fpt"
            and center.best_val is not None
            and center.best_val <= spec.fpt_target(k)
        ):
            break

        # ---- workers ----
        for wid, wk in workers.items():
            wk.update_ipc(now)
            wk.explore_step(now)
            wk.update_pending(now)
            if send_metadata and not wk.is_idle():
                net.send(wid, CENTER, "metadata", wk.metadata_value(), now)
            wk.maybe_announce(now)

    stats.ticks = now
    # collect the best solution: center knows the holder (§3.1) and fetches it
    # only once, after exploration finishes.  "found nothing acceptable" is
    # exactly "the internal best never improved on the seed bound" — the same
    # objective-adapter contract as the SPMD engine's result extraction.
    initial = problems_base.initial_bound(spec, view, mode, k)
    internal_best = initial
    best_sol = None
    for wk in workers.values():
        if wk.local_best < internal_best:
            internal_best = wk.local_best
            best_sol = wk.local_best_sol
    found = internal_best < initial
    best_size = int(spec.external_value(internal_best))
    if not found:
        best_sol = None
        if mode == "fpt":
            best_size = -1
    return SimResult(best_size, best_sol, stats, now)
