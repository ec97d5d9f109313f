"""Fully-centralized scheduler baseline (paper §4.2, after Abu-Khzam 2006).

The port of ``repro/core/centralized.py``, on the host, tick for tick the
JAX package's.

The paper implements this strategy itself to compare against; we do the same.
A central process RECEIVES tasks from workers and REDISTRIBUTES them — every
task crosses the wire twice, which is why the basic (adjacency) encoding
collapses in Table 1.  Mechanics reproduced from §4.2:

* center holds a size-priority queue of tasks, capped at ``queue_cap_per_p·p``
  tasks (paper: 1000·p) or a byte budget (paper: 10 GB);
* workers push their highest-priority pending task to center whenever center
  is `not full` (workers track center fullness via broadcast flags);
* center sends the largest-instance task to each AVAILABLE worker;
* `full` is broadcast when the cap is hit, `not full` when it drains below
  90% (hysteresis — prevents flag thrash);
* termination: all workers AVAILABLE and queue empty.

The same discrete-event network as :mod:`repro_torch.core.protocol_sim` is used so
byte/message statistics are directly comparable.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Optional

import numpy as np

from repro_torch.core.encoding import Task, make_codec
from repro_torch.core.protocol_sim import SimResult, SimStats, _Network
from repro_torch.core.task_tree import TaskTree
from repro_torch.graphs.bitgraph import BitGraph, mask_full, popcount_rows
from repro_torch.problems import base as problems_base
from repro_torch.problems.registry import DEFAULT_PROBLEM, get_problem

CENTER = 0


class _CWorker:
    """Worker under the centralized scheme: explores, ships tasks to center.

    Like :class:`repro_torch.core.protocol_sim._Worker`, branching/bounding go
    through the problem's host callables (internal minimization sense), so
    the baseline runs any registry problem with host plumbing."""

    def __init__(
        self, wid: int, g: BitGraph, net: _Network, stats: SimStats,
        problem: problems_base.BranchingProblem, initial_best: int,
    ):
        self.wid = wid
        self.g = g
        self.net = net
        self.stats = stats
        self.problem = problem
        self.tree = TaskTree()
        self.stack: list[list] = []
        self.local_best = initial_best
        self.local_best_sol: Optional[np.ndarray] = None
        self.global_best_seen = initial_best
        self.center_full = False
        self.announced_available = False

    def is_idle(self) -> bool:
        return not self.stack and self.tree.is_empty()

    def bound(self) -> int:
        return min(self.local_best, self.global_best_seen)

    def update_ipc(self, now: int) -> None:
        for m in self.net.deliver(self.wid, now):
            if m.tag == "bestval_update":
                if m.data < self.global_best_seen:
                    self.global_best_seen = m.data
            elif m.tag == "full":
                self.center_full = True
            elif m.tag == "not_full":
                self.center_full = False
            elif m.tag == "work":
                task: Task = m.data
                self._start_task(task)
                self.announced_available = False

    def _start_task(self, task: Task) -> None:
        assert self.is_idle()
        self.tree = TaskTree()
        self.tree.set_root(task, depth=task.depth)
        self.stack = [[task, None, 0]]

    def explore_step(self, now: int) -> None:
        if not self.stack:
            return
        frame = self.stack[-1]
        task, children, idx = frame
        if children is None:
            self.stats.nodes_expanded += 1
            spec = self.problem
            if spec.host_task_bound(self.g, task.mask, task.sol_mask) >= self.bound():
                self._finish(task)
                return
            kids, terminal = spec.branch_once_host(self.g, task.mask, task.sol_mask)
            if terminal is not None:
                tval = int(spec.host_terminal_value(self.g, terminal[0], terminal[1]))
                if tval < self.bound():
                    self.local_best = tval
                    self.local_best_sol = terminal[1]
                    self.net.send(self.wid, CENTER, "bestval_update", tval, now)
                self._finish(task)
                return
            child_tasks = [
                Task(mask=c[0], sol_mask=c[1], depth=task.depth + 1) for c in kids
            ]
            self.tree.register_child_instances(child_tasks, task)
            frame[1], frame[2] = child_tasks, 0
            return
        if idx < len(children):
            frame[2] += 1
            child = children[idx]
            if self.tree.try_claim(child):
                self.stack.append([child, None, 0])
            return
        self._finish(task)

    def _finish(self, task: Task) -> None:
        self.tree.finish(task)
        self.stack.pop()

    def offload_to_center(self, now: int) -> None:
        """§4.2: each time a child is registered and center is not full, the
        worker ships its highest-priority pending task to center."""
        if self.center_full:
            return
        payload = self.tree.pop_highest_priority()
        if payload is not None:
            self.net.send(self.wid, CENTER, "task_upload", payload, now)
            # every task crosses the wire AT FULL RECORD SIZE (tag 'work…'
            # so stats count codec bytes — this is the 2x cost of the design)
            self.stats.msg_bytes["task_upload"] += self.net.codec.record_bytes - 4
            self.stats.tasks_transferred += 1

    def maybe_announce(self, now: int) -> None:
        if self.is_idle() and not self.announced_available:
            self.net.send(self.wid, CENTER, "available", self.wid, now)
            self.announced_available = True


def run_centralized_sim(
    g: BitGraph,
    num_workers: int,
    latency: int = 1,
    codec_name: str = "optimized",
    queue_cap_per_p: int = 1000,
    use_priority_queue: bool = True,
    max_ticks: int = 2_000_000,
    mode: str = "bnb",
    k: Optional[int] = None,
    problem=DEFAULT_PROBLEM,
) -> SimResult:
    spec = problems_base.require_host_bounds(get_problem(problem))
    view = spec.host_view(g)
    initial = problems_base.initial_bound(spec, view, mode, k)
    stats = SimStats()
    codec = make_codec(codec_name, view.n, problem=spec)
    net = _Network(latency=latency, stats=stats, codec=codec)
    workers = {
        i: _CWorker(i, view, net, stats, spec, initial)
        for i in range(1, num_workers + 1)
    }

    # center state
    queue: list = []  # heap of (-instance_size, seq, Task) | FIFO list
    seq = 0
    best_val = initial
    status_available: set[int] = set()
    full = False
    cap = queue_cap_per_p * num_workers

    # startup: original instance to worker 1 (§4.2)
    seed = Task(
        mask=mask_full(view.n), sol_mask=np.zeros(view.W, np.uint32), depth=0
    )
    workers[1]._start_task(seed)

    now = 0
    while now < max_ticks:
        now += 1
        # ---- center loop ----
        for m in net.deliver(CENTER, now):
            if m.tag == "bestval_update":
                if m.data < best_val:
                    best_val = m.data
                    for wid in workers:
                        net.send(CENTER, wid, "bestval_update", best_val, now)
            elif m.tag == "available":
                status_available.add(m.src)
            elif m.tag == "task_upload":
                task: Task = m.data
                # prune on arrival against the current bound (cheap birth
                # bound — the problem's host_child_bound)
                if spec.host_child_bound(view, task.mask, task.sol_mask) < best_val:
                    seq += 1
                    size = int(popcount_rows(task.mask))
                    if use_priority_queue:
                        heapq.heappush(queue, (-size, seq, task))
                    else:
                        queue.append((0, seq, task))
        # dispatch: largest-instance task to each AVAILABLE worker
        while queue and status_available:
            wid = min(status_available)
            status_available.discard(wid)
            if use_priority_queue:
                _, _, task = heapq.heappop(queue)
            else:
                _, _, task = queue.pop(0)
            net.send(CENTER, wid, "work", task, now)
        # fullness hysteresis (90% threshold, §4.2)
        if not full and len(queue) >= cap:
            full = True
            for wid in workers:
                net.send(CENTER, wid, "full", None, now)
        elif full and len(queue) <= 0.9 * cap:
            full = False
            for wid in workers:
                net.send(CENTER, wid, "not_full", None, now)

        # ---- termination: all available + queue empty + nothing in flight ----
        if (
            len(status_available) == num_workers
            and not queue
            and net.in_flight() == 0
        ):
            break

        # ---- fpt early stop: the internal decision target was reached ----
        if mode == "fpt" and best_val <= spec.fpt_target(k):
            break

        # ---- workers ----
        for wid, wk in workers.items():
            wk.update_ipc(now)
            wk.explore_step(now)
            wk.offload_to_center(now)
            wk.maybe_announce(now)

    stats.ticks = now
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
