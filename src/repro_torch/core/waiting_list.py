"""Equitable-startup waiting lists (paper §3.5, Algorithm 7).

``build_waiting_lists(max_b, p)`` reproduces Algorithm 7 exactly: process
p_i's waiting list receives process q = j·max_b^d + p_i for depth d from
base_d..max_depth and j = 1..max_b-1, recursing into q at depth d+1.  Process
indices are 1-based as in the paper; max_depth = floor(log_max_b p).

The intent (Fig. 3): during startup, each process sends its first max_b - 1
spawned tasks to its waiting list in order, explores the max_b-th task
sequentially, and repeats one level deeper — approximating the equitable
depth-log_b(p) split while remaining fully dynamic afterwards.
"""

from __future__ import annotations

import math


def max_startup_depth(max_b: int, p: int) -> int:
    if p <= 1:
        return -1
    return int(math.floor(math.log(p) / math.log(max_b)))


def build_waiting_lists(max_b: int, p: int) -> dict[int, list[int]]:
    """Exact Algorithm 7.  Returns {process_index: [assignees in send order]}
    with 1-based indices; every process 1..p appears as a key."""
    if max_b < 2:
        raise ValueError("max_b must be >= 2")
    md = max_startup_depth(max_b, p)
    lists: dict[int, list[int]] = {i: [] for i in range(1, p + 1)}

    def build(p_i: int, base_d: int) -> None:
        for d in range(base_d, md + 1):
            for j in range(1, max_b):
                q = j * (max_b**d) + p_i
                if q <= p:
                    lists[p_i].append(q)
                    build(q, d + 1)

    build(1, 0)
    return lists


def startup_assignment(max_b: int, p: int) -> list[int]:
    """Flatten the waiting lists into the order in which the p processes are
    reached during startup (root-first traversal).  Process 1 holds the seed;
    the rest receive their first task from their assigner.  Used by the
    SPMD engine to order the scatter of the startup frontier so that the
    initial distribution matches the paper's intended topology."""
    lists = build_waiting_lists(max_b, p)
    order: list[int] = []
    seen: set[int] = set()

    def visit(i: int) -> None:
        if i in seen:
            return
        seen.add(i)
        order.append(i)
        for q in lists[i]:
            visit(q)

    visit(1)
    # any process unreachable via waiting lists (p not a clean power) goes last
    for i in range(1, p + 1):
        visit(i)
    return order
