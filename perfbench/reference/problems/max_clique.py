"""Maximum clique, written plainly: the expansion of a task, the
certificate of an answer and the optimum.

One task (candidates P, clique R), after the port's documented semantics,
not its code: bound ``-(|R| + |P|)``; the first candidate u of maximum
degree within P; left ``(P ∩ N(u), R + u)``, right ``(P - u, R)``, bounds
``-(|R| + 1 + deg u)`` and ``-(|R| + |P| - 1)``; terminal when P is empty,
with value ``-|R|``.  An empty mask branches on vertex 0 with degree -1.

An answer holds when its solution is a clique of the size it reports; a
claimed optimum has to equal :func:`optimum`, a plain branch and bound with
a greedy colouring bound (Tomita and Seki's scheme) over Python integers as
bitsets.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import bits
from perfbench.reference.expand import degrees, first, onehot, rows


def expand(A: torch.Tensor, m: torch.Tensor, s: torch.Tensor) -> dict:
    """The expansion of every row; ``in_mask`` is each row's candidate count
    (the vertices its degree panel reads)."""
    N = m.shape[-1]
    deg = degrees(A, m)
    pc_m, pc_s = m.sum(dim=-1), s.sum(dim=-1)
    top = deg.amax(dim=-1)
    u = first(deg == top[..., None])
    ub = onehot(u, N)
    return {
        "bound": -(pc_s + pc_m), "is_terminal": pc_m == 0,
        "terminal_value": -pc_s, "terminal_sol": s,
        "left_mask": rows(A, u) & m, "left_sol": s | ub,
        "right_mask": m & ~ub, "right_sol": s,
        "left_bound": -(pc_s + 1 + top), "right_bound": -(pc_s + pc_m - 1),
        "in_mask": pc_m,
    }


def infeasible(dense: np.ndarray, size: int, words) -> bool:
    """True when the solution is no clique of ``size`` vertices."""
    s = bits.solution(words, dense.shape[0], size)
    if s is None:
        return True
    sub = dense[np.ix_(s, s)]
    return not bool((sub | np.eye(len(sub), dtype=bool)).all())


def optimum(dense: np.ndarray) -> int:
    """ω(G) of a dense graph: the size a claimed optimum must have."""
    n = dense.shape[0]
    nbr = [sum(1 << int(u) for u in np.flatnonzero(dense[v])) for v in range(n)]
    best = 0

    def colour_order(cand: int):
        order, colour, left = [], 0, cand
        while left:
            colour += 1
            q = left
            while q:
                v = (q & -q).bit_length() - 1
                q &= ~nbr[v] & ~(1 << v)
                left &= ~(1 << v)
                order.append((v, colour))
        return order

    def grow(size: int, cand: int) -> None:
        nonlocal best
        for v, colour in reversed(colour_order(cand)):
            if size + colour <= best:
                return
            nxt = cand & nbr[v]
            if nxt:
                grow(size + 1, nxt)
            elif size + 1 > best:
                best = size + 1
            cand &= ~(1 << v)

    grow(0, (1 << n) - 1)
    return best
