"""Minimum vertex cover, written plainly: the expansion of a task and the
certificate of an answer.

One task (mask G, partial cover S), after the paper (§4.1, Chen-Kanj-Jia)
and the port's documented semantics, not its code:

* bound: ``|S| + ceil(E / maxdeg)`` over the raw mask (0 without edges);
* reduction, one rule a sweep, in priority order, until a sweep changes
  nothing (that sweep counted; at most N + 1 sweeps): (1) drop every
  isolated vertex; (2) the first vertex of degree 1: its neighbour joins S,
  both leave G; (3) the first vertex of degree 2 whose two neighbours are
  adjacent: both neighbours join S, all three leave G;
* branch on the first vertex u of maximum degree in the reduced mask:
  left ``(G - u, S + u)``, right ``(G - N[u], S + N(u))``, bounds ``|S| + 1``
  and ``|S| + deg u``; terminal when no edge is left, with value ``|S|``.

An answer holds when its solution covers every edge and has the size it
reports.  No optimum is computed: no plain solver proves one at the
configuration's size inside a run.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import bits
from perfbench.reference.expand import degrees, first, onehot, rows


def _vc_sweep(A, m, s):
    """One reduction sweep of every row -> (mask, cover, changed)."""
    B, R, N = m.shape
    mf = m.to(A.dtype)
    deg = torch.where(m, torch.bmm(mf, A).round().long(), -1)
    iso = deg == 0
    r1 = iso.any(dim=-1)

    u2 = first(deg == 1)
    r2 = u2 < N
    u2 = u2.clamp(max=N - 1)
    nb2 = rows(A, u2) & m

    # a degree-2 vertex's neighbours a < b from the sum and the sum of
    # squares of its neighbours' indices (exact in float64)
    idx = torch.arange(N, device=m.device, dtype=A.dtype)
    s1 = torch.bmm(mf * idx, A)
    s2 = torch.bmm(mf * idx * idx, A)
    gap = (2 * s2 - s1 * s1).clamp(min=0).sqrt()
    a = ((s1 - gap) / 2).round().long().clamp(0, N - 1)
    b = ((s1 + gap) / 2).round().long().clamp(0, N - 1)
    inst = torch.arange(B, device=m.device)[:, None, None]
    joined = A[inst, a, b] > 0.5
    u3 = first((deg == 2) & joined)
    r3 = u3 < N
    u3 = u3.clamp(max=N - 1)
    nb3 = rows(A, u3) & m

    r1, r2, r3 = r1[..., None], r2[..., None], r3[..., None]
    new_m = torch.where(r1, m & ~iso, torch.where(
        r2, m & ~(nb2 | onehot(u2, N)), torch.where(r3, m & ~(nb3 | onehot(u3, N)), m)))
    new_s = torch.where(r1, s, torch.where(r2, s | nb2, torch.where(r3, s | nb3, s)))
    return new_m, new_s, (r1 | r2 | r3)[..., 0]


def expand(A: torch.Tensor, m: torch.Tensor, s: torch.Tensor) -> dict:
    """The expansion of every row; also ``sweeps`` (each row's reduction
    trip count) and ``in_mask`` (the vertices in each row's mask summed over
    the sweeps the row runs)."""
    B, R, N = m.shape
    deg0 = degrees(A, m).clamp(min=0)
    maxdeg0 = deg0.amax(dim=-1)
    edges = deg0.sum(dim=-1) // 2
    ceil = -torch.div(-edges, maxdeg0.clamp(min=1), rounding_mode="floor")
    bound = s.sum(dim=-1) + torch.where(maxdeg0 > 0, ceil, 0)

    sweeps = torch.zeros((B, R), dtype=torch.long, device=m.device)
    in_mask = torch.zeros((B, R), dtype=torch.long, device=m.device)
    running = torch.ones((B, R), dtype=torch.bool, device=m.device)
    k = 0
    while k < N + 1:
        for _ in range(4):  # rows past their fixpoint stay as they are
            if k >= N + 1:
                break
            in_mask += torch.where(running, m.sum(dim=-1), 0)
            nm, ns, changed = _vc_sweep(A, m, s)
            keep = running[..., None]
            m, s = torch.where(keep, nm, m), torch.where(keep, ns, s)
            sweeps += running
            running &= changed
            k += 1
        if not bool(running.any()):
            break

    deg = degrees(A, m)
    maxdeg = deg.amax(dim=-1)
    u = first(deg == maxdeg[..., None])
    ub = onehot(u, N)
    nb = rows(A, u) & m
    size = s.sum(dim=-1)
    return {
        "bound": bound, "is_terminal": maxdeg <= 0,
        "terminal_value": size, "terminal_sol": s,
        "left_mask": m & ~ub, "left_sol": s | ub,
        "right_mask": m & ~(nb | ub), "right_sol": s | nb,
        "left_bound": size + 1, "right_bound": size + maxdeg,
        "sweeps": sweeps, "in_mask": in_mask,
    }


def infeasible(dense: np.ndarray, size: int, words) -> bool:
    """True when the solution is no cover of ``size`` vertices."""
    s = bits.solution(words, dense.shape[0], size)
    return s is None or bool((dense & ~s[:, None] & ~s[None, :]).any())
