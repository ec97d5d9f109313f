"""What every problem's plain expansion shares, on unpacked sets.

A batch of task rows is ``(B, R, N)`` bool: R rows for each of B
instances, whose 0/1 adjacency ``A`` is ``(B, N, N)`` float64.  Degrees
within a row's mask are one batched matrix product (exact in float64), so a
step over every row of a batch is a handful of whole-batch operations.
Each problem's expansion (``reference/problems/<problem>.py``'s
``expand``) returns the fields below as sets and per-row numbers, plus
``in_mask``: the vertices whose adjacency rows it reads, the work that a
kernel's roofline counts.  Every "first" vertex is the lowest index.
"""

from __future__ import annotations

import torch

# the fields each expansion produces, and which rows read them
ALL_ROWS = ("bound", "is_terminal")
TERMINAL_ROWS = ("terminal_value", "terminal_sol")
BRANCH_ROWS = ("left_mask", "left_sol", "right_mask", "right_sol", "left_bound", "right_bound")


def first(cond: torch.Tensor) -> torch.Tensor:
    """(..., N) bool -> (...,) int64: the lowest index where cond holds, N if none."""
    N = cond.shape[-1]
    idx = torch.arange(N, device=cond.device)
    return torch.where(cond, idx, N).amin(dim=-1)


def onehot(u: torch.Tensor, N: int) -> torch.Tensor:
    return torch.arange(N, device=u.device) == u[..., None]


def rows(A: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Adjacency rows ``A[b, u[b, r]]`` -> (B, R, N) bool."""
    return torch.gather(A, 1, u[..., None].expand(*u.shape, A.shape[-1])) > 0.5


def degrees(A: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Each vertex's neighbours within its row's mask; -1 outside the mask."""
    d = torch.bmm(m.to(A.dtype), A).round().long()
    return torch.where(m, d, -1)


def rows_differ(ref: dict, got: dict) -> torch.Tensor:
    """(B, R) bool: rows where the program's expansion ``got`` (the same
    keys, unpacked to sets) differs from the reference in a field that the
    row's outcome reads: every row its bound, terminal flag and, where the
    program reports one, trip count; a terminal row its value and solution;
    any other row its two children and their bounds."""
    def differ(name):
        a, b = ref[name], got[name]
        d = a != b.to(a.dtype)
        return d.any(dim=-1) if d.dim() == 3 else d

    term = ref["is_terminal"]
    bad = torch.zeros_like(term)
    for name in ALL_ROWS + (("sweeps",) if "sweeps" in got else ()):
        bad |= differ(name)
    for name in TERMINAL_ROWS:
        bad |= term & differ(name)
    for name in BRANCH_ROWS:
        bad |= ~term & differ(name)
    return bad
