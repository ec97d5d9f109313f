"""Fixed-capacity per-worker task frontiers, batched over P workers.

The port of ``repro/core/frontier.py``.  The JAX package writes each op for
one worker and vmaps it; here the worker axis is a real leading tensor
dimension, so every op takes and returns ``(P, CAP, ...)`` pools:

* **explore** pops each worker's *deepest* active tasks (DFS, the paper's
  caterpillar spine) with :func:`pop_deepest_cheap`;
* **donate** pops each donor's *shallowest* tasks (Alg. 6, batched) with
  :func:`pop_k_shallowest`;
* :func:`push_many` places children into free slots in slot order and
  counts what it could not place (``dropped``), so saturation is never
  silent.

Tie orders are those of the JAX package: among equal depths the lower slot
wins (``lax.top_k`` order; torch's ``topk`` promises none, so the port uses
a stable sort or explicit first indices).  JAX drops out-of-range scatter
writes (``mode="drop"``); torch raises on them, so those writes are masked
explicitly here.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

BIG_DEPTH = 1 << 30


class Frontier(NamedTuple):
    masks: torch.Tensor  # (P, CAP, W) int32
    sols: torch.Tensor  # (P, CAP, W) int32
    depths: torch.Tensor  # (P, CAP) int32
    active: torch.Tensor  # (P, CAP) bool
    overflow: torch.Tensor  # (P,) bool -- a push was ever dropped
    dropped: torch.Tensor  # (P,) int32 -- cumulative count of dropped pushes

    @property
    def capacity(self) -> int:
        return self.depths.shape[-1]


def pending_per_worker(f: Frontier) -> torch.Tensor:
    """(P,) int32 pending tasks per worker."""
    return f.active.sum(dim=-1, dtype=torch.int32)


def top_priority_depth(f: Frontier) -> torch.Tensor:
    """(P,) depth of each worker's shallowest pending task; BIG_DEPTH if
    empty."""
    return torch.where(f.active, f.depths, BIG_DEPTH).amin(dim=-1)


def _take(rows: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """rows (P, CAP, ...) at slots (P, K) -> (P, K, ...)."""
    workers = torch.arange(rows.shape[0], device=rows.device)[:, None]
    return rows[workers, slots]


def pop_deepest_cheap(f: Frontier, count: int):
    """Pop up to ``count`` deepest tasks per worker without a sort.

    Per lane: one max-reduce finds the deepest pending depth and one
    max-reduce over the reversed slot index picks the lowest slot in that
    bucket, i.e. (depth desc, slot asc) order.  A worker with nothing left
    gets slot 0 and ``valid`` False, as ``jnp.argmax`` of an all-(-1) row
    gives in the JAX package.

    Returns (frontier, masks (P, count, W), sols, depths (P, count),
    valid (P, count) bool)."""
    cap = f.capacity
    rev = torch.arange(cap - 1, -1, -1, dtype=torch.int32, device=f.depths.device)
    act = f.active
    slots_l, valids_l = [], []
    for _ in range(count):
        d = torch.where(act, f.depths, -1).amax(dim=-1)  # (P,)
        r = torch.where(act & (f.depths == d[:, None]), rev, -1).amax(dim=-1)
        s = torch.where(r >= 0, cap - 1 - r, 0).long()
        slots_l.append(s)
        valids_l.append(d >= 0)
        if count > 1:
            act = act.scatter(1, s[:, None], False)
    slots = torch.stack(slots_l, dim=1)  # (P, count)
    valid = torch.stack(valids_l, dim=1)
    return (
        f._replace(active=f.active.scatter(1, slots, False)),
        _take(f.masks, slots),
        _take(f.sols, slots),
        _take(f.depths, slots),
        valid,
    )


def pop_k_shallowest(f: Frontier, count: int, limit=None):
    """Pop up to ``count`` shallowest tasks per worker (multi-task donation).

    ``limit`` ((P,) int32) caps how many of the ``count`` candidates each
    worker really removes.  Slots come shallowest first, lower slot first
    among equal depths (``lax.top_k``'s order, from a stable sort).

    Returns (frontier, masks (P, count, W), sols, depths (P, count),
    valid (P, count) bool)."""
    key = torch.where(f.active, f.depths, BIG_DEPTH)
    slots = torch.argsort(key, dim=-1, stable=True)[:, :count]
    was_active = f.active.gather(1, slots)
    valid = was_active
    if limit is not None:
        ks = torch.arange(count, device=key.device)
        valid = valid & (ks[None, :] < limit[:, None])
    # slots are unique per worker; rows beyond ``limit`` stay active
    new_active = f.active.scatter(1, slots, was_active & ~valid)
    return (
        f._replace(active=new_active),
        _take(f.masks, slots),
        _take(f.sols, slots),
        _take(f.depths, slots),
        valid,
    )


def push_many(f: Frontier, masks, sols, depths, valid) -> Frontier:
    """Push up to K tasks per worker (``valid`` (P, K) marks real ones).

    Free slots are filled in slot order with the valid tasks in task order;
    tasks beyond the free slots are dropped, setting ``overflow`` and
    adding the exact count to ``dropped``.  Written as a gather (each free
    slot of rank r takes the placeable task of rank r) so that no write
    needs an out-of-range target."""
    P, cap = f.active.shape
    K = valid.shape[1]
    dev = valid.device
    free = ~f.active
    free_rank = free.cumsum(dim=-1, dtype=torch.int32) - 1  # (P, CAP)
    task_rank = valid.cumsum(dim=-1, dtype=torch.int32) - 1  # (P, K)
    n_free = free.sum(dim=-1, dtype=torch.int32)
    placeable = valid & (task_rank < n_free[:, None])
    n_dropped = (valid & ~placeable).sum(dim=-1, dtype=torch.int32)
    n_place = placeable.sum(dim=-1, dtype=torch.int32)
    # task index of each placeable rank; column K collects the rest
    task_of_rank = torch.zeros((P, K + 1), dtype=torch.int64, device=dev)
    task_of_rank.scatter_(
        1,
        torch.where(placeable, task_rank, K).long(),
        torch.arange(K, device=dev).expand(P, K),
    )
    gets = free & (free_rank < n_place[:, None])  # (P, CAP)
    src = task_of_rank.gather(1, free_rank.clamp(0, max(K - 1, 0)).long())
    return f._replace(
        masks=torch.where(gets[..., None], _take(masks, src), f.masks),
        sols=torch.where(gets[..., None], _take(sols, src), f.sols),
        depths=torch.where(gets, _take(depths.to(torch.int32), src), f.depths),
        active=f.active | gets,
        overflow=f.overflow | (n_dropped > 0),
        dropped=f.dropped + n_dropped,
    )
