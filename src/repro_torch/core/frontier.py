"""Fixed-capacity per-worker task frontiers, batched over P workers.

The port of ``repro/core/frontier.py``.  The JAX package writes each op for
one worker and vmaps it; here the worker axis is a real leading tensor
dimension, so every op takes and returns ``(P, CAP, ...)`` pools:

* **explore** pops each worker's *deepest* active tasks (DFS, the paper's
  caterpillar spine): :func:`pop_deepest_cheap` on the fused plane, the
  full-capacity sort :func:`pop_deepest` on the reference one;
* **donate** pops each donor's *shallowest* tasks (Alg. 6, batched) with
  :func:`pop_k_shallowest` (one task: :func:`pop_shallowest`);
* :func:`push_many_` places children into free slots in slot order, in
  place, and counts what it could not place (``dropped``), so saturation
  is never silent; :func:`push_many` is its functional form.

Tie orders are those of the JAX package: among equal depths the lower slot
wins (``lax.top_k`` order; torch's ``topk`` promises none, so the port uses
a stable sort or explicit first indices).  JAX drops out-of-range scatter
writes (``mode="drop"``); torch raises on them, so those writes are masked
explicitly here.

The ``_b`` views take a (B, P, CAP, ...) pool of B instances, the batched
plane's lane state, where the JAX package vmaps once more over instances.

The spill boundary (:func:`read_pool`, :func:`write_pool` and their lane
forms) moves one instance's pool between the device and host numpy for the
cold tier's pump (``repro_torch.core.spill``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
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


def make_frontier(num_workers: int, capacity: int, W: int, device) -> Frontier:
    """P empty pools of ``capacity`` slots on ``device``."""
    P = num_workers
    return Frontier(
        masks=torch.zeros((P, capacity, W), dtype=torch.int32, device=device),
        sols=torch.zeros((P, capacity, W), dtype=torch.int32, device=device),
        depths=torch.zeros((P, capacity), dtype=torch.int32, device=device),
        active=torch.zeros((P, capacity), dtype=torch.bool, device=device),
        overflow=torch.zeros((P,), dtype=torch.bool, device=device),
        dropped=torch.zeros((P,), dtype=torch.int32, device=device),
    )


def pending_per_worker(f: Frontier) -> torch.Tensor:
    """Pending tasks summed over the slot axis only: (P,) int32 for a
    (P, CAP) pool, (B, P) for a stacked one."""
    return f.active.sum(dim=-1, dtype=torch.int32)


def pending_per_instance(f: Frontier) -> torch.Tensor:
    """(B,) int32 pending tasks per instance lane of a (B, P, CAP) stacked
    pool: the slot and worker axes are reduced."""
    return f.active.sum(dim=(-1, -2), dtype=torch.int32)


def top_priority_depth(f: Frontier) -> torch.Tensor:
    """(P,) depth of each worker's shallowest pending task; BIG_DEPTH if
    empty."""
    return torch.where(f.active, f.depths, BIG_DEPTH).amin(dim=-1)


def _take(rows: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """rows (P, CAP, ...) at slots (P, K) -> (P, K, ...)."""
    workers = torch.arange(rows.shape[0], device=rows.device)[:, None]
    return rows[workers, slots]


def _pop_slots(f: Frontier, slots: torch.Tensor):
    """Pop ``slots`` ((P, K), distinct per worker): (frontier, masks (P, K,
    W), sols, depths (P, K), valid (P, K) -- the slots that were active)."""
    return (
        f._replace(active=f.active.scatter(1, slots, False)),
        _take(f.masks, slots),
        _take(f.sols, slots),
        _take(f.depths, slots),
        f.active.gather(1, slots),
    )


def pop_deepest(f: Frontier, count: int):
    """Pop up to ``count`` deepest tasks per worker: the reference plane's
    full-capacity selection (``lax.top_k`` in the JAX package).

    Slots come deepest first, the lower slot first among equal depths
    (``top_k``'s order, from a stable sort of the key ``where(active,
    depth, -1)``); a worker with fewer active tasks gets its lowest inactive
    slots after them, ``valid`` False.  Requires ``count <= capacity``.

    Returns (frontier, masks (P, count, W), sols, depths (P, count),
    valid (P, count) bool)."""
    key = torch.where(f.active, f.depths, -1)
    slots = torch.argsort(key, dim=-1, descending=True, stable=True)[:, :count]
    return _pop_slots(f, slots)


def pop_shallowest(f: Frontier):
    """Pop each worker's single shallowest task (the donation, Alg. 6): the
    first slot of least depth (``jnp.argmin``'s), slot 0 and ``valid``
    False for an empty worker.

    Returns (frontier, mask (P, W), sol (P, W), depth (P,), valid (P,))."""
    cap = f.capacity
    key = torch.where(f.active, f.depths, BIG_DEPTH)
    least = key.amin(dim=-1, keepdim=True)
    idx = torch.arange(cap, device=key.device)
    slot = torch.where(key == least, idx, cap).amin(dim=-1, keepdim=True)
    f, masks, sols, depths, valid = _pop_slots(f, slot)
    return f, masks[:, 0], sols[:, 0], depths[:, 0], valid[:, 0]


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


def push_many_(f: Frontier, masks, sols, depths, valid) -> Frontier:
    """Push up to K tasks per worker (``valid`` (P, K) marks real ones)
    into ``f``'s own tensors, in place; returns ``f``.

    Free slots are filled in slot order with the valid tasks in task order;
    tasks beyond the free slots are dropped, setting ``overflow`` and
    adding the exact count to ``dropped``.  The work scales with what is
    pushed, (P, K, W), and the pool is only read at the K target rows:

    * the r-th valid task goes to the first slot whose running count of
      free slots reaches r (one ``searchsorted`` per worker over the
      (P, CAP) counts);
    * each task adds ``new - old`` into its target row (``scatter_add_``,
      exact in wrapping int32).  A task that is not placed adds zero to some
      row (its clamped target), so it writes nothing, needs no out-of-range
      index and no host sync, whichever rows it shares.

    ``masks``, ``sols``, ``depths`` must not alias ``f``'s tensors."""
    cap = f.capacity
    free_count = (~f.active).cumsum(dim=-1, dtype=torch.int32)  # (P, CAP), nondecreasing
    task_count = valid.cumsum(dim=-1, dtype=torch.int32)  # (P, K)
    n_free, n_valid = free_count[:, -1:], task_count[:, -1:]
    placeable = valid & (task_count <= n_free)
    tgt = torch.searchsorted(free_count, task_count).clamp_(max=cap - 1)  # (P, K)

    def place(pool, rows):  # rows (P, K, ...) into pool (P, CAP, ...)
        tail = (1,) * (rows.dim() - 2)
        idx = tgt.view(*tgt.shape, *tail).expand_as(rows)
        keep = placeable.view(*placeable.shape, *tail)
        pool.scatter_add_(1, idx, torch.where(keep, rows - pool.gather(1, idx), 0))

    place(f.masks, masks)
    place(f.sols, sols)
    place(f.depths, depths.to(torch.int32))
    # a free slot is taken iff no more free slots than valid tasks reach it;
    # the valid tasks beyond the free slots are dropped
    f.active.logical_or_(free_count <= n_valid)
    n_dropped = (n_valid - n_free).clamp_(min=0)[:, 0]
    f.overflow.logical_or_(n_dropped > 0)
    f.dropped.add_(n_dropped)
    return f


def push_many(f: Frontier, masks, sols, depths, valid) -> Frontier:
    """:func:`push_many_` into a copy of ``f``: ``f`` is left as it was.

    The JAX package writes the same push as a scatter with
    ``mode="drop"``; this form gives the same pool leaf for leaf."""
    return push_many_(Frontier(*(x.clone() for x in f)), masks, sols, depths, valid)


def push_one(f: Frontier, mask, sol, depth, valid) -> Frontier:
    """Push one task per worker: ``mask``/``sol`` (P, W), ``depth`` and
    ``valid`` (P,)."""
    return push_many(f, mask[:, None], sol[:, None], depth[:, None], valid[:, None])


# -- batched (instance-axis) views ---------------------------------------------


def _flat(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0] * x.shape[1], *x.shape[2:])


def _unflat(x: torch.Tensor, B: int) -> torch.Tensor:
    return x.view(B, x.shape[0] // B, *x.shape[1:])


def _batched(op, f: Frontier, *args):
    """``op`` over the B·P workers of a (B, P, ...) pool; every output
    regains the (B, P) lead."""
    B = f.active.shape[0]
    out = op(Frontier(*map(_flat, f)), *args)
    f2, rest = out[0], out[1:]
    return (Frontier(*(_unflat(x, B) for x in f2)), *(_unflat(x, B) for x in rest))


def pop_deepest_b(f: Frontier, count: int):
    """:func:`pop_deepest` of every worker of a (B, P, ...) stacked pool;
    outputs lead with (B, P)."""
    return _batched(pop_deepest, f, count)


def pop_k_shallowest_b(f: Frontier, count: int, limit: torch.Tensor):
    """:func:`pop_k_shallowest` of a (B, P, ...) stacked pool, ``limit``
    (B, P)."""
    return _batched(pop_k_shallowest, f, count, _flat(limit))


def push_many_b(f: Frontier, masks, sols, depths, valid) -> Frontier:
    """:func:`push_many` into a (B, P, ...) stacked pool: ``masks``/``sols``
    (B, P, K, W), ``depths``/``valid`` (B, P, K)."""
    B = f.active.shape[0]
    out = push_many(Frontier(*map(_flat, f)), *map(_flat, (masks, sols, depths, valid)))
    return Frontier(*(_unflat(x, B) for x in out))


# -- the spill boundary --------------------------------------------------------
#
# The hierarchical frontier memory (repro_torch.core.spill) moves task records
# across the host/device boundary between chunks: the pump reads a pool,
# mutates it with numpy and writes it back in place.  A read copies the four
# pool leaves into pinned host buffers and waits once; a write issues the
# four copies and waits once, so the host arrays may change after it
# returns.  Packed words are int32 on the device and uint32 on the host, the
# same bits (a view, never a conversion by value).  ``overflow``/``dropped``
# are left untouched: with spill enabled they must stay zero (the no-drop
# guarantee), and a nonzero value surviving the pump is a fault the tests
# would catch.


def _pool_leaves(f: Frontier, lane) -> tuple:
    leaves = (f.masks, f.sols, f.depths, f.active)
    return leaves if lane is None else tuple(x[lane] for x in leaves)


def _wait(x: torch.Tensor) -> None:
    if x.is_cuda:
        torch.cuda.current_stream(x.device).synchronize()


def read_pool(f: Frontier, lane: int | None = None) -> tuple:
    """The (P, CAP, ...) task pool of a solo frontier, or of ``lane`` of a
    (B, P, CAP, ...) stacked one, as host numpy arrays ``(masks, sols,
    depths, active)``: masks and sols uint32, depths int32, active bool.
    One device synchronisation."""
    src = _pool_leaves(f, lane)
    pin = src[0].is_cuda
    host = [torch.empty(x.shape, dtype=x.dtype, pin_memory=pin) for x in src]
    for h, x in zip(host, src):
        h.copy_(x, non_blocking=pin)
    _wait(src[0])
    m, s, d, a = (h.numpy() for h in host)
    return m.view(np.uint32), s.view(np.uint32), d, a


def write_pool(f: Frontier, masks, sols, depths, active,
               lane: int | None = None) -> Frontier:
    """Write host pool arrays back into a solo frontier (or into ``lane``
    of a stacked one), in place; returns ``f``.  The solo spill pump's
    write-back (``lane`` given: the lane pump's)."""
    dst = _pool_leaves(f, lane)
    src = (
        np.asarray(masks, np.uint32).view(np.int32),
        np.asarray(sols, np.uint32).view(np.int32),
        np.asarray(depths, np.int32),
        np.asarray(active, bool),
    )
    for x, arr in zip(dst, src):
        x.copy_(torch.from_numpy(np.ascontiguousarray(arr)), non_blocking=x.is_cuda)
    _wait(dst[0])
    return f


def read_lane_pool(f: Frontier, lane: int) -> tuple:
    """One lane's (P, CAP, ...) pool of a (B, P, CAP, ...) stacked frontier
    as host arrays — the live plane's spill-pump fetch."""
    return read_pool(f, lane)


def write_lane_pool(f: Frontier, lane: int, masks, sols, depths, active) -> Frontier:
    """Write one lane's pool back into a (B, P, CAP, ...) stacked frontier,
    in place; returns ``f``."""
    return write_pool(f, masks, sols, depths, active, lane)
