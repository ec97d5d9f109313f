"""The BSP superstep of the semi-centralized strategy, P workers on one device.

The port of ``repro/core/superstep.py`` (solo plane).  The JAX package runs
one worker's superstep under ``vmap`` or ``shard_map`` and talks across
workers with ``all_gather``/``psum``/``pmin``; here the P workers are the
leading dimension of every state tensor, and those collectives become
reductions and gathers over that dimension.  One superstep =

  1. **explore** — each worker expands up to ``lanes`` of its deepest tasks
     for ``steps_per_round`` rounds; all P·lanes tasks of a round go through
     ONE batched ``expand_tasks`` (two ``batched_degrees`` kernel launches
     plus one per reduction sweep);
  2. **control plane** — per worker (pending, shallowest depth, local best),
     packed into one int32 per worker with ``packed_status``;
  3. **replicated center** — the idle->donor matching
     (:func:`match_idle_to_donors`), computed once from the (P,) table;
  4. **data plane** — matched donors pop up to ``donate_k`` shallowest tasks
     and each idle worker receives its donor's block.  On one device the
     delivery is a gather by ``recv_from`` for both ``transfer_impl``s; they
     differ in the payload they account for, as in the JAX package
     (``sparse``: the matched records; ``gather``: the whole P·k table);
  5. **best-value broadcast** — the min over workers.

A round with no match leaves the state exactly as the skipped JAX transfer
does (the pops and pushes are masked to nothing), so the port runs the data
plane unconditionally and gates only the transfer counters: no host sync.

Every integer is pinned to the JAX package's dtype (int32), so wraparound
matches, e.g. in ``donor_key = top_depth * P + idx``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.frontier import (
    Frontier,
    pending_per_worker,
    pop_deepest_cheap,
    pop_k_shallowest,
    push_many,
    top_priority_depth,
)
from repro_torch.problems.base import (
    BranchingProblem,
    ProblemData,
    WorkCounters,
    resolve_expand,
)

# the JAX package's registries of the two hot-path knobs; the port runs
# "fused" and refuses "reference" (ROADMAP queue 1, item 3)
EXPLORE_IMPLS = ("fused", "reference")
TRANSFER_IMPLS = ("sparse", "gather")


class WorkerState(NamedTuple):
    """Every worker's state; each leaf has a leading (P,) worker axis."""

    frontier: Frontier
    best_val: torch.Tensor  # (P,) int32 -- global best seen
    local_best_val: torch.Tensor  # (P,) int32 -- best found by this worker
    best_sol: torch.Tensor  # (P, W) int32 -- the cover achieving local_best_val
    nodes_expanded: torch.Tensor  # (P,) int32
    tasks_sent: torch.Tensor  # (P,) int32
    tasks_recv: torch.Tensor  # (P,) int32
    rounds: torch.Tensor  # (P,) int32 -- also the round-robin policy's salt
    transfer_rounds: torch.Tensor  # (P,) int32 -- rounds that ran the data plane
    payload_words: torch.Tensor  # (P,) int32 -- u32 words the data plane moved


def state_to(state: WorkerState, device) -> WorkerState:
    """``state`` with every leaf on ``device``."""
    return WorkerState(
        Frontier(*[x.to(device) for x in state.frontier]),
        *[x.to(device) for x in state[1:]],
    )


def _check_knobs(explore_impl: str, transfer_impl: str, donate_k: int) -> None:
    if transfer_impl not in TRANSFER_IMPLS:
        raise ValueError(
            f"unknown transfer_impl: {transfer_impl!r}; "
            f"valid: {', '.join(TRANSFER_IMPLS)}"
        )
    if explore_impl not in EXPLORE_IMPLS:
        raise ValueError(
            f"unknown explore_impl: {explore_impl!r}; "
            f"valid: {', '.join(EXPLORE_IMPLS)}"
        )
    if explore_impl != "fused":
        raise NotImplementedError(
            f"explore_impl={explore_impl!r} is not ported to repro_torch yet "
            f"(ROADMAP queue 1, item 3: pop_deepest with a full sort); "
            f"use 'fused', which gives the same trajectory"
        )
    if donate_k < 1:
        raise ValueError(f"donate_k must be >= 1, got {donate_k}")


# -- phase 1: exploration ------------------------------------------------------


def _explore_one_round(
    problem: BranchingProblem,
    data: ProblemData,
    state: WorkerState,
    lanes: int,
    counters: WorkCounters | None = None,
) -> WorkerState:
    """Each worker pops up to ``lanes`` deepest tasks; all P·lanes tasks are
    expanded in one batch; children are pushed back per worker."""
    f, masks, sols, depths, valid = pop_deepest_cheap(state.frontier, lanes)
    P, L, W = masks.shape
    ex = resolve_expand(problem)(
        data, masks.reshape(P * L, W), sols.reshape(P * L, W), counters=counters
    )
    res = ex.step
    bounds = ex.bound.view(P, L)
    is_terminal = res.is_terminal.view(P, L)
    terminal_value = res.terminal_value.view(P, L)
    best = state.best_val[:, None]

    not_pruned = valid & (bounds < best)

    # terminal candidates -> best update (the first lane of the least value)
    term = not_pruned & is_terminal & (terminal_value < best)
    term_val = torch.where(term, terminal_value, 1 << 30)
    found_val = term_val.amin(dim=-1)  # (P,) 1<<30 when no lane found one
    lane_idx = torch.arange(L, device=masks.device)
    li = torch.where(term_val == found_val[:, None], lane_idx, L).amin(dim=-1)
    workers = torch.arange(P, device=masks.device)
    found_sol = res.terminal_sol.view(P, L, W)[workers, li]
    new_sol = torch.where(
        (found_val < state.local_best_val)[:, None], found_sol, state.best_sol
    )
    new_local = torch.minimum(state.local_best_val, found_val)
    new_best = torch.minimum(state.best_val, found_val)

    # children: [left_0..left_L, right_0..right_L], pruned at birth when the
    # cheap bound cannot beat the best
    expandable = not_pruned & ~is_terminal
    cdepth = depths + 1
    lvalid = expandable & (ex.left_bound.view(P, L) < new_best[:, None])
    rvalid = expandable & (ex.right_bound.view(P, L) < new_best[:, None])
    f = push_many(
        f,
        torch.cat([res.left_mask.view(P, L, W), res.right_mask.view(P, L, W)], 1),
        torch.cat([res.left_sol.view(P, L, W), res.right_sol.view(P, L, W)], 1),
        torch.cat([cdepth, cdepth], 1),
        torch.cat([lvalid, rvalid], 1),
    )
    return state._replace(
        frontier=f,
        best_val=new_best,
        local_best_val=new_local,
        best_sol=new_sol,
        nodes_expanded=state.nodes_expanded + valid.sum(dim=-1, dtype=torch.int32),
    )


# -- phase 3: the replicated center -------------------------------------------


def match_idle_to_donors(
    pending: torch.Tensor,  # (P,) int32
    top_depth: torch.Tensor,  # (P,) int32 (BIG_DEPTH, or its clamp, when empty)
    policy_priority: bool,
    round_idx: torch.Tensor,  # () int32 -- salt for the round-robin policy
):
    """The center's `getNextWorkingNode`: the idle->donor matching.

    Returns (send_to, recv_from): per-worker partner index or -1.  Donors
    need pending >= 2 (donate one, keep one — failure-free).  'priority'
    ranks donors by (shallowest pending depth, index); 'random' by a
    round-salted rotation of the index."""
    P = pending.shape[0]
    dev = pending.device
    idx = torch.arange(P, dtype=torch.int32, device=dev)
    idle = pending == 0
    donor = pending >= 2

    idle_rank = torch.where(idle, idle.cumsum(0, dtype=torch.int32) - 1, -1)

    if policy_priority:
        donor_key = top_depth * P + idx  # int32, wraps as the JAX key does
    else:
        donor_key = (idx + round_idx) % P
    donor_key = torch.where(donor, donor_key, 1 << 30)
    donor_order = torch.argsort(donor_key, stable=True)  # jnp.argsort is stable
    donor_rank = torch.empty_like(idx).scatter_(0, donor_order, idx)
    donor_rank = torch.where(donor, donor_rank, -1)

    n_match = torch.minimum(
        idle.sum(dtype=torch.int32), donor.sum(dtype=torch.int32)
    )

    def by_rank(member, rank):
        # rank -> worker index; non-members land in the extra slot P
        out = torch.zeros((P + 1,), dtype=torch.int32, device=dev)
        out.scatter_(0, torch.where(member, rank, P).long(), idx)
        return out[:P]

    idle_by_rank = by_rank(idle, idle_rank)
    donor_by_rank = by_rank(donor, donor_rank)
    send_to = torch.where(
        donor & (donor_rank < n_match),
        idle_by_rank[donor_rank.clamp(0, P - 1).long()],
        -1,
    )
    recv_from = torch.where(
        idle & (idle_rank < n_match),
        donor_by_rank[idle_rank.clamp(0, P - 1).long()],
        -1,
    )
    return send_to, recv_from


# -- the full superstep ---------------------------------------------------------


def superstep(
    problem: BranchingProblem,
    data: ProblemData,
    state: WorkerState,
    *,
    steps_per_round: int,
    lanes: int,
    policy_priority: bool = True,
    transfer_pad_words: int = 0,
    packed_status: bool = True,
    skip_empty_transfer: bool = True,
    transfer_impl: str = "sparse",
    donate_k: int = 1,
    explore_impl: str = "fused",
    counters: WorkCounters | None = None,
):
    """One BSP round for all P workers.  Returns (state, done) where done is
    a () bool tensor: nothing pending anywhere after the transfer phase.

    ``transfer_pad_words`` is the codec's payload on top of the native
    (mask, sol, depth) record (the basic encoding's n·W words): it counts
    in ``payload_words`` and carries no state."""
    _check_knobs(explore_impl, transfer_impl, donate_k)
    P, W = state.best_sol.shape
    dev = state.best_sol.device
    rec_words = 2 * W + 1 + transfer_pad_words

    # 1. explore
    for _ in range(steps_per_round):
        state = _explore_one_round(problem, data, state, lanes, counters)

    # 2. control plane through the center + 5. best-value broadcast
    pending = pending_per_worker(state.frontier)
    top_depth = top_priority_depth(state.frontier)
    if packed_status:
        # one i32 per worker: pending (15b) | clamped depth (16b)
        word = (pending.clamp(0, 0x7FFF) << 16) | top_depth.clamp(0, 0xFFFF)
        pend_t = word >> 16
        depth_t = word & 0xFFFF
        global_best = (
            torch.minimum(state.local_best_val, state.best_val).amin().expand(P)
        )
    else:
        pend_t, depth_t = pending, top_depth
        global_best = torch.minimum(state.local_best_val.amin(), state.best_val)
    state = state._replace(best_val=global_best.contiguous())

    # 3. the replicated center (rounds is the same on every worker)
    send_to, recv_from = match_idle_to_donors(
        pend_t, depth_t, policy_priority, state.rounds[0]
    )
    matched = send_to >= 0
    n_match = matched.sum(dtype=torch.int32)
    # records each donor ships (>= 1 when matched: pending >= 2)
    n_don = torch.where(matched, torch.clamp(pend_t - 1, max=donate_k), 0)

    # 4. data plane: donors pop their shallowest block, receivers push it
    f2, d_masks, d_sols, d_depths, _ = pop_k_shallowest(
        state.frontier, donate_k, limit=n_don
    )
    src = recv_from.clamp(0, P - 1).long()
    ks = torch.arange(donate_k, device=dev)
    recv_valid = (recv_from >= 0)[:, None] & (ks[None, :] < n_don[src][:, None])
    f3 = push_many(f2, d_masks[src], d_sols[src], d_depths[src], recv_valid)
    if transfer_impl == "gather":
        moved_words = torch.full(
            (), P * donate_k * rec_words, dtype=torch.int32, device=dev
        )
    else:
        moved_words = n_don.sum(dtype=torch.int32) * rec_words
    if skip_empty_transfer:
        ran = n_match > 0
    else:
        ran = torch.ones((), dtype=torch.bool, device=dev)
    state = state._replace(
        frontier=f3,
        tasks_sent=state.tasks_sent + n_don,
        tasks_recv=state.tasks_recv + recv_valid.sum(dim=-1, dtype=torch.int32),
        transfer_rounds=state.transfer_rounds + ran.to(torch.int32),
        payload_words=state.payload_words + torch.where(ran, moved_words, 0),
        rounds=state.rounds + 1,
    )

    # exact termination: nothing pending anywhere after the transfer phase
    done = pending_per_worker(state.frontier).sum() == 0
    return state, done


def build_plane_fn(
    problem: BranchingProblem,
    *,
    steps_per_round: int,
    lanes: int,
    policy_priority: bool = True,
    transfer_pad_words: int = 0,
    packed_status: bool = True,
    skip_empty_transfer: bool = True,
    transfer_impl: str = "sparse",
    donate_k: int = 1,
    explore_impl: str = "fused",
    chunk_rounds: int = 16,
    use_fpt: bool = False,
    counters: WorkCounters | None = None,
):
    """Solo chunk runner: ``(data, state[, fpt_bound]) -> (state, done, ran,
    hot)`` running up to ``chunk_rounds`` supersteps.

    The JAX package runs the chunk as a device ``while_loop``; here the host
    reads ``done`` once per superstep, so the chunk stops on exactly the
    superstep where the JAX loop stops and ``ran`` matches.  ``done`` also
    holds when, with ``use_fpt``, some worker's best reached the INTERNAL
    decision target ``fpt_bound``.  ``hot`` is the (P,) pending count."""
    if chunk_rounds < 1:
        raise ValueError(f"chunk_rounds must be >= 1, got {chunk_rounds}")
    _check_knobs(explore_impl, transfer_impl, donate_k)

    def run(data: ProblemData, state: WorkerState, fpt_bound=None):
        done, ran = False, 0
        while not done and ran < chunk_rounds:
            state, step_done = superstep(
                problem,
                data,
                state,
                steps_per_round=steps_per_round,
                lanes=lanes,
                policy_priority=policy_priority,
                transfer_pad_words=transfer_pad_words,
                packed_status=packed_status,
                skip_empty_transfer=skip_empty_transfer,
                transfer_impl=transfer_impl,
                donate_k=donate_k,
                explore_impl=explore_impl,
                counters=counters,
            )
            if use_fpt:
                step_done = step_done | (state.best_val.amin() <= fpt_bound)
            done = bool(step_done)
            ran += 1
        return state, done, ran, pending_per_worker(state.frontier)

    return run


# -- (de)serialization ---------------------------------------------------------
#
# The same flat {name: np.ndarray} layout as the JAX package's
# ``worker_state_to_flat``/``worker_state_from_flat`` (superstep.py:924,937):
# packed words are uint32 there and int32 here, with the same bits.

_U32_LEAVES = ("frontier.masks", "frontier.sols", "best_sol")


def worker_state_to_flat(state: WorkerState, prefix: str = "worker") -> dict:
    """All P workers' state as named host arrays (one device fetch)."""
    leaves = {
        **{f"frontier.{k}": v for k, v in state.frontier._asdict().items()},
        **{k: v for k, v in state._asdict().items() if k != "frontier"},
    }
    flat = {}
    for name, leaf in leaves.items():
        arr = leaf.detach().cpu().numpy()
        if name in _U32_LEAVES:
            arr = arr.view(np.uint32)
        flat[f"{prefix}.{name}"] = arr
    return flat


def worker_state_from_flat(flat: dict, device, prefix: str = "worker") -> WorkerState:
    def leaf(name):
        arr = np.ascontiguousarray(flat[f"{prefix}.{name}"])
        if name in _U32_LEAVES:
            arr = arr.astype(np.uint32, copy=False).view(np.int32)
        return torch.from_numpy(arr.copy()).to(device)

    frontier = Frontier(**{k: leaf(f"frontier.{k}") for k in Frontier._fields})
    rest = {k: leaf(k) for k in WorkerState._fields if k != "frontier"}
    return WorkerState(frontier=frontier, **rest)
