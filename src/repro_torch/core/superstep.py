"""The BSP superstep of the semi-centralized strategy, B instances of P
workers on one device.

The port of ``repro/core/superstep.py`` (solo and batch planes).  The JAX
package runs one worker's superstep under ``vmap`` or ``shard_map``, talks
across workers with ``all_gather``/``psum``/``pmin``, and vmaps that again
over an instance axis for ``solve_many``.  Here one superstep serves both:
the state's leading axis is the B·P workers of B instances, instance-major
(the solo plane is B = 1).  Exploration and the frontier act per worker on
that axis unchanged; only the center (the matching, the best-value
broadcast, ``done``) works per instance, on a (B, P) view, so donation never
crosses instances.  One superstep =

  1. **explore** — each worker expands up to ``lanes`` of its deepest tasks
     for ``steps_per_round`` rounds; all B·P·lanes tasks of a round go
     through ONE batched expansion, each task row reading its own
     instance's adjacency.  ``explore_impl="fused"`` pops with
     :func:`pop_deepest_cheap` and expands with the plugin's
     ``expand_tasks`` (vertex cover: one ``vc_expand`` launch, its
     reduction loop included; max clique and MIS: one ``clique_expand``
     launch); ``"reference"`` pops with the full sort :func:`pop_deepest`
     and always composes ``task_bound``, ``branch_once`` and
     ``child_bound`` (their panels: ``batched_degrees`` sweeps for vertex
     cover, one ``batched_expand_stats`` for max clique and MIS).  Both
     give the same state;
  2. **control plane** — per worker (pending, shallowest depth, local best),
     packed into one int32 per worker with ``packed_status``;
  3. **replicated center** — the idle->donor matching
     (:func:`match_idle_to_donors`), computed per instance from its (P,)
     table;
  4. **data plane** — matched donors pop up to ``donate_k`` shallowest tasks
     and each idle worker receives its donor's block.  On one device the
     delivery is a gather by ``recv_from`` for both ``transfer_impl``s; they
     differ in the payload they account for, as in the JAX package
     (``sparse``: the matched records; ``gather``: the whole P·k table);
  5. **best-value broadcast** — the min over each instance's workers.

A round with no match leaves the state exactly as the skipped JAX transfer
does (the pops and pushes are masked to nothing), so the port runs the data
plane unconditionally and gates only the transfer counters: no host sync.

Every integer is pinned to the JAX package's dtype (int32), so wraparound
matches, e.g. in ``donor_key = top_depth * P + idx``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.frontier import (
    Frontier,
    pending_per_worker,
    pop_deepest,
    pop_deepest_cheap,
    pop_k_shallowest,
    push_many,
    top_priority_depth,
)
from repro_torch.problems.base import (
    BranchingProblem,
    ProblemData,
    WorkCounters,
    compose_expand_tasks,
    for_task_rows,
    resolve_expand,
)

# the JAX package's registries of the two hot-path knobs
EXPLORE_IMPLS = ("fused", "reference")
TRANSFER_IMPLS = ("sparse", "gather")


class WorkerState(NamedTuple):
    """Every worker's state; each leaf has a leading worker axis: (P,) for
    one instance, (B·P,) inside the superstep, (B, P) in a lane state."""

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


def map_state(fn, *states: WorkerState) -> WorkerState:
    """``fn`` applied leaf by leaf across ``states`` (``jax.tree.map``)."""
    return WorkerState(
        Frontier(*[fn(*xs) for xs in zip(*(s.frontier for s in states))]),
        *[fn(*xs) for xs in zip(*(s[1:] for s in states))],
    )


def state_to(state: WorkerState, device) -> WorkerState:
    """``state`` with every leaf on ``device``."""
    return map_state(lambda x: x.to(device), state)



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
    if donate_k < 1:
        raise ValueError(f"donate_k must be >= 1, got {donate_k}")


# -- phase 1: exploration ------------------------------------------------------


def _explore_one_round(
    problem: BranchingProblem,
    data: ProblemData,
    state: WorkerState,
    lanes: int,
    counters: WorkCounters | None = None,
    explore_impl: str = "fused",
) -> WorkerState:
    """Each worker pops up to ``lanes`` deepest tasks; all (B·)P·lanes tasks
    are expanded in one batch (``data`` maps the rows to their instances);
    children are pushed back per worker.  ``explore_impl`` picks the pop
    and the expansion (the module docstring); both routes count their
    reduction sweeps into ``counters``."""
    if explore_impl == "fused":
        f, masks, sols, depths, valid = pop_deepest_cheap(state.frontier, lanes)
        expand = resolve_expand(problem)
    else:
        f, masks, sols, depths, valid = pop_deepest(state.frontier, lanes)
        # ALWAYS the composed callables, as in the JAX package: the fused
        # path's default for a plugin without expand_tasks, so the two
        # routes cannot drift apart
        expand = compose_expand_tasks(problem)
    P, L, W = masks.shape
    ex = expand(data, masks.reshape(P * L, W), sols.reshape(P * L, W), counters=counters)
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
    pending: torch.Tensor,  # (..., P) int32
    top_depth: torch.Tensor,  # (..., P) int32 (BIG_DEPTH, or its clamp, when empty)
    policy_priority: bool,
    round_idx: torch.Tensor,  # (...) int32 -- salt for the round-robin policy
):
    """The center's `getNextWorkingNode`: the idle->donor matching, computed
    independently for each leading index (one instance's (P,) table each).

    Returns (send_to, recv_from): per-worker partner index within the
    instance, or -1.  Donors need pending >= 2 (donate one, keep one —
    failure-free).  'priority' ranks donors by (shallowest pending depth,
    index); 'random' by a round-salted rotation of the index."""
    P = pending.shape[-1]
    dev = pending.device
    idx = torch.arange(P, dtype=torch.int32, device=dev).expand(pending.shape)
    idle = pending == 0
    donor = pending >= 2

    idle_rank = torch.where(idle, idle.cumsum(-1, dtype=torch.int32) - 1, -1)

    if policy_priority:
        donor_key = top_depth * P + idx  # int32, wraps as the JAX key does
    else:
        donor_key = (idx + round_idx[..., None]) % P
    donor_key = torch.where(donor, donor_key, 1 << 30)
    donor_order = torch.argsort(donor_key, dim=-1, stable=True)  # jnp.argsort is stable
    donor_rank = torch.empty_like(idx).scatter_(-1, donor_order, idx)
    donor_rank = torch.where(donor, donor_rank, -1)

    n_match = torch.minimum(
        idle.sum(-1, dtype=torch.int32), donor.sum(-1, dtype=torch.int32)
    )[..., None]

    def by_rank(member, rank):
        # rank -> worker index; non-members land in the extra slot P
        out = torch.zeros((*pending.shape[:-1], P + 1), dtype=torch.int32, device=dev)
        out.scatter_(-1, torch.where(member, rank, P).long(), idx)
        return out[..., :P]

    idle_by_rank = by_rank(idle, idle_rank)
    donor_by_rank = by_rank(donor, donor_rank)
    send_to = torch.where(
        donor & (donor_rank < n_match),
        idle_by_rank.gather(-1, donor_rank.clamp(0, P - 1).long()),
        -1,
    )
    recv_from = torch.where(
        idle & (idle_rank < n_match),
        donor_by_rank.gather(-1, idle_rank.clamp(0, P - 1).long()),
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
    """One BSP round for the B·P workers of the B instances of ``data``
    (``state`` leaves lead with B·P, instance-major).  Returns (state,
    done) where done is a (B,) bool tensor: nothing pending anywhere in
    that instance after the transfer phase.

    ``transfer_pad_words`` is the codec's payload on top of the native
    (mask, sol, depth) record (the basic encoding's n·W words): it counts
    in ``payload_words`` and carries no state."""
    _check_knobs(explore_impl, transfer_impl, donate_k)
    B = data.adj.shape[0]
    BP, W = state.best_sol.shape
    P = BP // B
    dev = state.best_sol.device
    rec_words = 2 * W + 1 + transfer_pad_words
    data = for_task_rows(data, P * lanes)

    def per_worker(x):  # (B,) -> (B·P,)
        return x[:, None].expand(B, P).reshape(BP)

    # 1. explore
    for _ in range(steps_per_round):
        state = _explore_one_round(problem, data, state, lanes, counters, explore_impl)

    # 2. control plane through the center + 5. best-value broadcast
    pending = pending_per_worker(state.frontier)
    top_depth = top_priority_depth(state.frontier)
    if packed_status:
        # one i32 per worker: pending (15b) | clamped depth (16b)
        word = (pending.clamp(0, 0x7FFF) << 16) | top_depth.clamp(0, 0xFFFF)
        pend_t = word >> 16
        depth_t = word & 0xFFFF
        global_best = per_worker(
            torch.minimum(state.local_best_val, state.best_val).view(B, P).amin(-1)
        )
    else:
        pend_t, depth_t = pending, top_depth
        global_best = torch.minimum(
            per_worker(state.local_best_val.view(B, P).amin(-1)), state.best_val
        )
    state = state._replace(best_val=global_best.contiguous())

    # 3. the replicated center, per instance (rounds is the same on every
    # worker of an instance)
    send_to, recv_from = match_idle_to_donors(
        pend_t.view(B, P), depth_t.view(B, P), policy_priority,
        state.rounds.view(B, P)[:, 0],
    )
    matched = send_to >= 0
    n_match = matched.sum(-1, dtype=torch.int32)  # (B,)
    # records each donor ships (>= 1 when matched: pending >= 2)
    n_don = torch.where(
        matched, torch.clamp(pend_t.view(B, P) - 1, max=donate_k), 0
    )

    # 4. data plane: donors pop their shallowest block, receivers push their
    # donor's block (a worker of the same instance)
    n_don_w = n_don.reshape(BP)
    f2, d_masks, d_sols, d_depths, _ = pop_k_shallowest(
        state.frontier, donate_k, limit=n_don_w
    )
    first = torch.arange(0, BP, P, device=dev)[:, None]  # each instance's worker 0
    src = (recv_from.clamp(0, P - 1) + first).reshape(BP)
    ks = torch.arange(donate_k, device=dev)
    recv_valid = (recv_from.reshape(BP) >= 0)[:, None] & (
        ks[None, :] < n_don_w[src][:, None]
    )
    f3 = push_many(f2, d_masks[src], d_sols[src], d_depths[src], recv_valid)
    if transfer_impl == "gather":
        moved_words = torch.full(
            (B,), P * donate_k * rec_words, dtype=torch.int32, device=dev
        )
    else:
        moved_words = n_don.sum(-1, dtype=torch.int32) * rec_words
    if skip_empty_transfer:
        ran = n_match > 0
    else:
        ran = torch.ones((B,), dtype=torch.bool, device=dev)
    state = state._replace(
        frontier=f3,
        tasks_sent=state.tasks_sent + n_don_w,
        tasks_recv=state.tasks_recv + recv_valid.sum(dim=-1, dtype=torch.int32),
        transfer_rounds=state.transfer_rounds + per_worker(ran.to(torch.int32)),
        payload_words=state.payload_words
        + per_worker(torch.where(ran, moved_words, 0)),
        rounds=state.rounds + 1,
    )

    # exact termination: nothing pending anywhere in the instance after the
    # transfer phase
    done = pending_per_worker(state.frontier).view(B, P).sum(-1) == 0
    return state, done


# -- the chunk runners -----------------------------------------------------------


def _frozen_where(frozen: torch.Tensor, old: torch.Tensor, new: torch.Tensor):
    """``old`` on the rows of frozen workers, ``new`` elsewhere."""
    return torch.where(frozen.view(-1, *([1] * (new.dim() - 1))), old, new)


def build_batch_plane_fn(
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
):
    """Batch chunk runner over (B, P, ...) lane state: ``(datas, worker,
    done[, fpt_bounds], counters=None) -> (worker, done, rounds_delta, ran,
    hot)`` running up to ``chunk_rounds`` supersteps.

    The instance tensors are call-time arguments, so host-side compaction
    reslices them and keeps calling the same function.  Finished lanes are
    frozen leaf by leaf (their state and stats stay those of a solo run),
    and ``rounds_delta`` ((B,) host int32) counts only live lanes' supersteps.
    The host reads ``done`` once per superstep, so ``ran`` is the superstep
    count of the JAX ``while_loop`` (0 when every lane was done on entry).
    ``use_fpt`` also finishes a lane whose best reached its INTERNAL target
    ``fpt_bounds[b]``.  ``hot`` is the (B, P) pending count after the chunk.
    ``counters`` (a :class:`WorkCounters`) tallies data-dependent work."""
    if chunk_rounds < 1:
        raise ValueError(f"chunk_rounds must be >= 1, got {chunk_rounds}")
    _check_knobs(explore_impl, transfer_impl, donate_k)
    step = functools.partial(
        superstep,
        problem,
        steps_per_round=steps_per_round,
        lanes=lanes,
        policy_priority=policy_priority,
        transfer_pad_words=transfer_pad_words,
        packed_status=packed_status,
        skip_empty_transfer=skip_empty_transfer,
        transfer_impl=transfer_impl,
        donate_k=donate_k,
        explore_impl=explore_impl,
    )

    def run(datas: ProblemData, worker: WorkerState, done, fpt_bounds=None,
            counters: WorkCounters | None = None):
        B, P = worker.best_val.shape
        flat = map_state(lambda x: x.reshape(B * P, *x.shape[2:]), worker)
        done_h = done.cpu().numpy()
        rounds_delta = np.zeros((B,), np.int32)
        ran = 0
        while ran < chunk_rounds and not done_h.all():
            new, step_done = step(datas, flat, counters=counters)
            if done_h.any():
                frozen = done[:, None].expand(B, P).reshape(B * P)
                flat = map_state(functools.partial(_frozen_where, frozen), flat, new)
            else:
                flat = new
            rounds_delta += ~done_h
            done = done | step_done
            if use_fpt:
                done = done | (flat.best_val.view(B, P)[:, 0] <= fpt_bounds)
            done_h = done.cpu().numpy()
            ran += 1
        if counters is not None:
            counters.flush()  # the device finished its work at the read of done
        worker = map_state(lambda x: x.view(B, P, *x.shape[1:]), flat)
        hot = pending_per_worker(flat.frontier).view(B, P)
        return worker, done, rounds_delta, ran, hot

    return run


def build_plane_fn(problem: BranchingProblem, **knobs):
    """Solo chunk runner: ``(data, state[, fpt_bound], counters=None) ->
    (state, done, ran, hot)`` over a (P, ...) state — the B = 1 case of
    :func:`build_batch_plane_fn`, with the same knobs.  ``done`` is a host
    bool; ``fpt_bound`` the INTERNAL decision target; ``hot`` the (P,)
    pending count."""
    batch = build_batch_plane_fn(problem, **knobs)

    def run(data: ProblemData, state: WorkerState, fpt_bound=None,
            counters: WorkCounters | None = None):
        dev = state.best_val.device
        bounds = None
        if fpt_bound is not None:
            bounds = torch.tensor([fpt_bound], dtype=torch.int32, device=dev)
        worker, done, _, ran, hot = batch(
            data, map_state(lambda x: x[None], state),
            torch.zeros((1,), dtype=torch.bool, device=dev), bounds, counters,
        )
        return map_state(lambda x: x[0], worker), bool(done[0]), ran, hot[0]

    return run


# -- the lane lifecycle ----------------------------------------------------------
#
# A lane is one instance slot of the batched plane: worker-state leaves
# (B, P, ...) plus per-lane control values.  ``solve_many`` steps the plane
# one chunk at a time (:func:`step_lanes`) and compacts finished lanes away
# (:func:`slice_lanes`).  The live service (``repro_torch.api.service``)
# never compacts: it keeps one plane of fixed lanes, admits an instance into
# a vacant lane (:func:`lane_swap_in`) and frees it again
# (:func:`lane_retire`); the spill pump un-freezes a lane its cold tier
# refilled (:func:`lane_resume`), and a stalled lane is frozen across a
# chunk by a snapshot (:func:`lane_slice`) written back after it
# (:func:`lane_write_back`).  Those verbs write the lane's slice in place,
# so a lane index stays valid for the plane's whole life.


class LaneState(NamedTuple):
    """Per-lane state of a batched plane.

    ``worker`` — (B, P, ...) stacked :class:`WorkerState`;
    ``done``   — (B,) bool: quiescent or FPT-finished (a frozen no-op);
    ``tag``    — (B,) host int32: the occupant's instance tag, -1 = vacant
                 (host bookkeeping the plane never reads);
    ``rounds`` — (B,) int32: supersteps run by the occupant.
    """

    worker: WorkerState
    done: torch.Tensor
    tag: np.ndarray
    rounds: torch.Tensor

    @property
    def num_lanes(self) -> int:
        return self.done.shape[0]

    def occupied(self) -> np.ndarray:
        """(B,) host bool: lanes holding a (possibly finished) instance."""
        return np.asarray(self.tag) >= 0


def make_vacant_lanes(
    num_lanes: int, num_workers: int, capacity: int, W: int, device
) -> LaneState:
    """An all-vacant live plane on ``device``: every lane holds a blank
    worker state (best 0) and is a frozen no-op (``done``) until an
    instance is swapped in.  Every leaf is its own contiguous tensor, so
    the lane verbs can write into it."""
    from repro_torch.core.engine import blank_state_flat

    one = blank_state_flat(num_workers, capacity, W, 0)
    flat = {
        k: np.ascontiguousarray(np.broadcast_to(v[None], (num_lanes, *v.shape)))
        for k, v in one.items()
    }
    return LaneState(
        worker=worker_state_from_flat(flat, device),
        done=torch.ones((num_lanes,), dtype=torch.bool, device=device),
        tag=np.full((num_lanes,), -1, np.int32),
        rounds=torch.zeros((num_lanes,), dtype=torch.int32, device=device),
    )


def lane_swap_in(
    lanes: LaneState, lane: int, worker: WorkerState, tag: int
) -> LaneState:
    """Admit a startup-scattered instance into ``lane``, in place; returns
    ``lanes``.

    ``worker`` is a solo (P, ...) state of one lane's shapes.  Every leaf of
    the lane is overwritten, the lane un-freezes (``done`` False), its round
    counter resets and its tag records the occupant.  Pure data writes: the
    plane function is reused as it is."""
    map_state(lambda full, one: full[lane].copy_(one), lanes.worker, worker)
    lanes.done[lane] = False
    lanes.rounds[lane] = 0
    lanes.tag[lane] = tag
    return lanes


def lane_slice(lanes: LaneState, lane: int) -> WorkerState:
    """A COPY of one lane's (P, ...) worker state.  Not a view: the lane
    verbs and the spill pump write the lane tensors in place, and a snapshot
    must not follow them."""
    return map_state(lambda x: x[lane].clone(), lanes.worker)


def lane_write_back(
    lanes: LaneState, lane: int, worker: WorkerState, done, rounds
) -> LaneState:
    """Overwrite ``lane``, in place, with a snapshot taken by
    :func:`lane_slice`: the (P, ...) ``worker`` state plus the exact
    ``done`` flag and ``rounds`` counter (where :func:`lane_swap_in` resets
    both); returns ``lanes``.  The tag is untouched: the occupant never
    changed.  The service freezes a stalled lane across a chunk this way: the
    plane steps it, then the snapshot is written back, so the lane made no
    progress."""
    map_state(lambda full, one: full[lane].copy_(one), lanes.worker, worker)
    lanes.done[lane] = bool(done)
    lanes.rounds[lane] = int(rounds)
    return lanes


def lane_resume(lanes: LaneState, lane: int) -> LaneState:
    """Un-freeze a quiescent lane in place, without touching its occupant;
    returns ``lanes``.  The spill pump re-admitted cold tasks into its
    frontier, so the plane's "done" verdict no longer holds and the lane
    must keep stepping."""
    lanes.done[lane] = False
    return lanes


def lane_retire(lanes: LaneState, lane: int) -> LaneState:
    """Mark ``lane`` vacant, in place (after its result was collected, or on
    eviction); returns ``lanes``.  It is a frozen no-op until the next
    swap-in, and its stale worker state is inert: admission overwrites every
    leaf."""
    lanes.done[lane] = True
    lanes.tag[lane] = -1
    return lanes


def slice_lanes(lanes: LaneState, sel) -> LaneState:
    """Select/reorder lanes (host-side batch compaction): device leaves and
    the host ``tag`` alike are indexed by ``sel`` along the lane axis."""
    sel = np.asarray(sel, np.int64)
    idx = torch.from_numpy(sel).to(lanes.done.device)
    return LaneState(
        worker=map_state(lambda x: x[idx], lanes.worker),
        done=lanes.done[idx],
        tag=np.asarray(lanes.tag)[sel],
        rounds=lanes.rounds[idx],
    )


def step_lanes(plane, datas: ProblemData, lanes: LaneState, fpt_bounds=None,
               counters: WorkCounters | None = None):
    """One plane step: up to ``chunk_rounds`` supersteps of a
    :func:`build_batch_plane_fn` runner over the lanes.  Returns ``(lanes,
    ran, hot)``: ``ran`` is the chunk's superstep count and ``hot`` the
    (B, P) per-worker pending count."""
    worker, done, delta, ran, hot = plane(
        datas, lanes.worker, lanes.done, fpt_bounds, counters
    )
    rounds = lanes.rounds + torch.from_numpy(delta).to(lanes.rounds.device)
    return lanes._replace(worker=worker, done=done, rounds=rounds), ran, hot


# -- (de)serialization ---------------------------------------------------------
#
# The same flat {name: np.ndarray} layout as the JAX package's
# ``worker_state_to_flat``/``worker_state_from_flat`` (superstep.py:924,937):
# packed words are uint32 there and int32 here, with the same bits.

_U32_LEAVES = ("frontier.masks", "frontier.sols", "best_sol")


def worker_state_to_flat(state: WorkerState, prefix: str = "worker") -> dict:
    """A (P, ...) or (B, P, ...) worker state as named host arrays."""
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


def lane_state_to_flat(lanes: LaneState, prefix: str = "lanes") -> dict:
    """A lane state in the JAX package's flat layout (superstep.py:952)."""
    flat = worker_state_to_flat(lanes.worker, f"{prefix}.worker")
    flat[f"{prefix}.done"] = lanes.done.detach().cpu().numpy()
    flat[f"{prefix}.tag"] = np.asarray(lanes.tag, np.int32)
    flat[f"{prefix}.rounds"] = lanes.rounds.detach().cpu().numpy()
    return flat


def lane_state_from_flat(flat: dict, device, prefix: str = "lanes") -> LaneState:
    """A lane state on ``device`` from the flat layout: the port's own, or
    a JAX ``lane_state_to_flat`` dict (uint32 words read as int32)."""
    return LaneState(
        worker=worker_state_from_flat(flat, device, f"{prefix}.worker"),
        done=torch.from_numpy(np.asarray(flat[f"{prefix}.done"], bool).copy()).to(device),
        tag=np.asarray(flat[f"{prefix}.tag"], np.int32).copy(),
        rounds=torch.from_numpy(
            np.asarray(flat[f"{prefix}.rounds"], np.int32).copy()
        ).to(device),
    )
