"""Vertex-cover plugin: the paper's own workload on the generic solve plane.

The port of ``repro/problems/vertex_cover.py``.  Every function takes a lane
batch of tasks ``(masks (L, W), sols (L, W))`` in the paper's optimized
encoding and returns per-lane results equal, bit for bit, to the JAX
package's per-task functions vmapped over the lanes.

Every degree panel — the two per explore round in :func:`expand_tasks` and
the one per reduction sweep — is one :func:`degrees_batch` call over the
whole batch, i.e. one launch of the CUDA ``batched_degrees`` kernel on the
card, and on the batched plane the batch holds the lanes of every instance:
each task row reads its own instance's adjacency (``base.adj_rows``).

Ties: the pivot ``u`` is the FIRST vertex of maximum degree and every rule
picks the first qualifying vertex, as ``jnp.argmax``/``min`` do; the port
computes first indices explicitly rather than trusting a tie order.
"""

from __future__ import annotations

import torch

from repro_torch.problems import sequential
from repro_torch.problems.base import (
    BranchingProblem,
    BranchStep,
    ExpandResult,
    ProblemData,
    WorkCounters,
    adj_rows,
    degrees_batch,
    edge_count,
    first_index,
    pack_bits,
    popcount,
    row_instances,
    single_bit,
    unpack_bits,
)
from repro_torch.kernels.bitset_ops.ref import task_adjacency

# reduction sweeps between host checks of "did any lane change": a sweep on
# a lane at its fixpoint changes nothing, so checking less often than every
# sweep gives the same result with fewer host syncs
REDUCE_CHECK_EVERY = 4


def lower_bound(deg: torch.Tensor) -> torch.Tensor:
    """(L, n) degrees -> (L,) ceil(E / maxdeg): each cover vertex covers at
    most maxdeg edges."""
    maxdeg = deg.amax(dim=-1).clamp(min=0)
    E = edge_count(deg)
    ceil = -torch.div(-E, maxdeg.clamp(min=1), rounding_mode="floor")
    return torch.where(maxdeg > 0, ceil, 0).to(torch.int32)


# -- reduction rules (paper §4.1, Chen-Kanj-Jia) -------------------------------


def _reduce_step(data: ProblemData, masks, sols):
    """One reduction sweep over the lane batch -> (masks, sols, changed (L,)).

    A lane where no rule applies comes back unchanged."""
    n, W = data.adj.shape[-2:]
    L = masks.shape[0]
    deg = degrees_batch(data, masks)  # (L, n)
    inside = deg >= 0

    # Rule 1: drop all isolated vertices at once (removals never conflict).
    iso = inside & (deg == 0)
    any_iso = iso.any(dim=-1)
    mask_r1 = masks & ~pack_bits(iso, W)

    # Rule 2: the first degree-1 vertex, one per sweep.
    u2 = first_index(inside & (deg == 1))
    has_u2 = u2 < n
    u2c = u2.clamp(max=n - 1)
    nb2 = adj_rows(data, u2c) & masks
    sol_r2 = sols | nb2
    mask_r2 = masks & ~(nb2 | single_bit(u2c, W))

    # Rule 3: the first degree-2 vertex whose two neighbours are adjacent.
    # Unpacks an (n, n) neighbour matrix per lane, as the JAX sweep does.
    rows = task_adjacency(data.adj, row_instances(data, L))  # (1 or L, n, W)
    bits = unpack_bits(rows & masks[:, None, :], n)  # (L, n, n)
    vidx = torch.arange(n, dtype=torch.int32, device=masks.device)
    first_nb = torch.where(bits, vidx, n).amin(dim=-1)
    last_nb = torch.where(bits, vidx, -1).amax(dim=-1)
    fc = first_nb.clamp(0, n - 1).long()
    lc = last_nb.clamp(0, n - 1).long()
    lane = torch.arange(L, device=masks.device)[:, None]
    vw_edge = bits[lane, fc, lc]  # adj is symmetric: v's row has bit w
    u3 = first_index(inside & (deg == 2) & vw_edge)
    has_u3 = u3 < n
    u3c = u3.clamp(max=n - 1)
    nb3 = adj_rows(data, u3c) & masks
    sol_r3 = sols | nb3
    mask_r3 = masks & ~(nb3 | single_bit(u3c, W))

    # Priority: rule 1 > rule 2 > rule 3 (mirrors the host reference).
    r1, r2, r3 = any_iso[:, None], has_u2[:, None], has_u3[:, None]
    new_masks = torch.where(
        r1, mask_r1, torch.where(r2, mask_r2, torch.where(r3, mask_r3, masks))
    )
    new_sols = torch.where(
        r1, sols, torch.where(r2, sol_r2, torch.where(r3, sol_r3, sols))
    )
    return new_masks, new_sols, any_iso | has_u2 | has_u3


def reduce_instance(
    data: ProblemData, masks, sols, counters: WorkCounters | None = None
):
    """Apply rules 1-3 to every lane until no lane changes.

    The JAX package runs a per-lane ``while_loop`` of at most n+1 sweeps.
    Every sweep that changes a lane removes at least one vertex of it, so a
    lane reaches its fixpoint within n+1 sweeps and the bound never binds;
    further sweeps leave it as it is.  So the batch runs whole sweeps and the
    host checks ``changed.any()`` every :data:`REDUCE_CHECK_EVERY` sweeps."""
    n = data.adj.shape[-2]
    sweeps = 0
    while sweeps < n + 1:
        for _ in range(REDUCE_CHECK_EVERY):
            masks, sols, changed = _reduce_step(data, masks, sols)
            sweeps += 1
        if not bool(changed.any()):
            break
    if counters is not None:
        counters.reduce_sweeps += sweeps
    return masks, sols


# -- branching (paper Algorithm 8 lines 7-11) ----------------------------------


def _branch_reduced(data: ProblemData, rmasks, rsols):
    """Branch every REDUCED lane on its first maximum-degree vertex u:
    left = (G-u, S+{u}), right = (G-N[u], S+N(u)).  -> (step, maxdeg)."""
    W = data.adj.shape[-1]
    deg = degrees_batch(data, rmasks)  # (L, n)
    maxdeg = deg.amax(dim=-1)
    u = first_index(deg == maxdeg[:, None])
    u_bit = single_bit(u, W)
    nb = adj_rows(data, u) & rmasks
    step = BranchStep(
        left_mask=rmasks & ~u_bit,
        left_sol=rsols | u_bit,
        right_mask=rmasks & ~(nb | u_bit),
        right_sol=rsols | nb,
        is_terminal=maxdeg <= 0,
        terminal_sol=rsols,
        terminal_value=popcount(rsols),
    )
    return step, maxdeg


def branch_once(data: ProblemData, masks, sols, counters=None) -> BranchStep:
    """Reduce, then branch on a maximum-degree vertex (Alg. 8/9)."""
    rmasks, rsols = reduce_instance(data, masks, sols, counters)
    return _branch_reduced(data, rmasks, rsols)[0]


def task_bound(data: ProblemData, masks, sols) -> torch.Tensor:
    """|S| + ceil(E/maxdeg): admissible lower bound on the final cover."""
    return popcount(sols) + lower_bound(degrees_batch(data, masks))


def child_bound(data: ProblemData, masks, sols) -> torch.Tensor:
    """Cheap birth-time bound: the partial cover can only grow."""
    return popcount(sols)


def expand_tasks(data: ProblemData, masks, sols, counters=None) -> ExpandResult:
    """One-pass fused expansion of an (L, W) lane batch (Alg. 8 hot path).

    Two degree panels per call (the raw masks for the bound, the reduced
    masks for the pivot), each one batched kernel launch; the child bounds
    are arithmetic on the second panel: ``|S|+1`` for the take-u child and
    ``|S| + deg[u]`` for the take-N(u) child.  Terminal lanes carry
    placeholder child bounds that are never read."""
    bound = popcount(sols) + lower_bound(degrees_batch(data, masks))
    rmasks, rsols = reduce_instance(data, masks, sols, counters)
    step, maxdeg = _branch_reduced(data, rmasks, rsols)
    return ExpandResult(
        bound=bound,
        step=step,
        left_bound=step.terminal_value + 1,
        right_bound=step.terminal_value + maxdeg,
    )


SPEC = BranchingProblem(
    name="vertex_cover",
    objective="minimize |cover|",
    branch_once=branch_once,
    task_bound=task_bound,
    child_bound=child_bound,
    expand_tasks=expand_tasks,
    bnb_bound=lambda g: g.n + 1,
    branch_once_host=sequential.branch_once,
    sequential=sequential.solve_sequential,
    verify=sequential.verify_cover,
)
