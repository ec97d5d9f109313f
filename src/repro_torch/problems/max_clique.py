"""Max-clique plugin: a candidate-set brancher on the generic solve plane.

The port of ``repro/problems/max_clique.py``.  Task state (the paper's
optimized encoding): ``mask`` is the candidate set P (vertices adjacent to
everything already picked), ``sol`` is the clique R being grown.  One
expansion branches on a maximum-degree candidate u -- either u joins
(candidates shrink to P & N(u)) or u is discarded -- and a task is terminal
when P is empty.

The engine minimizes, so the internal objective is ``-|R|``; the bound
``-(|R| + |P|)`` prunes popped tasks and newborn children alike.

Every function takes a lane batch ``(masks (L, W), sols (L, W))`` and
equals, lane for lane, the JAX package's per-task functions vmapped over
the lanes.  :func:`expand_tasks` makes ONE ``batched_expand_stats`` panel
per explore round, one launch of the CUDA kernel on the card for the lanes
of every instance.  Ties: the pivot is the FIRST vertex of maximum degree,
as ``jnp.argmax`` picks, computed explicitly.
"""

from __future__ import annotations

import torch

from repro_torch.problems import sequential
from repro_torch.problems.base import (
    BranchingProblem,
    BranchStep,
    ExpandResult,
    ProblemData,
    adj_rows,
    degrees_batch,
    expand_stats_batch,
    first_index,
    popcount,
    single_bit,
)


def _pivot(deg: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(L, n) degrees -> (u, deg[u]): the first vertex of maximum degree.
    An empty mask (all -1) gives u = 0, as ``jnp.argmax`` does."""
    deg_u = deg.amax(dim=1)
    return first_index(deg == deg_u[:, None]), deg_u


def _step(data: ProblemData, masks, sols, u, pc_mask, pc_sol) -> BranchStep:
    u_bit = single_bit(u, masks.shape[1])
    return BranchStep(
        left_mask=adj_rows(data, u) & masks,  # u joins: only its neighbours stay
        left_sol=sols | u_bit,
        right_mask=masks & ~u_bit,  # u discarded
        right_sol=sols,
        is_terminal=pc_mask == 0,
        terminal_sol=sols,
        terminal_value=-pc_sol,
    )


def branch_once(data: ProblemData, masks, sols, counters=None) -> BranchStep:
    """Branch on a maximum-degree candidate (degree within P, ties lowest)."""
    u, _ = _pivot(degrees_batch(data, masks))
    return _step(data, masks, sols, u, popcount(masks), popcount(sols))


def bound(data: ProblemData, masks, sols) -> torch.Tensor:
    """-(|R| + |P|): no completion can beat adding every candidate."""
    return -(popcount(sols) + popcount(masks))


def expand_tasks(data: ProblemData, masks, sols, counters=None) -> ExpandResult:
    """One-pass fused expansion of an (L, W) lane batch.

    ONE ``expand_stats_batch`` panel gives degrees + |P| + |R| for the whole
    batch, and the child bounds are arithmetic on them:
    ``|left_sol| = |R| + 1`` (u is a candidate, P and R are disjoint),
    ``|left_mask| = deg[u]``, ``|right_mask| = |P| - 1``, ``|right_sol| = |R|``.
    Terminal lanes carry placeholder child bounds that are never read."""
    deg, pc_mask, pc_sol = expand_stats_batch(data, masks, sols)
    u, deg_u = _pivot(deg)
    return ExpandResult(
        bound=-(pc_sol + pc_mask),
        step=_step(data, masks, sols, u, pc_mask, pc_sol),
        left_bound=-(pc_sol + 1 + deg_u),
        right_bound=-(pc_sol + pc_mask - 1),
    )


SPEC = BranchingProblem(
    name="max_clique",
    objective="maximize |clique|",
    branch_once=branch_once,
    task_bound=bound,
    child_bound=bound,
    expand_tasks=expand_tasks,
    bnb_bound=lambda g: 1,  # just worse than the empty clique (value 0)
    external_value=lambda v: -v,
    fpt_target=lambda k: -k,
    branch_once_host=sequential.branch_once_clique,
    sequential=sequential.solve_sequential_max_clique,
    verify=sequential.verify_clique,
)
