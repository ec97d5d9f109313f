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
the lanes.  :func:`expand_tasks` is ONE ``clique_expand`` call per explore
round: on the card one kernel launch for the lanes of every instance, which
computes the panel, the pivot, both children and their bounds.  Ties: the
pivot is the FIRST vertex of maximum degree, as ``jnp.argmax`` picks.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.bitset_ops import ref
from repro_torch.kernels.bitset_ops.kernel import clique_expand
from repro_torch.problems import sequential
from repro_torch.problems.base import (
    BranchingProblem,
    BranchStep,
    ExpandResult,
    ProblemData,
    expand_stats_batch,
    popcount,
    row_instances,
)


def branch_once(data: ProblemData, masks, sols, counters=None) -> BranchStep:
    """Branch on a maximum-degree candidate (degree within P, ties lowest):
    one ``expand_stats_batch`` panel gives the degrees, |P| and |R|."""
    deg, pc_mask, pc_sol = expand_stats_batch(data, masks, sols)
    u, _ = ref.pivot(deg)
    inst = row_instances(data, masks.shape[0])
    lm, ls, rm, rs, ts = ref.clique_branch(data.adj, inst, masks, sols, u)
    return BranchStep(lm, ls, rm, rs, pc_mask == 0, ts, -pc_sol)


def bound(data: ProblemData, masks, sols) -> torch.Tensor:
    """-(|R| + |P|): no completion can beat adding every candidate."""
    return -(popcount(sols) + popcount(masks))


def expand_tasks(data: ProblemData, masks, sols, counters=None) -> ExpandResult:
    """One-pass fused expansion of an (L, W) lane batch: ONE
    ``clique_expand`` call.  The child bounds are arithmetic on the panel:
    ``|left_sol| = |R| + 1`` (u is a candidate, P and R are disjoint),
    ``|left_mask| = deg[u]``, ``|right_mask| = |P| - 1``, ``|right_sol| = |R|``.
    Terminal lanes carry placeholder child bounds that are never read."""
    inst = row_instances(data, masks.shape[0])
    return ExpandResult.of(clique_expand(data.adj, masks, sols, inst))


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
