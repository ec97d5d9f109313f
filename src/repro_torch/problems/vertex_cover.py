"""Vertex-cover plugin: the paper's own workload on the generic solve plane.

The port of ``repro/problems/vertex_cover.py``.  Every function takes a lane
batch of tasks ``(masks (L, W), sols (L, W))`` in the paper's optimized
encoding and returns per-lane results equal, bit for bit, to the JAX
package's per-task functions vmapped over the lanes.

The plane's hot path, :func:`expand_tasks`, is ONE ``vc_expand`` call for
the whole batch of every instance: on the card one kernel launch that runs
each lane's reduction loop to its own fixpoint, as the JAX package's
per-lane ``while_loop`` does, with no host in the loop.  The composed path
(:func:`branch_once`, :func:`task_bound`) makes one :func:`degrees_batch`
panel per reduction sweep over the batch (the ``batched_degrees`` kernel on
the card).  The reduction rules are ``kernels/bitset_ops/ref.py``'s
``vc_reduce_step``, shared by both.

Ties: the pivot ``u`` is the FIRST vertex of maximum degree and every rule
picks the first qualifying vertex, as ``jnp.argmax``/``min`` do.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.bitset_ops import ref
from repro_torch.kernels.bitset_ops.kernel import vc_expand
from repro_torch.kernels.bitset_ops.ops import degrees_op
from repro_torch.problems import sequential
from repro_torch.problems.base import (
    BranchingProblem,
    BranchStep,
    ExpandResult,
    ProblemData,
    WorkCounters,
    degrees_batch,
    popcount,
    row_instances,
)

# reduction sweeps between host checks on the composed path
REDUCE_CHECK_EVERY = ref.REDUCE_CHECK_EVERY

lower_bound = ref.vc_lower_bound


# -- reduction rules (paper §4.1, Chen-Kanj-Jia) -------------------------------


def reduce_instance(
    data: ProblemData, masks, sols, counters: WorkCounters | None = None
):
    """Apply rules 1-3 to every lane until it reaches its own fixpoint.

    Whole-batch sweeps, one degree panel each, with a host check every
    :data:`REDUCE_CHECK_EVERY` sweeps (:func:`ref.vc_reduce`); ``counters``
    gets the largest per-lane trip count of the JAX package's loop."""
    inst = row_instances(data, masks.shape[0])
    masks, sols, sweeps = ref.vc_reduce(
        data.adj, masks, sols, inst, degrees_op, REDUCE_CHECK_EVERY
    )
    if counters is not None:
        counters.add_sweeps(sweeps)
    return masks, sols


# -- branching (paper Algorithm 8 lines 7-11) ----------------------------------


def branch_once(data: ProblemData, masks, sols, counters=None) -> BranchStep:
    """Reduce, then branch on a maximum-degree vertex (Alg. 8/9):
    left = (G-u, S+{u}), right = (G-N[u], S+N(u))."""
    rmasks, rsols = reduce_instance(data, masks, sols, counters)
    inst = row_instances(data, masks.shape[0])
    deg = degrees_batch(data, rmasks)
    return BranchStep(*ref.vc_branch(data.adj, inst, rmasks, rsols, deg)[:-1])


def task_bound(data: ProblemData, masks, sols) -> torch.Tensor:
    """|S| + ceil(E/maxdeg): admissible lower bound on the final cover."""
    return popcount(sols) + lower_bound(degrees_batch(data, masks))


def child_bound(data: ProblemData, masks, sols) -> torch.Tensor:
    """Cheap birth-time bound: the partial cover can only grow."""
    return popcount(sols)


def expand_tasks(data: ProblemData, masks, sols, counters=None) -> ExpandResult:
    """One-pass fused expansion of an (L, W) lane batch (Alg. 8 hot path).

    ONE ``vc_expand`` call: the bound of the raw mask, every lane's
    reduction loop to its fixpoint, the pivot on the reduced mask, both
    children and their bounds, ``|S|+1`` for the take-u child and ``|S| +
    deg[u]`` for the take-N(u) child.  Terminal lanes carry placeholder
    child bounds that are never read.  ``counters`` gets the largest
    per-lane trip count, summed on the device on the card."""
    out = vc_expand(data.adj, masks, sols, row_instances(data, masks.shape[0]))
    if counters is not None:
        counters.add_sweeps(out.sweeps)
    return ExpandResult.of(out)


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
