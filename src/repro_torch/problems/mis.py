"""Maximum-independent-set plugin: max clique on the complement graph.

The port of ``repro/problems/mis.py``.  An independent set of G is a clique
of its complement, so the plugin branches like :mod:`max_clique` on
complement adjacency: ``host_adj``/``host_view`` swap in the complement for
the device tensors and the host startup split, and every device callable is
max clique's.  The solution mask is the independent set in the ORIGINAL
graph, which is what ``verify`` checks.  A batch pads the complement's rows
past each instance's n with zeros, like any adjacency.
"""

from __future__ import annotations

from repro_torch.graphs.bitgraph import complement
from repro_torch.problems import max_clique, sequential
from repro_torch.problems.base import BranchingProblem

SPEC = BranchingProblem(
    name="mis",
    objective="maximize |independent set|",
    branch_once=max_clique.branch_once,
    task_bound=max_clique.bound,
    child_bound=max_clique.bound,
    expand_tasks=max_clique.expand_tasks,
    bnb_bound=lambda g: 1,  # just worse than the empty set (value 0)
    external_value=lambda v: -v,
    fpt_target=lambda k: -k,
    host_adj=lambda g: complement(g).adj,
    host_view=complement,
    branch_once_host=sequential.branch_once_clique,
    sequential=sequential.solve_sequential_mis,
    verify=sequential.verify_independent_set,
)
