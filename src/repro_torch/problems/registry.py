"""Problem registry: name -> :class:`~repro_torch.problems.base.BranchingProblem`.

The port carries the paper's own workload, vertex cover.  Max clique and
MIS exist in the JAX package and wait for their port (ROADMAP queue 1,
item 6); asking for them raises a ``ValueError`` that says so.
"""

from __future__ import annotations

from repro_torch.problems import vertex_cover
from repro_torch.problems.base import BranchingProblem

DEFAULT_PROBLEM = "vertex_cover"

REGISTRY: dict = {vertex_cover.SPEC.name: vertex_cover.SPEC}

ALIASES = {
    "vc": "vertex_cover",
    "min_vertex_cover": "vertex_cover",
}

# problems of the JAX package that the port does not carry yet
NOT_PORTED = (
    "max_clique",
    "mis",
    "clique",
    "maximum_independent_set",
    "independent_set",
)


def known_problems() -> list:
    return sorted(REGISTRY)


def get_problem(name) -> BranchingProblem:
    """Resolve a problem by name (or pass a spec through unchanged)."""
    if isinstance(name, BranchingProblem):
        return name
    if name in NOT_PORTED:
        raise ValueError(
            f"problem {name!r} is not ported to repro_torch yet "
            f"(ROADMAP queue 1, item 6: max clique + MIS); "
            f"known problems: {', '.join(known_problems())}"
        )
    key = ALIASES.get(name, name)
    if key not in REGISTRY:
        raise ValueError(
            f"unknown problem {name!r}; known problems: "
            f"{', '.join(known_problems())} "
            f"(aliases: {', '.join(sorted(ALIASES))})"
        )
    return REGISTRY[key]
