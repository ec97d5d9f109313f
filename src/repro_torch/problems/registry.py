"""Problem registry: name -> :class:`~repro_torch.problems.base.BranchingProblem`.

The port of ``repro/problems/registry.py``: the same three problems, names
and aliases.
"""

from __future__ import annotations

from repro_torch.problems import max_clique, mis, vertex_cover
from repro_torch.problems.base import BranchingProblem

# the paper's own workload; core modules take this as their default
DEFAULT_PROBLEM = "vertex_cover"

REGISTRY: dict = {
    spec.name: spec for spec in (vertex_cover.SPEC, max_clique.SPEC, mis.SPEC)
}

ALIASES = {
    "vc": "vertex_cover",
    "min_vertex_cover": "vertex_cover",
    "clique": "max_clique",
    "maximum_independent_set": "mis",
    "independent_set": "mis",
}


def known_problems() -> list:
    return sorted(REGISTRY)


def get_problem(name) -> BranchingProblem:
    """Resolve a problem by name (or pass a spec through unchanged); an
    unknown name raises a ``ValueError`` listing the known ones."""
    if isinstance(name, BranchingProblem):
        return name
    key = ALIASES.get(name, name)
    if key not in REGISTRY:
        raise ValueError(
            f"unknown problem {name!r}; known problems: "
            f"{', '.join(known_problems())} "
            f"(aliases: {', '.join(sorted(ALIASES))})"
        )
    return REGISTRY[key]
