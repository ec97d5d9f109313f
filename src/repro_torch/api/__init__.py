"""``repro_torch.api`` — the port's public surface: one config
(:class:`SolveConfig`), one result schema (:class:`SolveResult`) and one
façade (:class:`SolverSession`).

    from repro_torch.api import SolverSession, SolveConfig

    session = SolverSession(config=SolveConfig(num_workers=128))  # on the card
    r = session.solve(g)
    batch = session.solve_many(graphs)
"""

from repro_torch.api.backends import BACKENDS, Backend, get_backend, known_backends
from repro_torch.api.cache import CacheStats, PlaneCache
from repro_torch.api.config import SolveConfig
from repro_torch.api.result import BatchSolveResult, LaneStats, SolveResult, SolveStats
from repro_torch.api.session import SolverSession, resolve_device

__all__ = [
    "BACKENDS",
    "Backend",
    "BatchSolveResult",
    "CacheStats",
    "LaneStats",
    "PlaneCache",
    "SolveConfig",
    "SolveResult",
    "SolveStats",
    "SolverSession",
    "get_backend",
    "known_backends",
    "resolve_device",
]
