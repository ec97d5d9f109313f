"""``repro_torch.api`` — the port's public surface: one config
(:class:`SolveConfig`), one result schema (:class:`SolveResult`) and one
façade (:class:`SolverSession`), with the live service
(:class:`SolveService`) behind it.

    from repro_torch.api import SolverSession, SolveConfig

    session = SolverSession(config=SolveConfig(num_workers=128))  # on the card
    r = session.solve(g)
    batch = session.solve_many(graphs)
    svc = session.serve(service_lanes=8)   # the live service
    t = svc.submit(g); svc.drain(); svc.result(t)

Durability::

    session.solve(g, checkpoint_dir="ckpt")   # a checkpoint every few chunks
    SolverSession.resume("ckpt")              # after a kill: the same result
    svc.checkpoint("ckpt"); SolveService.restore("ckpt")   # the live service
"""

from repro_torch.api.backends import BACKENDS, Backend, get_backend, known_backends
from repro_torch.api.cache import CacheStats, PlaneCache
from repro_torch.api.config import SolveConfig
from repro_torch.api.result import (
    BatchSolveResult,
    LaneStats,
    ServiceStats,
    SolveResult,
    SolveStats,
)
from repro_torch.api.service import AsyncSolveService, SolveService, SolveTimeout
from repro_torch.api.session import SolverSession, resolve_device, solve_stream_session
from repro_torch.checkpoint.solve import CheckpointError, SolveCheckpoint

__all__ = [
    "AsyncSolveService",
    "BACKENDS",
    "Backend",
    "BatchSolveResult",
    "CacheStats",
    "CheckpointError",
    "LaneStats",
    "PlaneCache",
    "ServiceStats",
    "SolveCheckpoint",
    "SolveConfig",
    "SolveResult",
    "SolveService",
    "SolveStats",
    "SolveTimeout",
    "SolverSession",
    "get_backend",
    "known_backends",
    "resolve_device",
    "solve_stream_session",
]
