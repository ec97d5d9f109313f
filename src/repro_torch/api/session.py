"""``SolverSession``: the port's public way to solve branching problems.

The port of ``repro/api/session.py``'s constructor, ``solve``,
``solve_many`` and ``cache_stats``.  A session binds (problem, backend,
config, device) once and owns a :class:`~repro_torch.api.cache.PlaneCache`
(or shares one passed in).  The device is the card unless the caller asks
for another: ``device=None`` means ``"cuda"``, and a session on CUDA raises
``RuntimeError`` when CUDA is absent instead of running on the CPU.  The CPU
path (``device="cpu"``) runs the kernels' plain versions; the tests use it.

Asynchronous admission (``submit``/``poll``/``flush``) needs the serving
batcher and the live service, which are not ported yet: those verbs raise
``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.api.backends import Backend, get_backend
from repro_torch.api.cache import PlaneCache
from repro_torch.api.config import SolveConfig
from repro_torch.api.result import BatchSolveResult, SolveResult
from repro_torch.problems.registry import DEFAULT_PROBLEM, get_problem


def resolve_device(device=None) -> torch.device:
    """``None`` -> the card; a CUDA device without CUDA raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and CUDA is not "
            "available here; pass device='cpu' to run the plain torch path "
            "on the CPU"
        )
    return dev


class SolverSession:
    """One façade over the port's backends.

    >>> session = SolverSession(problem="max_clique",
    ...                         config=SolveConfig(num_workers=128))
    >>> session.solve(g).best_size
    >>> session.solve_many(graphs).results

    ``problem`` is a registry name or spec; ``backend`` is ``spmd`` or
    ``sequential``.  Keyword overrides are applied on top of ``config``:
    ``SolverSession(num_workers=4, device="cpu")``.
    """

    def __init__(
        self,
        problem=DEFAULT_PROBLEM,
        backend="spmd",
        config: Optional[SolveConfig] = None,
        *,
        device=None,
        cache: Optional[PlaneCache] = None,
        **overrides,
    ):
        self.device = resolve_device(device)
        self.problem = get_problem(problem)
        self.backend: Backend = get_backend(backend)
        cfg = config if config is not None else SolveConfig()
        if overrides:
            cfg = cfg.replace(**overrides)
        self.config = cfg
        self.cache = cache if cache is not None else PlaneCache()

    def solve(self, g, **backend_kw) -> SolveResult:
        """Solve one instance; ``backend_kw`` passes backend-specific extras
        (spmd: ``initial_state``)."""
        return self.backend.solve(
            self.problem, g, self.config, self.cache, device=self.device,
            **backend_kw,
        )

    def solve_many(self, graphs, **backend_kw) -> BatchSolveResult:
        """Solve B instances: on one batched plane per W bucket (spmd) or
        one after another (sequential)."""
        return self.backend.solve_many(
            self.problem, list(graphs), self.config, self.cache,
            device=self.device, **backend_kw,
        )

    # -- asynchronous admission: not ported yet --------------------------------

    @staticmethod
    def _refuse_admission(verb: str):
        raise NotImplementedError(
            f"SolverSession.{verb} is not ported to repro_torch yet (ROADMAP "
            f"queue 1, item 8: the live service; item 12: the serving batcher)"
        )

    def submit(self, g, **kw):
        self._refuse_admission("submit")

    def poll(self):
        self._refuse_admission("poll")

    def flush(self):
        self._refuse_admission("flush")

    def cache_stats(self) -> dict:
        """Plane-cache accounting (see :class:`~repro_torch.api.cache.CacheStats`)."""
        return self.cache.stats().to_dict()
