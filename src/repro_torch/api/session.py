"""``SolverSession``: the port's public way to solve a branching problem.

The port of ``repro/api/session.py``'s constructor and ``solve``.  A session
binds (problem, backend, config, device) once.  The device is the card
unless the caller asks for another: ``device=None`` means ``"cuda"``, and a
session on CUDA raises ``RuntimeError`` when CUDA is absent instead of
running on the CPU.  The CPU path (``device="cpu"``) runs the kernels'
plain versions; the tests use it.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.api.backends import Backend, get_backend
from repro_torch.api.config import SolveConfig
from repro_torch.api.result import SolveResult
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

    >>> session = SolverSession(config=SolveConfig(num_workers=128))
    >>> session.solve(g).best_size

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
        **overrides,
    ):
        self.device = resolve_device(device)
        self.problem = get_problem(problem)
        self.backend: Backend = get_backend(backend)
        cfg = config if config is not None else SolveConfig()
        if overrides:
            cfg = cfg.replace(**overrides)
        self.config = cfg

    def solve(self, g, **backend_kw) -> SolveResult:
        """Solve one instance; ``backend_kw`` passes backend-specific extras
        (spmd: ``initial_state``)."""
        return self.backend.solve(
            self.problem, g, self.config, device=self.device, **backend_kw
        )
