"""Assigned-architecture configs (--arch <id>) + the run-config schema.

Data copies of the JAX package's ``configs/``: every arch id and alias it
resolves, the port resolves to the same ``ModelConfig``.
"""

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig
from repro_torch.configs.registry import ALIASES, ARCH_IDS, get_config, get_smoke_config

__all__ = [
    "ModelConfig",
    "ShapeConfig",
    "SHAPES",
    "ARCH_IDS",
    "ALIASES",
    "get_config",
    "get_smoke_config",
]
