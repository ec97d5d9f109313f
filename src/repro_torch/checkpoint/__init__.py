"""``repro_torch.checkpoint`` — the durable solve plane's store and schema,
on the JAX package's file format (``repro/checkpoint``)."""

from repro_torch.checkpoint.solve import CheckpointError, SolveCheckpoint
from repro_torch.checkpoint.store import (
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)

__all__ = [
    "save_checkpoint",
    "restore_checkpoint",
    "latest_step",
    "CheckpointError",
    "SolveCheckpoint",
]
