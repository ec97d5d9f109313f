"""Public wrappers for the bitset kernels, dispatched by the tensor's device.

The port of ``repro/kernels/bitset_ops/ops.py``.  A CUDA tensor goes to the
hand-written kernel, a CPU tensor to the plain version.  The JAX package's
``T < 2`` fallback to its reference does not carry over: on the card the
kernels take every shape, so every panel of the solve plane is one kernel
launch, for one instance or a whole batch (``inst``).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.bitset_ops.kernel import batched_degrees, batched_expand_stats


def degrees_op(adj: torch.Tensor, masks: torch.Tensor, inst=None) -> torch.Tensor:
    """(n, W) or (B, n, W) adj x (T, W) masks -> (T, n) induced-subgraph
    degrees of each task's instance: the kernel on CUDA, the plain version
    on the CPU, the same values bit for bit."""
    return batched_degrees(adj, masks, inst)


def expand_stats_op(adj: torch.Tensor, masks: torch.Tensor, sols: torch.Tensor, inst=None):
    """The fused expand panel -> (deg (T, n), pc_mask (T,), pc_sol (T,)),
    all int32: one ``batched_expand_stats`` launch on CUDA, the plain
    version on the CPU."""
    deg, pc = batched_expand_stats(adj, masks, sols, inst)
    return deg, pc[:, 0], pc[:, 1]
