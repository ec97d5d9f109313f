"""Public wrappers for the bitset kernels, dispatched by the tensor's device.

The port of ``repro/kernels/bitset_ops/ops.py``.  A CUDA tensor goes to the
hand-written kernel, a CPU tensor to the plain version.  The JAX package's
``T < 2`` fallback to its reference does not carry over: on the card the
kernel takes every shape, so every degree panel of the solve plane is one
kernel launch.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.bitset_ops.kernel import batched_degrees
from repro_torch.kernels.bitset_ops.ref import batched_degrees_ref


def degrees_op(
    adj: torch.Tensor, masks: torch.Tensor, *, use_kernel: bool = True
) -> torch.Tensor:
    """(n, W) adj x (T, W) masks -> (T, n) induced-subgraph degrees: the
    kernel on CUDA, the plain version on the CPU, the same values bit for
    bit.  ``use_kernel=False`` asks for the plain version on any device."""
    if not use_kernel:
        return batched_degrees_ref(adj, masks)
    return batched_degrees(adj, masks)
