from repro_torch.kernels.bitset_ops.kernel import batched_degrees, batched_expand_stats
from repro_torch.kernels.bitset_ops.ops import degrees_op, expand_stats_op
from repro_torch.kernels.bitset_ops.ref import (
    batched_degrees_ref,
    expand_stats_ref,
    popcount32,
)

__all__ = [
    "batched_degrees",
    "batched_degrees_ref",
    "batched_expand_stats",
    "degrees_op",
    "expand_stats_op",
    "expand_stats_ref",
    "popcount32",
]
