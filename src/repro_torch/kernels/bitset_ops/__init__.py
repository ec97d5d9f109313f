from repro_torch.kernels.bitset_ops.kernel import (
    batched_degrees,
    batched_expand_stats,
    clique_expand,
    vc_expand,
)
from repro_torch.kernels.bitset_ops.ops import degrees_op, expand_stats_op
from repro_torch.kernels.bitset_ops.ref import (
    ExpandOut,
    batched_degrees_ref,
    clique_expand_ref,
    expand_stats_ref,
    popcount32,
    vc_expand_ref,
)

__all__ = [
    "ExpandOut",
    "batched_degrees",
    "batched_degrees_ref",
    "batched_expand_stats",
    "clique_expand",
    "clique_expand_ref",
    "degrees_op",
    "expand_stats_op",
    "expand_stats_ref",
    "popcount32",
    "vc_expand",
    "vc_expand_ref",
]
