from repro_torch.kernels.bitset_ops.kernel import batched_degrees
from repro_torch.kernels.bitset_ops.ops import degrees_op
from repro_torch.kernels.bitset_ops.ref import batched_degrees_ref, popcount32

__all__ = [
    "batched_degrees",
    "batched_degrees_ref",
    "degrees_op",
    "popcount32",
]
