from repro_torch.kernels.flash_attention.kernel import flash_attention, flash_attention_plain
from repro_torch.kernels.flash_attention.ops import attention_op, blockwise_attention
from repro_torch.kernels.flash_attention.ref import attention_ref

__all__ = [
    "attention_op",
    "attention_ref",
    "blockwise_attention",
    "flash_attention",
    "flash_attention_plain",
]
