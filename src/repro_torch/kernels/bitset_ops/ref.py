"""Plain PyTorch version of the batched bitset-degree kernel.

The port's twin of ``repro/kernels/bitset_ops/ref.py:16``.  Packed words are
int32 tensors holding the reference's uint32 bits.  It runs on any device:
the CPU tests use it as the path's degree panel, and ``chip_smoke.py`` holds
the CUDA kernel against it on the card.
"""

from __future__ import annotations

import torch

WORD_BITS = 32


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Elementwise popcount of 32-bit words held in int32 -> int32.

    torch has no popcount op; this is the SWAR reduction, done in int64 so
    no step overflows a signed 32-bit value."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) >> 24) & 0xFF).to(torch.int32)


def batched_degrees_ref(adj: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """adj (n, W) int32, masks (T, W) int32 -> degrees (T, n) int32.

    deg[t, v] = popcount(adj[v] & masks[t]) if v in masks[t] else -1.
    """
    n = adj.shape[0]
    inter = adj[None, :, :] & masks[:, None, :]  # (T, n, W)
    deg = popcount32(inter).sum(dim=-1, dtype=torch.int32)
    v = torch.arange(n, device=adj.device)
    word_idx = v // WORD_BITS
    bit_idx = (v % WORD_BITS).to(torch.int32)
    inside = ((masks[:, word_idx] >> bit_idx[None, :]) & 1).bool()  # (T, n)
    return torch.where(inside, deg, -1)
