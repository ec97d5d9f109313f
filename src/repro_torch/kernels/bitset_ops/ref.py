"""Plain PyTorch versions of the batched bitset kernels.

The port's twins of ``repro/kernels/bitset_ops/ref.py``.  Packed words are
int32 tensors holding the reference's uint32 bits.  They run on any device:
the CPU tests use them as the path's panels, and ``chip_smoke.py`` holds the
CUDA kernels against them on the card.

Both take an instance axis the JAX package gets from ``vmap``: ``adj`` is
``(n, W)`` for one instance or ``(B, n, W)`` for B, and ``inst`` ((T,)
int32, or None for instance 0) names the instance of each task row.
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


def task_adjacency(adj: torch.Tensor, inst) -> torch.Tensor:
    """The adjacency each task row reads: ``(1, n, W)`` when every row is
    instance 0 (broadcasts over the rows), else ``adj[inst]`` (T, n, W)."""
    if adj.dim() == 2:
        adj = adj[None]
    if inst is None:
        return adj[:1]
    return adj[inst]


def batched_degrees_ref(
    adj: torch.Tensor, masks: torch.Tensor, inst=None
) -> torch.Tensor:
    """adj (n, W) or (B, n, W), masks (T, W) int32 -> degrees (T, n) int32.

    deg[t, v] = popcount(adj[inst[t], v] & masks[t]) if v in masks[t] else -1.
    """
    n = adj.shape[-2]
    inter = task_adjacency(adj, inst) & masks[:, None, :]  # (T, n, W)
    deg = popcount32(inter).sum(dim=-1, dtype=torch.int32)
    v = torch.arange(n, device=adj.device)
    word_idx = v // WORD_BITS
    bit_idx = (v % WORD_BITS).to(torch.int32)
    inside = ((masks[:, word_idx] >> bit_idx[None, :]) & 1).bool()  # (T, n)
    return torch.where(inside, deg, -1)


def expand_stats_ref(
    adj: torch.Tensor, masks: torch.Tensor, sols: torch.Tensor, inst=None
):
    """The fused expand panel: -> (deg (T, n) int32, pc_mask (T,) int32,
    pc_sol (T,) int32), the degrees of :func:`batched_degrees_ref` plus the
    popcounts of each task's mask and partial solution."""
    deg = batched_degrees_ref(adj, masks, inst)
    pc_mask = popcount32(masks).sum(dim=-1, dtype=torch.int32)
    pc_sol = popcount32(sols).sum(dim=-1, dtype=torch.int32)
    return deg, pc_mask, pc_sol
