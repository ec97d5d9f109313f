"""Packed bitsets as the port stores them: int32 words holding 32 vertices
each, lowest bit first."""

from __future__ import annotations

import numpy as np
import torch

WORD_BITS = 32


def unpack(words: torch.Tensor) -> torch.Tensor:
    """(..., W) int32 words -> (..., 32·W) bool."""
    shifts = torch.arange(WORD_BITS, dtype=torch.int32, device=words.device)
    bits = (words[..., :, None] >> shifts) & 1
    return bits.reshape(*words.shape[:-1], -1).bool()


def pack(bits: torch.Tensor) -> torch.Tensor:
    """(..., 32·W) bool -> (..., W) int32 words."""
    W = bits.shape[-1] // WORD_BITS
    b = bits.reshape(*bits.shape[:-1], W, WORD_BITS).to(torch.int64)
    shifts = torch.arange(WORD_BITS, dtype=torch.int64, device=bits.device)
    v = (b << shifts).sum(dim=-1)
    return torch.where(v >= 2**31, v - 2**32, v).to(torch.int32)


def unpack_np(words, n: int) -> np.ndarray:
    """Host words (uint32 or int32) -> (n,) bool; bits past n must be 0,
    which :func:`beyond` reports."""
    w = np.asarray(words).astype(np.uint32)
    bits = (w[:, None] >> np.arange(WORD_BITS, dtype=np.uint32)) & 1
    return bits.reshape(-1)[:n].astype(bool)


def beyond(words, n: int) -> int:
    """The set bits of a host word row at or past vertex n."""
    w = np.asarray(words).astype(np.uint32)
    bits = ((w[:, None] >> np.arange(WORD_BITS, dtype=np.uint32)) & 1).reshape(-1)
    return int(bits[n:].sum())


def padded_adjacency(dense_graphs, W: int, device) -> torch.Tensor:
    """(B, 32·W, 32·W) float64 0/1 adjacency of B dense graphs, each padded
    with isolated vertices: the reference's own copy of what a lane holds."""
    N = WORD_BITS * W
    out = np.zeros((len(dense_graphs), N, N), np.float64)
    for b, g in enumerate(dense_graphs):
        if g is not None:
            n = g.shape[0]
            out[b, :n, :n] = g
    return torch.from_numpy(out).to(device)


def solution(words, n: int, size: int):
    """The (n,) bool set a solution's host words hold, or None where there
    are no words, a bit is set at or past vertex n, or the set does not have
    ``size`` vertices."""
    if words is None or beyond(words, n):
        return None
    s = unpack_np(words, n)
    return s if int(s.sum()) == size else None
