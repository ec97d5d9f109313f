"""Packed-bitset graph representation (host side, numpy).

A copy of ``repro.graphs.bitgraph``: the port imports nothing of the JAX
package.  The device-side (torch) twins of these operations live in
``repro_torch.problems.base`` and ``repro_torch.kernels.bitset_ops``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

WORD_BITS = 32


def n_words(n: int) -> int:
    return (n + WORD_BITS - 1) // WORD_BITS


def pack_masks(bool_rows: np.ndarray) -> np.ndarray:
    """Pack a boolean array ``(..., n)`` into ``(..., W)`` uint32 words (LSB-first)."""
    bool_rows = np.asarray(bool_rows, dtype=bool)
    n = bool_rows.shape[-1]
    W = n_words(n)
    pad = W * WORD_BITS - n
    if pad:
        bool_rows = np.concatenate(
            [bool_rows, np.zeros(bool_rows.shape[:-1] + (pad,), dtype=bool)], axis=-1
        )
    bits = bool_rows.reshape(bool_rows.shape[:-1] + (W, WORD_BITS))
    weights = (np.uint64(1) << np.arange(WORD_BITS, dtype=np.uint64)).astype(np.uint64)
    packed = (bits.astype(np.uint64) * weights).sum(axis=-1)
    return packed.astype(np.uint32)


def unpack_mask(words: np.ndarray, n: int) -> np.ndarray:
    """Unpack ``(..., W)`` uint32 words back to a boolean array ``(..., n)``."""
    words = np.asarray(words, dtype=np.uint32)
    bits = (words[..., :, None] >> np.arange(WORD_BITS, dtype=np.uint32)) & np.uint32(1)
    flat = bits.reshape(words.shape[:-1] + (-1,))
    return flat[..., :n].astype(bool)


def popcount_rows(words: np.ndarray) -> np.ndarray:
    """Popcount summed over the trailing word axis."""
    w = np.asarray(words, dtype=np.uint32)
    # numpy>=2 exposes hardware popcount as np.bitwise_count
    return np.bitwise_count(w).sum(axis=-1).astype(np.int64)


def mask_full(n: int) -> np.ndarray:
    """Packed mask with bits 0..n-1 set."""
    W = n_words(n)
    out = np.full((W,), 0xFFFFFFFF, dtype=np.uint32)
    rem = n % WORD_BITS
    if rem:
        out[-1] = np.uint32((1 << rem) - 1)
    return out


def single_bit(v: int, W: int) -> np.ndarray:
    out = np.zeros((W,), dtype=np.uint32)
    out[v // WORD_BITS] = np.uint32(1) << np.uint32(v % WORD_BITS)
    return out


def complement(g: "BitGraph") -> "BitGraph":
    """The complement graph (no self-loops): uv in E' iff u != v and uv not
    in E.  The max-clique <-> independent-set reduction runs through this."""
    dense = g.to_dense()
    comp = ~dense & ~np.eye(g.n, dtype=bool)
    return BitGraph(n=g.n, adj=pack_masks(comp))


@dataclasses.dataclass(frozen=True)
class BitGraph:
    """Immutable packed-adjacency graph.

    adj:  (n, W) uint32, bit v of row u set iff uv in E.  Symmetric, no loops.
    """

    n: int
    adj: np.ndarray  # (n, W) uint32

    @property
    def W(self) -> int:
        return self.adj.shape[1]

    @staticmethod
    def from_edges(n: int, edges) -> "BitGraph":
        W = n_words(n)
        adj = np.zeros((n, W), dtype=np.uint32)
        for u, v in edges:
            if u == v:
                continue
            adj[u, v // WORD_BITS] |= np.uint32(1) << np.uint32(v % WORD_BITS)
            adj[v, u // WORD_BITS] |= np.uint32(1) << np.uint32(u % WORD_BITS)
        return BitGraph(n=n, adj=adj)

    @staticmethod
    def from_dense(dense: np.ndarray) -> "BitGraph":
        dense = np.asarray(dense, dtype=bool)
        n = dense.shape[0]
        dense = dense & ~np.eye(n, dtype=bool)
        dense = dense | dense.T
        return BitGraph(n=n, adj=pack_masks(dense))

    def to_dense(self) -> np.ndarray:
        return unpack_mask(self.adj, self.n)

    def edges(self):
        dense = self.to_dense()
        us, vs = np.nonzero(np.triu(dense, 1))
        return list(zip(us.tolist(), vs.tolist()))

    @property
    def num_edges(self) -> int:
        return int(np.bitwise_count(self.adj).sum()) // 2

    def degrees(self, mask: np.ndarray | None = None) -> np.ndarray:
        """Degrees restricted to the induced subgraph given by packed ``mask``.

        Vertices outside the mask get degree -1.
        """
        if mask is None:
            mask = mask_full(self.n)
        inside = unpack_mask(mask, self.n)
        deg = np.bitwise_count(self.adj & mask[None, :]).sum(axis=-1).astype(np.int64)
        deg[~inside] = -1
        return deg

    def edge_count(self, mask: np.ndarray) -> int:
        deg = self.degrees(mask)
        return int(deg[deg > 0].sum()) // 2

    def neighbors_mask(self, v: int, mask: np.ndarray) -> np.ndarray:
        return self.adj[v] & mask
