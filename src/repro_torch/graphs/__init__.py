"""Bitset graph substrate, host side (numpy copy of ``repro.graphs``).

Graphs are packed ``uint32`` adjacency bitsets of shape ``(n, W)`` with
``W = ceil(n/32)``; the same seed gives the same graph in both packages.
"""

from repro_torch.graphs.bitgraph import (
    BitGraph,
    mask_full,
    pack_masks,
    popcount_rows,
    unpack_mask,
)
from repro_torch.graphs.generators import (
    erdos_renyi,
    p_hat_like,
    parse_dimacs,
    to_dimacs,
)

__all__ = [
    "BitGraph",
    "pack_masks",
    "unpack_mask",
    "popcount_rows",
    "mask_full",
    "erdos_renyi",
    "p_hat_like",
    "parse_dimacs",
    "to_dimacs",
]
