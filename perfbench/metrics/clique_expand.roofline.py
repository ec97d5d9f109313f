"""``clique_expand``'s share of its roofline on the sampled launches of the
profiled chunk: their least times (``roofline.py``) over their device
times in the trace.

One launch reads what ``vc_expand`` reads and writes three (T, W) word
rows, four (T,) scalars and a (T,) flag.  Each (candidate, word) of a row
costs an AND, a popcount and an add (its degree panel), and each mask and
sol word a popcount and an add.
"""

from perfbench import roofline


def count(B: int, n: int, W: int, T: int, in_mask: int) -> tuple:
    """(bytes moved, 32-bit AND and add, popcounts) of one launch."""
    moved = 4 * (B * n * W + 2 * T * W + roofline.row_map(B, T) + 3 * T * W + 4 * T) + T
    return moved, 2 * W * in_mask + 2 * T * W, W * in_mask + 2 * T * W


def read(obs):
    return roofline.share(obs, "clique_expand", "clique_expand_kernel", count)
