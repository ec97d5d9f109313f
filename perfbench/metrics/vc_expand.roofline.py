"""``vc_expand``'s share of its roofline on the sampled launches of the
profiled chunk: their least times (``roofline.py``) over their device
times in the trace.

One launch reads the (B, n, W) adjacency, the (T, W) masks and sols and,
with more than one instance, the (T,) row map; it writes five (T, W) word
rows, five (T,) scalars and a (T,) flag.  In every reduction sweep a row
runs, each (vertex in the row's mask, word) costs an AND, a popcount and
an add (``in_mask``: the plain reference's replay of the launch's inputs).
"""

from perfbench import roofline


def count(B: int, n: int, W: int, T: int, in_mask: int) -> tuple:
    """(bytes moved, 32-bit AND and add, popcounts) of one launch."""
    moved = 4 * (B * n * W + 2 * T * W + roofline.row_map(B, T) + 5 * T * W + 5 * T) + T
    return moved, 2 * W * in_mask, W * in_mask


def read(obs):
    return roofline.share(obs, "vc_expand", "vc_expand_kernel", count)
