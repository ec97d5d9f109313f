"""Sequential branching solvers on the host: minimum vertex cover (paper
Algorithm 8), maximum clique and maximum independent set.

A copy of ``repro.problems.sequential``: the port keeps its own ground
truth and imports nothing of the JAX package.

Branch rule: pick a maximum-degree vertex u; either u is in the cover
(recurse on G-u, S+{u}) or all of N(u) is (recurse on G-N(u)-u, S+N(u)).
Reduction rules 1-3 (Chen-Kanj-Jia, paper §4.1) are applied to fixpoint at
every node.  Pruning uses |S| + ceil(E / maxdeg) >= |best|.

Tasks are (mask, sol_mask) pairs of packed uint32 bitsets over the ORIGINAL
vertex set (the paper's optimized encoding, §4.3).  ``branch_once`` is also
the host brancher of the §3.5 startup split
(``repro_torch.problems.base.expand_frontier``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.graphs.bitgraph import (
    BitGraph,
    complement,
    mask_full,
    pack_masks,
    popcount_rows,
    single_bit,
    unpack_mask,
)


@dataclasses.dataclass
class SeqStats:
    nodes: int = 0
    pruned: int = 0
    solutions: int = 0
    max_depth: int = 0


def _first_bit(words: np.ndarray) -> int:
    """Index of the lowest set bit; -1 if empty."""
    for wi, w in enumerate(words.tolist()):
        if w:
            return wi * 32 + (w & -w).bit_length() - 1
    return -1


def reduce_instance(
    g: BitGraph, mask: np.ndarray, sol_mask: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Apply rules 1-3 iteratively until the instance stops changing.

    Rule 1: drop isolated vertices.
    Rule 2: for a degree-1 vertex u with neighbor v, add v to S, drop u, v.
    Rule 3: for a degree-2 vertex u with adjacent neighbors v, w, add v and w
            to S, drop u, v, w.
    """
    mask = mask.copy()
    sol_mask = sol_mask.copy()
    changed = True
    while changed:
        changed = False
        deg = g.degrees(mask)
        inside = deg >= 0
        # Rule 1 (batch-safe: removals never conflict)
        iso = inside & (deg == 0)
        if iso.any():
            mask &= ~pack_masks(iso)
            changed = True
            continue
        # Rule 2 (one vertex per sweep; batching can over-add on isolated edges)
        ones = np.nonzero(inside & (deg == 1))[0]
        if len(ones):
            u = int(ones[0])
            nb = g.adj[u] & mask
            sol_mask |= nb
            mask &= ~(nb | single_bit(u, g.W))
            changed = True
            continue
        # Rule 3
        twos = np.nonzero(inside & (deg == 2))[0]
        for u in twos:
            nb = g.adj[int(u)] & mask
            v = _first_bit(nb)
            rest = nb & ~single_bit(v, g.W)
            w = _first_bit(rest)
            if g.adj[v][w // 32] & np.uint32(1 << (w % 32)):  # v-w edge exists
                sol_mask |= nb
                mask &= ~(nb | single_bit(int(u), g.W))
                changed = True
                break
    return mask, sol_mask


def lower_bound(g: BitGraph, mask: np.ndarray) -> int:
    """ceil(E / maxdeg): every cover vertex covers <= maxdeg edges."""
    deg = g.degrees(mask)
    maxdeg = int(deg.max(initial=-1))
    if maxdeg <= 0:
        return 0
    E = int(deg[deg > 0].sum()) // 2
    return -(-E // maxdeg)


def branch_once(
    g: BitGraph, mask: np.ndarray, sol_mask: np.ndarray
) -> tuple[list[tuple[np.ndarray, np.ndarray]], tuple[np.ndarray, np.ndarray] | None]:
    """One node expansion *after reduction*: returns (children, terminal).

    ``terminal`` is the (mask, sol_mask) if the reduced instance has no edges,
    else None.  ``children`` is the pair of branch sub-instances (paper Alg. 8
    lines 8-11), include-u first.
    """
    mask, sol_mask = reduce_instance(g, mask, sol_mask)
    deg = g.degrees(mask)
    maxdeg = int(deg.max(initial=-1))
    if maxdeg <= 0:
        return [], (mask, sol_mask)
    u = int(np.argmax(deg))
    u_bit = single_bit(u, g.W)
    nb = g.adj[u] & mask
    left = (mask & ~u_bit, sol_mask | u_bit)  # u in the cover
    right = (mask & ~(nb | u_bit), sol_mask | nb)  # N(u) in the cover
    return [left, right], None


def solve_sequential(
    g: BitGraph,
    mode: str = "bnb",
    k: int | None = None,
    initial_best: int | None = None,
    node_limit: int | None = None,
) -> tuple[int, np.ndarray | None, SeqStats]:
    """Exact sequential solve.  Returns (best_size, best_sol_mask, stats).

    mode='bnb'  : minimize |S| (branch and bound).
    mode='fpt'  : decision "is there a cover of size <= k"; stops at first hit.
    """
    if mode == "fpt" and k is None:
        raise ValueError("fpt mode requires k")
    stats = SeqStats()
    best_size = initial_best if initial_best is not None else g.n + 1
    if mode == "fpt":
        best_size = min(best_size, k + 1)
    best_sol: np.ndarray | None = None
    stack = [(mask_full(g.n), np.zeros(g.W, dtype=np.uint32), 0)]
    while stack:
        if node_limit is not None and stats.nodes >= node_limit:
            break
        mask, sol_mask, depth = stack.pop()
        stats.nodes += 1
        stats.max_depth = max(stats.max_depth, depth)
        sol_size = int(popcount_rows(sol_mask))
        if sol_size + lower_bound(g, mask) >= best_size:
            stats.pruned += 1
            continue
        children, terminal = branch_once(g, mask, sol_mask)
        if terminal is not None:
            _, tsol = terminal
            tsize = int(popcount_rows(tsol))
            if tsize < best_size:
                best_size = tsize
                best_sol = tsol
                stats.solutions += 1
                if mode == "fpt" and best_size <= k:
                    break
            continue
        # push right first so left (include-u) is explored first
        for child in reversed(children):
            cmask, csol = child
            if int(popcount_rows(csol)) < best_size:
                stack.append((cmask, csol, depth + 1))
            else:
                stats.pruned += 1
    if mode == "fpt":
        found = best_size <= k
        return (best_size if found else -1), (best_sol if found else None), stats
    return best_size, best_sol, stats


# -- max-clique / maximum-independent-set references ---------------------------
#
# Ground truth for the `max_clique` and `mis` plugins, mirroring the device
# brancher: tasks are (candidate-set P, clique R) packed-bitset pairs; branch
# on a maximum-degree candidate u -- either u joins the clique (candidates
# shrink to P & N(u)) or u is discarded.  Bound: |R| + |P|.  MIS is
# max-clique on the complement.


def branch_once_clique(
    g: BitGraph, mask: np.ndarray, sol_mask: np.ndarray
) -> tuple[list[tuple[np.ndarray, np.ndarray]], tuple[np.ndarray, np.ndarray] | None]:
    """One candidate-set expansion on the (branching) graph ``g``.

    ``mask`` = candidates P, ``sol_mask`` = current clique R.  Terminal when
    no candidates remain.  Children come include-u first, matching the
    device brancher's order.
    """
    deg = g.degrees(mask)
    if not (deg >= 0).any():  # P empty
        return [], (mask, sol_mask)
    u = int(np.argmax(deg))  # max degree within P, ties -> lowest index
    u_bit = single_bit(u, g.W)
    nb = g.adj[u] & mask
    left = (nb, sol_mask | u_bit)  # u joins: candidates must be neighbours
    right = (mask & ~u_bit, sol_mask)  # u discarded
    return [left, right], None


def solve_sequential_max_clique(
    g: BitGraph,
    mode: str = "bnb",
    k: int | None = None,
    node_limit: int | None = None,
) -> tuple[int, np.ndarray | None, SeqStats]:
    """Exact maximum clique.  Returns (best_size, best_sol_mask, stats).

    mode='bnb' : maximize |R|.
    mode='fpt' : decision "is there a clique of size >= k"; stops at the
                 first hit, returns (-1, None, stats) when unsatisfiable.
    """
    if mode == "fpt" and k is None:
        raise ValueError("fpt mode requires k")
    stats = SeqStats()
    best_size = 0
    best_sol = np.zeros(g.W, dtype=np.uint32)  # the empty clique
    floor = (k - 1) if mode == "fpt" else 0  # prune below the decision target
    stack = [(mask_full(g.n), np.zeros(g.W, dtype=np.uint32), 0)]
    while stack:
        if node_limit is not None and stats.nodes >= node_limit:
            break
        mask, sol_mask, depth = stack.pop()
        stats.nodes += 1
        stats.max_depth = max(stats.max_depth, depth)
        r = int(popcount_rows(sol_mask))
        if r + int(popcount_rows(mask)) <= max(best_size, floor):
            stats.pruned += 1
            continue
        children, terminal = branch_once_clique(g, mask, sol_mask)
        if terminal is not None:
            if r > best_size:
                best_size, best_sol = r, sol_mask
                stats.solutions += 1
                if mode == "fpt" and best_size >= k:
                    break
            continue
        # push right first so left (include-u, the promising child) pops first
        for cmask, csol in reversed(children):
            stack.append((cmask, csol, depth + 1))
    if mode == "fpt":
        found = best_size >= k
        return (best_size if found else -1), (best_sol if found else None), stats
    return best_size, best_sol, stats


def solve_sequential_mis(
    g: BitGraph,
    mode: str = "bnb",
    k: int | None = None,
    node_limit: int | None = None,
) -> tuple[int, np.ndarray | None, SeqStats]:
    """Exact maximum independent set = max clique on the complement graph.
    The returned mask is the independent set in the ORIGINAL graph."""
    return solve_sequential_max_clique(
        complement(g), mode=mode, k=k, node_limit=node_limit
    )


def verify_clique(g: BitGraph, sol_mask: np.ndarray) -> bool:
    """True iff every pair of vertices in sol_mask is adjacent in g."""
    sel = np.flatnonzero(unpack_mask(sol_mask, g.n))
    dense = g.to_dense()
    return all(dense[u, v] for i, u in enumerate(sel) for v in sel[i + 1 :])


def verify_independent_set(g: BitGraph, sol_mask: np.ndarray) -> bool:
    """True iff no edge of g has both endpoints in sol_mask."""
    sel = unpack_mask(sol_mask, g.n)
    dense = g.to_dense()
    return not (dense & sel[:, None] & sel[None, :]).any()


def verify_cover(g: BitGraph, sol_mask: np.ndarray) -> bool:
    """True iff sol_mask covers every edge of g."""
    in_cover = unpack_mask(sol_mask, g.n)
    dense = g.to_dense()
    uncovered = dense & ~in_cover[:, None] & ~in_cover[None, :]
    return not uncovered.any()


def brute_force_mvc(g: BitGraph) -> int:
    """Exponential brute force over all subsets -- only for tiny test graphs."""
    if g.n > 16:
        raise ValueError(f"brute_force_mvc is for n <= 16, got n={g.n}")
    dense = g.to_dense()
    us, vs = np.nonzero(np.triu(dense, 1))
    best = g.n
    for bits in range(1 << g.n):
        size = bin(bits).count("1")
        if size >= best:
            continue
        sel = np.array([(bits >> i) & 1 for i in range(g.n)], dtype=bool)
        if np.all(sel[us] | sel[vs]):
            best = size
    return best
