"""Plain PyTorch versions of the bitset kernels.

The port's twins of ``repro/kernels/bitset_ops/ref.py`` (the two panels)
and of the expansions the fused kernels compute: ``vc_expand_ref`` is
``repro/problems/vertex_cover.py``'s ``expand_tasks`` (its reduction loop
included) and ``clique_expand_ref`` is ``repro/problems/max_clique.py``'s.
Packed words are int32 tensors holding the reference's uint32 bits.  They
run on any device: the CPU path runs them, and ``chip_smoke.py`` and the
CUDA tests hold the kernels against them on the card.

All take an instance axis the JAX package gets from ``vmap``: ``adj`` is
``(n, W)`` for one instance or ``(B, n, W)`` for B, and ``inst`` ((T,)
int32, or None for instance 0) names the instance of each task row.

The vertex-cover reduction rules live here and nowhere else in the port:
``problems/vertex_cover.py`` runs the same sweep with the degree panel on
the card (``batched_degrees``) for its composed path.

Ties: every "first" vertex is the lowest index, as ``jnp.argmax``/``min``
pick it, computed explicitly rather than trusting a torch tie order.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

WORD_BITS = 32
# reduction sweeps between host checks of "is any lane still changing": a
# sweep on a lane at its fixpoint changes nothing, so checking less often
# than every sweep gives the same result with fewer host syncs
REDUCE_CHECK_EVERY = 4


class ExpandOut(NamedTuple):
    """Every output of a fused expansion of T task rows: the pre-expansion
    bound, the two children, terminal detection, both child bounds, and
    (vertex cover) each row's reduction trip count."""

    bound: torch.Tensor  # (T,) int32
    left_mask: torch.Tensor  # (T, W) int32
    left_sol: torch.Tensor
    right_mask: torch.Tensor
    right_sol: torch.Tensor
    is_terminal: torch.Tensor  # (T,) bool
    terminal_sol: torch.Tensor  # (T, W) int32
    terminal_value: torch.Tensor  # (T,) int32
    left_bound: torch.Tensor  # (T,) int32
    right_bound: torch.Tensor  # (T,) int32
    # (T,) int32: sweeps of the row's reduction loop, the last one (which
    # changed nothing) included; None for max clique (no loop)
    sweeps: Optional[torch.Tensor] = None


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Elementwise popcount of 32-bit words held in int32 -> int32.

    torch has no popcount op; this is the SWAR reduction, done in int64 so
    no step overflows a signed 32-bit value."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) >> 24) & 0xFF).to(torch.int32)


def i32_from_u32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 with the same 32 bits."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def unpack_bits(words: torch.Tensor, n: int) -> torch.Tensor:
    """(..., W) int32 -> (..., n) bool (LSB-first)."""
    shifts = torch.arange(WORD_BITS, dtype=torch.int32, device=words.device)
    bits = (words[..., :, None] >> shifts) & 1
    return bits.reshape(*words.shape[:-1], -1)[..., :n].bool()


def pack_bits(bits: torch.Tensor, W: int) -> torch.Tensor:
    """(..., n) bool -> (..., W) int32 (LSB-first)."""
    n = bits.shape[-1]
    pad = W * WORD_BITS - n
    if pad:
        bits = torch.cat(
            [bits, bits.new_zeros((*bits.shape[:-1], pad))], dim=-1
        )
    b = bits.reshape(*bits.shape[:-1], W, WORD_BITS).to(torch.int64)
    shifts = torch.arange(WORD_BITS, dtype=torch.int64, device=bits.device)
    return i32_from_u32((b << shifts).sum(dim=-1))


def single_bit(v: torch.Tensor, W: int) -> torch.Tensor:
    """(...,) vertex indices -> (..., W) int32 masks with only bit v set."""
    word = v // WORD_BITS
    value = i32_from_u32(torch.ones_like(v, dtype=torch.int64) << (v % WORD_BITS))
    cols = torch.arange(W, device=v.device)
    return torch.where(cols == word[..., None], value[..., None], 0).to(torch.int32)


def first_index(cond: torch.Tensor) -> torch.Tensor:
    """(L, m) bool -> (L,) int64 lowest index where cond holds; m if none.

    The tie rule of ``jnp.argmax``/``argmin``, computed explicitly rather
    than trusting a torch tie order."""
    m = cond.shape[-1]
    idx = torch.arange(m, device=cond.device)
    return torch.where(cond, idx, m).amin(dim=-1)


def _lowest_bit(words: torch.Tensor) -> torch.Tensor:
    """Index of the lowest set bit of each nonzero 32-bit word (ffs - 1)."""
    x = words.to(torch.int64) & 0xFFFFFFFF
    return popcount32((x & -x) - 1)


def _highest_bit(words: torch.Tensor) -> torch.Tensor:
    """Index of the highest set bit of each nonzero 32-bit word (31 - clz)."""
    x = words.to(torch.int64) & 0xFFFFFFFF
    for s in (1, 2, 4, 8, 16):
        x = x | (x >> s)
    return popcount32(x) - 1


def task_adjacency(adj: torch.Tensor, inst) -> torch.Tensor:
    """The adjacency each task row reads: ``(1, n, W)`` when every row is
    instance 0 (broadcasts over the rows), else ``adj[inst]`` (T, n, W)."""
    if adj.dim() == 2:
        adj = adj[None]
    if inst is None:
        return adj[:1]
    return adj[inst]


def task_rows(adj: torch.Tensor, inst, u: torch.Tensor) -> torch.Tensor:
    """(T,) vertices -> (T, W) adjacency rows, each from its row's instance."""
    if adj.dim() == 2:
        adj = adj[None]
    if inst is None:
        return adj[0][u]
    return adj[inst, u]


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


def popcount_rows(words: torch.Tensor) -> torch.Tensor:
    """Popcount summed over the trailing word axis -> int32."""
    return popcount32(words).sum(dim=-1, dtype=torch.int32)


def pivot(deg: torch.Tensor):
    """(T, n) degrees -> (u, deg[u]): the first vertex of maximum degree.
    An empty mask (all -1) gives u = 0, as ``jnp.argmax`` does."""
    top = deg.amax(dim=-1)
    return first_index(deg == top[:, None]), top


# -- vertex cover (repro/problems/vertex_cover.py) ------------------------------


def vc_lower_bound(deg: torch.Tensor) -> torch.Tensor:
    """(T, n) degrees -> (T,) ceil(E / maxdeg): each cover vertex covers at
    most maxdeg edges (``lower_bound``, vertex_cover.py:62)."""
    maxdeg = deg.amax(dim=-1).clamp(min=0)
    E = deg.clamp(min=0).sum(dim=-1, dtype=torch.int32) // 2
    ceil = -torch.div(-E, maxdeg.clamp(min=1), rounding_mode="floor")
    return torch.where(maxdeg > 0, ceil, 0).to(torch.int32)


def vc_reduce_step(adj, masks, sols, inst=None, degrees=batched_degrees_ref):
    """One reduction sweep over T task rows -> (masks, sols, changed (T,)).

    ``_reduce_step`` (vertex_cover.py:78), rules in priority 1 > 2 > 3
    (paper §4.1, Chen-Kanj-Jia); a row where no rule applies comes back
    unchanged.  ``degrees`` is the panel: the plain version here, the CUDA
    ``batched_degrees`` on the composed path of the card."""
    n, W = adj.shape[-2:]
    deg = degrees(adj, masks, inst)  # (T, n)
    inside = deg >= 0

    # Rule 1: drop all isolated vertices at once (removals never conflict).
    iso = inside & (deg == 0)
    any_iso = iso.any(dim=-1)
    mask_r1 = masks & ~pack_bits(iso, W)

    # Rule 2: the first degree-1 vertex, one per sweep.
    u2 = first_index(inside & (deg == 1))
    has_u2 = u2 < n
    u2c = u2.clamp(max=n - 1)
    nb2 = task_rows(adj, inst, u2c) & masks
    sol_r2 = sols | nb2
    mask_r2 = masks & ~(nb2 | single_bit(u2c, W))

    # Rule 3: the first degree-2 vertex whose two neighbours are adjacent.
    # Word-wise, as the kernel does: v's first and last neighbour in the
    # mask from the first and last nonzero word of adj[v] & mask, then one
    # bit of the first neighbour's row (the JAX sweep unpacks (n, n) bits).
    A = task_adjacency(adj, inst)  # (1 or T, n, W)
    rows = A & masks[:, None, :]  # (T, n, W)
    nz = rows != 0
    widx = torch.arange(W, device=masks.device)
    fw = torch.where(nz, widx, W).amin(dim=-1).clamp(max=W - 1)  # (T, n)
    lw = torch.where(nz, widx, -1).amax(dim=-1).clamp(min=0)
    first_nb = WORD_BITS * fw + _lowest_bit(rows.gather(-1, fw[..., None])[..., 0])
    last_nb = WORD_BITS * lw + _highest_bit(rows.gather(-1, lw[..., None])[..., 0])
    fc = first_nb.clamp(0, n - 1)
    lc = last_nb.clamp(0, n - 1)
    row_of = torch.arange(A.shape[0], device=masks.device)[:, None]
    lword = lc // WORD_BITS
    edge_word = A[row_of, fc, lword] & masks.gather(-1, lword)
    vw_edge = ((edge_word >> (lc % WORD_BITS)) & 1).bool()
    u3 = first_index(inside & (deg == 2) & vw_edge)
    has_u3 = u3 < n
    u3c = u3.clamp(max=n - 1)
    nb3 = task_rows(adj, inst, u3c) & masks
    sol_r3 = sols | nb3
    mask_r3 = masks & ~(nb3 | single_bit(u3c, W))

    r1, r2, r3 = any_iso[:, None], has_u2[:, None], has_u3[:, None]
    new_masks = torch.where(
        r1, mask_r1, torch.where(r2, mask_r2, torch.where(r3, mask_r3, masks))
    )
    new_sols = torch.where(
        r1, sols, torch.where(r2, sol_r2, torch.where(r3, sol_r3, sols))
    )
    return new_masks, new_sols, any_iso | has_u2 | has_u3


def vc_reduce(adj, masks, sols, inst=None, degrees=batched_degrees_ref,
              check_every: int = REDUCE_CHECK_EVERY):
    """Rules 1-3 on every row to its own fixpoint -> (masks, sols, sweeps).

    ``reduce_instance`` (vertex_cover.py:122) is a per-row ``while_loop``
    that stops after the first sweep that changes nothing, bounded by n + 1
    sweeps; ``sweeps[t]`` is row t's trip count, that last sweep included.
    Every changing sweep removes a vertex, so the bound never binds, and a
    sweep past a row's fixpoint leaves it as it is: the rows still changing
    run whole-batch sweeps together, and the host drops the rows that
    reached their fixpoint every ``check_every`` sweeps."""
    n = adj.shape[-2]
    T = masks.shape[0]
    dev = masks.device
    sweeps = torch.zeros(T, dtype=torch.int32, device=dev)
    live = torch.arange(T, device=dev)  # rows not yet at their fixpoint
    done = 0
    while live.numel() and done < n + 1:
        all_live = live.numel() == T
        m = masks if all_live else masks[live]
        s = sols if all_live else sols[live]
        li = inst if inst is None or all_live else inst[live]
        active = torch.ones(live.numel(), dtype=torch.bool, device=dev)
        trips = torch.zeros(live.numel(), dtype=torch.int32, device=dev)
        for _ in range(check_every):
            trips += active
            m, s, changed = vc_reduce_step(adj, m, s, li, degrees)
            active &= changed
            done += 1
        masks = masks.index_put((live,), m)
        sols = sols.index_put((live,), s)
        sweeps = sweeps.index_add(0, live, trips)
        live = live[active]
    return masks, sols, sweeps.clamp(max=n + 1)


def vc_branch(adj, inst, rmasks, rsols, deg):
    """Branch every REDUCED row on its first maximum-degree vertex u:
    left = (G-u, S+{u}), right = (G-N[u], S+N(u)).  -> (left_mask,
    left_sol, right_mask, right_sol, is_terminal, terminal_sol,
    terminal_value, maxdeg)."""
    W = adj.shape[-1]
    u, maxdeg = pivot(deg)
    u_bit = single_bit(u, W)
    nb = task_rows(adj, inst, u) & rmasks
    return (rmasks & ~u_bit, rsols | u_bit, rmasks & ~(nb | u_bit), rsols | nb,
            maxdeg <= 0, rsols, popcount_rows(rsols), maxdeg)


def vc_expand_ref(adj, masks, sols, inst=None) -> ExpandOut:
    """Vertex cover's ``expand_tasks`` (vertex_cover.py:173) for T rows:
    the bound of the raw mask, the reduction loop to each row's fixpoint,
    and the branch on the reduced mask; every output the ``vc_expand``
    kernel writes.  Child bounds: ``|S|+1`` and ``|S| + maxdeg``."""
    bound = popcount_rows(sols) + vc_lower_bound(batched_degrees_ref(adj, masks, inst))
    rmasks, rsols, sweeps = vc_reduce(adj, masks, sols, inst)
    deg = batched_degrees_ref(adj, rmasks, inst)
    *step, maxdeg = vc_branch(adj, inst, rmasks, rsols, deg)
    pc = step[-1]
    return ExpandOut(bound, *step, left_bound=pc + 1, right_bound=pc + maxdeg,
                     sweeps=sweeps)


# -- max clique and MIS (repro/problems/max_clique.py) --------------------------


def clique_branch(adj, inst, masks, sols, u):
    """Branch every row on candidate u: u joins (candidates shrink to
    P & N(u)) or u is discarded.  -> (left_mask, left_sol, right_mask,
    right_sol, terminal_sol)."""
    u_bit = single_bit(u, masks.shape[-1])
    return (task_rows(adj, inst, u) & masks, sols | u_bit, masks & ~u_bit, sols, sols)


def clique_expand_ref(adj, masks, sols, inst=None) -> ExpandOut:
    """Max clique's ``expand_tasks`` (max_clique.py:56) for T rows (MIS: on
    the complement adjacency): the panel of degrees within P, |P| and |R|,
    the first maximum-degree candidate u, both children and their bounds
    ``-(|R| + 1 + deg[u])`` and ``-(|R| + |P| - 1)``; every output the
    ``clique_expand`` kernel writes."""
    deg, pc_mask, pc_sol = expand_stats_ref(adj, masks, sols, inst)
    u, deg_u = pivot(deg)
    lm, ls, rm, rs, ts = clique_branch(adj, inst, masks, sols, u)
    return ExpandOut(
        bound=-(pc_sol + pc_mask), left_mask=lm, left_sol=ls, right_mask=rm,
        right_sol=rs, is_terminal=pc_mask == 0, terminal_sol=ts,
        terminal_value=-pc_sol, left_bound=-(pc_sol + 1 + deg_u),
        right_bound=-(pc_sol + pc_mask - 1),
    )
