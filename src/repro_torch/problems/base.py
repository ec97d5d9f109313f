"""The ``BranchingProblem`` plugin protocol and packed-bitset primitives.

The port of ``repro/problems/base.py``.  A task is ``(mask, sol, depth)``
over packed words of the ORIGINAL vertex set (the paper's optimized
encoding, §4.3).  Words are int32 tensors: ``torch.uint32`` lacks ``~``,
``>>``, ``+``, ``max`` and scatter, and int32 holds the same bits.  Logical
shifts are ``(x >> s) & mask``; popcount is SWAR
(:func:`repro_torch.kernels.bitset_ops.ref.popcount32`).

Device callables are batched over a leading lane axis ``L`` (the JAX package
vmaps per-task functions instead): ``(data, masks (L, W), sols (L, W))``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.graphs.bitgraph import mask_full
from repro_torch.kernels.bitset_ops.ref import popcount32

WORD_BITS = 32


class ProblemData(NamedTuple):
    """Static per-instance device tensors, shared by every worker.

    ``adj`` is the BRANCHING graph's packed adjacency (the problem's
    ``host_adj`` decides what that is)."""

    n: int  # number of vertices
    adj: torch.Tensor  # (n, W) int32 packed adjacency


class BranchStep(NamedTuple):
    """A batch of node expansions: two children per lane plus terminal
    detection.  ``terminal_value`` is the INTERNAL (minimization) value."""

    left_mask: torch.Tensor  # (L, W)
    left_sol: torch.Tensor
    right_mask: torch.Tensor
    right_sol: torch.Tensor
    is_terminal: torch.Tensor  # (L,) bool
    terminal_sol: torch.Tensor  # (L, W)
    terminal_value: torch.Tensor  # (L,) int32


class ExpandResult(NamedTuple):
    """One-pass batched expansion of L popped tasks (the fused hot path):
    the pre-expansion bound, the branch step and both children's birth-time
    bounds.  Child bounds are only read on non-terminal, non-pruned lanes."""

    bound: torch.Tensor  # (L,) int32
    step: BranchStep
    left_bound: torch.Tensor  # (L,) int32
    right_bound: torch.Tensor  # (L,) int32


@dataclasses.dataclass
class WorkCounters:
    """Host-side tallies of data-dependent device work, filled by the solve
    plane when a caller passes one in (never a hidden global)."""

    reduce_sweeps: int = 0  # reduction sweeps run over a whole lane batch


# -- packed-bitset primitives ---------------------------------------------------


def popcount(words: torch.Tensor) -> torch.Tensor:
    """Popcount summed over the trailing word axis -> int32."""
    return popcount32(words).sum(dim=-1, dtype=torch.int32)


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


def degrees_batch(data: ProblemData, masks: torch.Tensor) -> torch.Tensor:
    """(L, W) task masks -> (L, n) induced degrees, -1 outside the mask.

    The branching hot spot: ONE ``batched_degrees`` call for the whole lane
    batch, the CUDA kernel on the card and its plain version on the CPU."""
    from repro_torch.kernels.bitset_ops.ops import degrees_op

    return degrees_op(data.adj, masks)


def edge_count(deg: torch.Tensor) -> torch.Tensor:
    """(L, n) degrees -> (L,) int32 edge counts of the induced subgraphs."""
    return deg.clamp(min=0).sum(dim=-1, dtype=torch.int32) // 2


# -- the plugin contract --------------------------------------------------------

# Default on-the-wire task record: the frontier's native (mask, sol, depth)
# row.  Widths are symbolic: "W" -> packed words, "n*W" -> adjacency payload,
# int -> literal word count (resolved by repro_torch.core.encoding).
RECORD_FIELDS = (("mask", "W"), ("sol", "W"), ("depth", 1))


@dataclasses.dataclass(frozen=True)
class BranchingProblem:
    """A branching problem plugged into the generic solve plane.

    Device callables are torch functions over ``(data, masks, sols)`` batched
    over lanes; the engine always minimizes internal int32 values.  Host
    callables operate on :class:`~repro_torch.graphs.bitgraph.BitGraph`.
    """

    name: str
    objective: str

    # device: batched expansion and admissible internal-value bounds
    branch_once: Callable[..., BranchStep]
    task_bound: Callable[..., Any]
    child_bound: Callable[..., Any]

    bnb_bound: Callable[[Any], int]  # internal value worse than any solution

    # optional fused hot path (bound + branch + child bounds in one pass);
    # None -> the engine composes the three callables
    expand_tasks: Optional[Callable[..., ExpandResult]] = None
    external_value: Callable[[int], int] = staticmethod(lambda v: v)
    fpt_target: Callable[[int], int] = staticmethod(lambda k: k)

    # host plumbing
    host_adj: Callable[[Any], np.ndarray] = staticmethod(lambda g: g.adj)
    host_view: Callable[[Any], Any] = staticmethod(lambda g: g)
    branch_once_host: Optional[Callable] = None  # startup BFS split
    sequential: Optional[Callable] = None  # ground-truth reference solver
    verify: Optional[Callable] = None  # (g, sol_mask) -> bool

    record_fields: tuple = RECORD_FIELDS


def compose_expand_tasks(problem: BranchingProblem) -> Callable:
    """The default batched expansion from the three per-batch callables."""

    def expand(data, masks, sols, counters=None) -> ExpandResult:
        bound = problem.task_bound(data, masks, sols)
        step = problem.branch_once(data, masks, sols, counters=counters)
        return ExpandResult(
            bound=bound,
            step=step,
            left_bound=problem.child_bound(data, step.left_mask, step.left_sol),
            right_bound=problem.child_bound(data, step.right_mask, step.right_sol),
        )

    return expand


def resolve_expand(problem: BranchingProblem) -> Callable:
    """The plane's batched expansion: the problem's fused ``expand_tasks``
    when it ships one, else the composed default."""
    if problem.expand_tasks is not None:
        return problem.expand_tasks
    return compose_expand_tasks(problem)


def initial_bound(problem: BranchingProblem, g, mode: str, k) -> int:
    """The engine's seed internal best: "worse than any acceptable solution".
    fpt: one worse than the decision target."""
    if mode == "fpt":
        if k is None:
            raise ValueError("fpt mode requires k")
        return int(problem.fpt_target(k)) + 1
    return int(problem.bnb_bound(g))


def make_data(problem: BranchingProblem, g, device) -> ProblemData:
    """Per-instance device tensors from a host graph, on ``device``."""
    adj = np.ascontiguousarray(problem.host_adj(g), dtype=np.uint32)
    return ProblemData(n=int(g.n), adj=torch.from_numpy(adj.view(np.int32)).to(device))


def expand_frontier(
    problem: BranchingProblem,
    g,
    num_tasks: int,
    max_nodes: int = 10_000,
):
    """Startup-phase breadth-first split (paper §3.5), on the host: expand
    the root until at least ``num_tasks`` open tasks exist.  Returns
    ``[(mask, sol_mask, depth)]`` as uint32 numpy rows; terminal nodes met
    during the split are kept.  Pops the shallowest open task, appends
    children in the plugin's order (the JAX package's order exactly)."""
    view = problem.host_view(g)
    frontier = [(mask_full(g.n), np.zeros(g.W, dtype=np.uint32), 0)]
    terminals = []
    nodes = 0
    while (
        len(frontier) + len(terminals) < num_tasks
        and frontier
        and nodes < max_nodes
    ):
        idx = min(range(len(frontier)), key=lambda i: frontier[i][2])
        mask, sol_mask, depth = frontier.pop(idx)
        nodes += 1
        children, terminal = problem.branch_once_host(view, mask, sol_mask)
        if terminal is not None:
            terminals.append((terminal[0], terminal[1], depth))
            continue
        for cmask, csol in children:
            frontier.append((cmask, csol, depth + 1))
    return frontier + terminals
