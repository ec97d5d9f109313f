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
from repro_torch.kernels.bitset_ops.ref import (  # noqa: F401  (re-exported)
    WORD_BITS,
    ExpandOut,
    first_index,
    i32_from_u32,
    pack_bits,
    popcount32,
    popcount_rows,
    single_bit,
    task_rows,
    unpack_bits,
)


class ProblemData(NamedTuple):
    """Static instance tensors, shared by every worker of an instance.

    ``adj`` is the BRANCHING graph's packed adjacency (the problem's
    ``host_adj`` decides what that is), with a leading instance axis: a solo
    solve is the B = 1 case.  Instances of a batch pad to one ``n_max`` with
    zero rows (isolated vertices never in a mask).

    ``inst`` maps each row of the task batch being expanded to its
    instance, so one panel serves every instance of a batch: the plane
    sets it with :func:`for_task_rows`.  None means every row is instance
    0, which only a one-instance ``adj`` allows."""

    n: np.ndarray  # (B,) host int32 -- real (unpadded) vertices per instance
    adj: torch.Tensor  # (B, n_max, W) int32 packed adjacency
    inst: Optional[torch.Tensor] = None  # (T,) int32 -- each task row's instance


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

    @classmethod
    def of(cls, out: ExpandOut) -> "ExpandResult":
        """From a fused kernel's (or its plain version's) outputs."""
        return cls(
            bound=out.bound,
            step=BranchStep(*(getattr(out, f) for f in BranchStep._fields)),
            left_bound=out.left_bound,
            right_bound=out.right_bound,
        )


@dataclasses.dataclass
class WorkCounters:
    """Host-side tallies of data-dependent device work, filled by the solve
    plane when a caller passes one in (never a hidden global).

    ``reduce_sweeps`` is the sum, over the expansions of a batch (an explore
    round, or a composed ``branch_once``), of the largest per-row trip count
    of the reduction loop: the sweeps the JAX package's vmapped
    ``while_loop`` runs.  On the card each round's (T,) trip counts are kept
    as they are, so counting adds no launch and no sync to a round, and
    :meth:`flush`, which the plane runner calls after its own sync at the
    end of a chunk, reduces them all at once.

    On a solver ``mesh`` (:class:`~repro_torch.launch.mesh.SolverMesh`) a
    rank sees only its own worker's rows, so every rank keeps each round's
    trip counts (on the CPU too) and :meth:`flush` takes the max over the
    ranks of the chunk's per-round maxima in ONE collective, once a chunk:
    the same count as the single-process solve's, the same on every rank.
    Every rank runs the same explore rounds, so their lists line up."""

    reduce_sweeps: int = 0
    mesh: object = dataclasses.field(default=None, repr=False, compare=False)
    _pending: list = dataclasses.field(default_factory=list, repr=False)

    def add_sweeps(self, sweeps: torch.Tensor) -> None:
        """Count one batch's reduction: ``sweeps`` (T,) int32 trip counts."""
        if sweeps.numel() == 0:
            return
        if sweeps.device.type == "cpu" and self.mesh is None:
            self.reduce_sweeps += int(sweeps.max())
            return
        self._pending.append(sweeps)

    def flush(self) -> None:
        """Fold the pending trip counts into ``reduce_sweeps``: each
        round's maximum (over the mesh's ranks too), summed, in one read.
        Trip counts are at least 1, so the zeros that pad shorter rounds
        change no maximum."""
        if self._pending:
            rounds = torch.nn.utils.rnn.pad_sequence(self._pending, batch_first=True)
            maxima = rounds.amax(dim=1)
            if self.mesh is not None:
                maxima = self.mesh.all_max(maxima)
            self.reduce_sweeps += int(maxima.sum())
            self._pending = []


# -- packed-bitset primitives ---------------------------------------------------
# (defined beside the kernels' plain versions, which use them too)

popcount = popcount_rows  # popcount summed over the trailing word axis -> int32


# -- the instance axis ---------------------------------------------------------


def for_task_rows(data: ProblemData, rows_per_instance: int) -> ProblemData:
    """``data`` for a task batch laid out instance-major, ``rows_per_instance``
    rows each (the plane's P·lanes): row t belongs to instance
    t // rows_per_instance.  One instance needs no map."""
    B = data.adj.shape[0]
    if B == 1:
        return data._replace(inst=None)
    rows = torch.arange(B * rows_per_instance, device=data.adj.device)
    return data._replace(inst=(rows // rows_per_instance).to(torch.int32))


def row_instances(data: ProblemData, T: int):
    """The (T,) instance map of a T-row task batch, or None (instance 0)."""
    if data.inst is None:
        if data.adj.shape[0] != 1:
            raise ValueError(
                f"ProblemData holds {data.adj.shape[0]} instances but no task "
                f"row map: set it with for_task_rows"
            )
        return None
    if data.inst.shape[0] != T:
        raise ValueError(
            f"task row map has {data.inst.shape[0]} rows, the batch has {T}"
        )
    return data.inst


def adj_rows(data: ProblemData, u: torch.Tensor) -> torch.Tensor:
    """(T,) vertices -> (T, W) adjacency rows, each from its task's instance."""
    return task_rows(data.adj, row_instances(data, u.shape[0]), u)


def degrees_batch(data: ProblemData, masks: torch.Tensor) -> torch.Tensor:
    """(L, W) task masks -> (L, n) induced degrees, -1 outside the mask.

    The composed path's panel (the fused expansions compute their own): ONE
    ``batched_degrees`` call for the whole lane batch of every instance, the
    CUDA kernel on the card and its plain version on the CPU."""
    from repro_torch.kernels.bitset_ops.ops import degrees_op

    return degrees_op(data.adj, masks, row_instances(data, masks.shape[0]))


def expand_stats_batch(data: ProblemData, masks: torch.Tensor, sols: torch.Tensor):
    """(L, W) masks/sols -> (deg (L, n), pc_mask (L,), pc_sol (L,)).

    The fused expand panel (degrees + both popcounts): ONE
    ``batched_expand_stats`` call for the whole lane batch of every
    instance, the CUDA kernel on the card and its plain version on the CPU."""
    from repro_torch.kernels.bitset_ops.ops import expand_stats_op

    return expand_stats_op(
        data.adj, masks, sols, row_instances(data, masks.shape[0])
    )


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

    # host twins of task_bound/child_bound and the terminal objective, in
    # the INTERNAL (minimization) sense over (view, mask, sol_mask) numpy
    # words: what the simulator backends (protocol_sim, centralized) explore
    host_task_bound: Optional[Callable] = None  # admissible pre-expansion bound
    host_child_bound: Optional[Callable] = None  # cheap bound at task birth
    host_terminal_value: Optional[Callable] = None  # internal value of a leaf

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


def require_host_bounds(problem: BranchingProblem) -> BranchingProblem:
    """``problem`` if it carries the host callables the simulator backends
    explore with, else a ``ValueError`` naming what is missing."""
    missing = [
        field
        for field in (
            "branch_once_host",
            "host_task_bound",
            "host_child_bound",
            "host_terminal_value",
        )
        if getattr(problem, field) is None
    ]
    if missing:
        raise ValueError(
            f"problem {problem.name!r} cannot run on a host simulator "
            f"backend: missing {', '.join(missing)} (see BranchingProblem)"
        )
    return problem


def initial_bound(problem: BranchingProblem, g, mode: str, k) -> int:
    """The engine's seed internal best: "worse than any acceptable solution".
    fpt: one worse than the decision target."""
    if mode == "fpt":
        if k is None:
            raise ValueError("fpt mode requires k")
        return int(problem.fpt_target(k)) + 1
    return int(problem.bnb_bound(g))


def make_data(problem: BranchingProblem, g, device) -> ProblemData:
    """One instance's tensors from a host graph, on ``device`` (B = 1)."""
    return make_batch_data(problem, [g], g.n, g.W, device)


def make_batch_data(
    problem: BranchingProblem, graphs, n_max: int, W: int, device
) -> ProblemData:
    """Pack B same-width instances into padded (B, n_max, W) tensors.

    Padding rows are zero (isolated, never-in-mask vertices), so they change
    no branching decision for a problem whose initial mask covers only the
    real vertices: the batched trace stays bit-identical to the solo one."""
    adj = np.zeros((len(graphs), n_max, W), np.uint32)
    for b, g in enumerate(graphs):
        adj[b, : g.n, :] = np.asarray(problem.host_adj(g), np.uint32)
    return ProblemData(
        n=np.array([g.n for g in graphs], np.int32),
        adj=torch.from_numpy(adj.view(np.int32)).to(device),
    )


def slice_instances(data: ProblemData, sel) -> ProblemData:
    """Select instances along the batch axis (host-side compaction); the
    task row map is the plane's to set again."""
    sel = np.asarray(sel, np.int64)
    return ProblemData(
        n=data.n[sel],
        adj=data.adj[torch.from_numpy(sel).to(data.adj.device)],
    )


def make_blank_batch_data(num_lanes: int, n_max: int, W: int, device) -> ProblemData:
    """An all-vacant batched :class:`ProblemData` for a live plane: zero
    adjacency and n = 0 per lane (inert under the frozen-lane select;
    admission overwrites a lane with :func:`write_instance`)."""
    return ProblemData(
        n=np.zeros((num_lanes,), np.int32),
        adj=torch.zeros((num_lanes, n_max, W), dtype=torch.int32, device=device),
    )


def write_instance(
    data: ProblemData, lane: int, problem: BranchingProblem, g
) -> ProblemData:
    """Write one instance into lane ``lane`` of a batched ``data``, in
    place, and return ``data`` (live-plane admission).  ``n`` is set on the
    host; rows past ``g.n`` are zeroed on the device (isolated, never-in-mask
    vertices: :func:`make_batch_data`'s padding rule, so the admitted
    instance's trace is bit-identical to its solo solve).  Shapes never
    change, so the plane is reused as it is."""
    n_max, W = data.adj.shape[1], data.adj.shape[2]
    if g.n > n_max or g.W > W:
        raise ValueError(
            f"instance (n={g.n}, W={g.W}) exceeds the live plane's "
            f"(n_max={n_max}, W={W}) packing"
        )
    adj = np.zeros((n_max, W), np.uint32)
    adj[: g.n, : g.W] = np.asarray(problem.host_adj(g), np.uint32)
    data.n[lane] = g.n
    data.adj[lane].copy_(torch.from_numpy(adj.view(np.int32)))
    return data


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
