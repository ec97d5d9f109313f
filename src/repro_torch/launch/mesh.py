"""The solver's mesh on ``torch.distributed``: one solver worker a rank.

The port of ``repro/launch/mesh.py``'s ``make_solver_mesh``.  JAX's
``shard_map`` puts one worker of the superstep on each device of a 1-D
mesh; here each worker is a process of a ``torch.distributed`` group, and
the superstep's cross-worker steps (the status words' ``all_gather``, the
best value's ``pmin``, the data plane's sparse ``psum`` or ``all_gather``,
quiescence's ``psum``) are real collectives, the calls of
:class:`SolverMesh`.  Every collective carries int32 (gloo has no uint32;
the port's packed words are int32 already).  gloo runs each of them on CUDA
tensors under torch 2.11 (on an H100: ``repro_torch.launch.collective_probe``),
so no tensor detours through host memory in the port's code.

The mesh runs on the process group the ranks joined, and names its
backend.  The launchers here pick it with :func:`mesh_backend`: NCCL where
every rank of the host has its own card, gloo where ranks share one card
(NCCL refuses two ranks on one GPU) or run on the CPU.  Either way the
tensors stay where the ranks' workers live: gloo moves CUDA tensors itself.

:func:`spawn_mesh` starts a job of ranks on this host (``spawn`` start
method, ``file://`` rendezvous in a temporary directory, a timeout on
everything); under ``torchrun`` the caller joins the group it made instead.
JAX's ``make_production_mesh``/``batch_axes_for`` shard the LM, which the
port serves on one card, and have no counterpart here.
"""

from __future__ import annotations

import dataclasses
import datetime
import multiprocessing
import os
import queue
import tempfile
import time
import traceback
from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.core.superstep import WorkerState, map_state

# the solver's kernel libraries, built once before a job's ranks start
SOLVER_LIBRARIES = ("vc_expand", "clique_expand", "bitset_ops", "expand_stats")


@dataclasses.dataclass
class SolverMesh:
    """A rank's view of the solver mesh: ``size`` ranks of the process
    ``group`` (the default one), this one ``rank``, its worker's tensors on
    ``device``, the collectives on ``backend``.

    The collectives are calls every rank makes in the same order, each on
    this rank's block of a leading axis of 1; ``collectives`` counts them.
    With ``timing`` on, each is bracketed by device synchronisations and
    its host wall adds to ``collective_s`` (so the work queued before it is
    not counted as its time); off, a collective costs no extra sync."""

    rank: int
    size: int
    group: object
    device: torch.device
    backend: str
    timing: bool = False
    collectives: int = 0
    collective_s: float = 0.0

    def _call(self, fn) -> None:
        self.collectives += 1
        if not self.timing:
            fn()
            return
        sync = torch.cuda.synchronize if self.device.type == "cuda" else (lambda: None)
        sync()
        t = time.perf_counter()
        fn()
        sync()
        self.collective_s += time.perf_counter() - t

    def all_gather(self, block: torch.Tensor) -> torch.Tensor:
        """Every rank's ``block`` (1, ...) concatenated in rank order:
        (size, ...)."""
        # the one-tensor form: torch 2.11 and 2.13 both have it, and on an
        # H100 with 4 gloo ranks it took 4.1-4.4 ms a call against the list
        # form's 5.5-13.3 (python -m repro_torch.launch.collective_probe)
        block = block.contiguous()
        out = block.new_empty((self.size * block.shape[0], *block.shape[1:]))
        self._call(lambda: dist.all_gather_into_tensor(out, block, group=self.group))
        return out

    def _all_reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        out = t.clone()
        self._call(lambda: dist.all_reduce(out, op=op, group=self.group))
        return out

    def all_min(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise min of ``t`` over the ranks (JAX's ``pmin``)."""
        return self._all_reduce(t, dist.ReduceOp.MIN)

    def all_max(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise max of ``t`` over the ranks."""
        return self._all_reduce(t, dist.ReduceOp.MAX)

    def all_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise sum of ``t`` over the ranks (JAX's ``psum``)."""
        return self._all_reduce(t, dist.ReduceOp.SUM)

    def barrier(self) -> None:
        self._call(lambda: dist.barrier(group=self.group))

    def shard(self, state: WorkerState) -> WorkerState:
        """This rank's (1, ...) block of a whole (size, ...) state, on the
        mesh's device: every rank slices the same state the same way."""
        if state.best_val.shape[0] != self.size:
            raise ValueError(
                f"the state holds {state.best_val.shape[0]} workers and the "
                f"mesh {self.size} ranks: the state's leading axis must equal "
                f"the mesh size"
            )
        r = self.rank
        return map_state(lambda x: x[r:r + 1].to(self.device, copy=True), state)

    def gather_state(self, block: WorkerState) -> WorkerState:
        """The whole (size, ...) state from every rank's (1, ...) block, leaf
        by leaf, on every rank (bool leaves travel as int32)."""
        return map_state(
            lambda x: self.all_gather(x.to(torch.int32)).to(x.dtype), block
        )


_NO_CUDA = ("the solver mesh runs on CUDA devices by default and CUDA is not "
            "available here; pass device='cpu' to run its ranks on the CPU")


def rank_device(device=None) -> torch.device:
    """The rank's device: ``None`` (or ``"cuda"`` without an index) is card
    ``LOCAL_RANK % device_count`` (``LOCAL_RANK``: torchrun's, or the
    group's rank) and raises ``RuntimeError`` without CUDA; anything else is
    taken as given (``"cpu"`` for the tests)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(_NO_CUDA)
        if dev.index is None:
            local = os.environ.get("LOCAL_RANK")
            local = int(local) if local is not None else dist.get_rank()
            dev = torch.device("cuda", local % torch.cuda.device_count())
    return dev


def mesh_backend(device: torch.device, local_ranks: int) -> str:
    """NCCL when every one of a host's ``local_ranks`` ranks has a card of
    its own, else gloo (ranks sharing a card, or on the CPU)."""
    if (device.type == "cuda" and dist.is_nccl_available()
            and local_ranks <= torch.cuda.device_count()):
        return "nccl"
    return "gloo"


def make_solver_mesh(num_workers: Optional[int] = None, *, device=None) -> SolverMesh:
    """The 1-D solver mesh of this process: one worker per rank of the
    initialized default process group.

    ``num_workers`` (None: the world size) must equal the world size, as
    JAX's state's leading axis must equal its mesh's size; anything else,
    and a missing process group, raises ``ValueError``.  ``device`` as
    :func:`rank_device`."""
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError(
            "the solver mesh needs an initialized torch.distributed process "
            "group (run under torchrun, or start the ranks with spawn_mesh); "
            "none is"
        )
    world = dist.get_world_size()
    n = world if num_workers is None else num_workers
    if n != world:
        raise ValueError(
            f"a solver mesh has one worker per rank: num_workers={n} but the "
            f"process group has {world} ranks"
        )
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return SolverMesh(rank=dist.get_rank(), size=world, group=dist.group.WORLD,
                      device=dev, backend=dist.get_backend())


# -- the launcher ---------------------------------------------------------------


def _rank_main(fn, rank, world, init_method, backend, device, timeout_s, args, results):
    """One rank of a :func:`spawn_mesh` job: join the group, make the mesh,
    run ``fn(mesh, *args)`` and report ``(rank, ok, result or traceback)``.
    A failure is reported before the group is torn down, so the parent sees
    the root cause before any peer's broken collective."""
    os.environ["LOCAL_RANK"] = str(rank)  # this host's rank: picks its card
    try:
        dist.init_process_group(
            backend, init_method=init_method, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s),
        )
        out = fn(make_solver_mesh(world, device=device), *args)
    except Exception:  # the job's boundary: report the traceback to the parent
        results.put((rank, False, traceback.format_exc()))
        results.close()
        results.join_thread()
    else:
        results.put((rank, True, out))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_mesh(fn: Callable, num_workers: int, *, device=None, timeout_s: float = 600.0,
               args: tuple = ()) -> list:
    """Run ``fn(mesh, *args)`` on ``num_workers`` ranks of a new process
    group on this host; returns the ranks' results in rank order.

    ``fn`` is a module-level function (it is pickled by name) and its
    result must pickle (host values, not CUDA tensors).  The ranks are
    started with the ``spawn`` method (a parent with CUDA initialized cannot
    fork), meet through a ``file://`` store in a temporary directory (no TCP
    port to collide with) and run the backend :func:`mesh_backend` picks for
    ``device`` (None: the card, each rank ``cuda:rank % device_count``).
    With CUDA, the solver's kernel libraries are built here first, once,
    rather than by every rank.

    Everything is bounded by ``timeout_s``: the group's own timeout and the
    wait for the results.  When a rank raises, dies or the time runs out,
    the other ranks are terminated and the first rank's traceback is raised
    as ``RuntimeError`` (``TimeoutError`` on time-out)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(_NO_CUDA)
        from repro_torch.kernels import build

        build.build_all(SOLVER_LIBRARIES)
    backend = mesh_backend(dev, num_workers)
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    out = [None] * num_workers
    error = None
    with tempfile.TemporaryDirectory(prefix="repro_torch_mesh_") as tmp:
        init_method = f"file://{os.path.join(tmp, 'rendezvous')}"
        dev_arg = None if device is None else str(device)
        procs = [
            ctx.Process(
                target=_rank_main,
                args=(fn, r, num_workers, init_method, backend, dev_arg, timeout_s,
                      args, results),
            )
            for r in range(num_workers)
        ]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        got = 0
        try:
            while got < num_workers and error is None:
                left = deadline - time.monotonic()
                if left <= 0:
                    error = TimeoutError(
                        f"mesh job of {num_workers} ranks did not finish within "
                        f"{timeout_s} s"
                    )
                    break
                try:
                    rank, ok, payload = results.get(timeout=min(left, 0.5))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode is not None and p.exitcode != 0]
                    if dead:
                        error = RuntimeError(
                            f"mesh rank {dead[0]} exited with code "
                            f"{procs[dead[0]].exitcode} without a result"
                        )
                    continue
                if not ok:
                    error = RuntimeError(f"mesh rank {rank} of {num_workers} raised:\n{payload}")
                else:
                    out[rank] = payload
                    got += 1
        finally:
            for p in procs:
                if error is not None and p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=5)
            results.close()
    if error is not None:
        raise error
    return out
