"""Wrappers of the hand-written CUDA bitset kernels.

``batched_degrees`` and ``batched_expand_stats`` replace the Pallas TPU
kernels ``repro/kernels/bitset_ops/kernel.py:180`` (``batched_degrees``,
body ``_degrees_kernel`` at :72) and ``repro/kernels/bitset_ops/kernel.py:138``
(``batched_expand_stats``, body ``_expand_stats_kernel`` at :95), sources
``csrc/degrees.cu`` and ``csrc/expand_stats.cu``.  ``vc_expand`` and
``clique_expand`` are the Hopper redesign of the same two kernels on the
solver's hot path: each computes its problem's whole ``expand_tasks`` in one
launch, the panel inside the work that consumes it (``csrc/vc_expand.cu``,
``csrc/clique_expand.cu``, sharing ``csrc/bitset_block.cuh``).  Each source
is built with nvcc for ``sm_90a`` on first use (see
:mod:`repro_torch.kernels.build`) and called through ``ctypes``.

Both take an instance axis: ``adj`` is ``(n, W)`` or ``(B, n, W)`` and
``inst`` ((T,) int32, or None for instance 0) names each task row's
instance, so a panel over every instance of a batch is one launch.

What bounds them on an H100: at the solver's shapes (T = 128 tasks, n of
300-600, W of 10-19) each moves under 0.4 MB, ~0.1 us at 3.35 TB/s, so a
call costs its launch latency; the panels per explore round, not a kernel
body, set the path's cost.

A CPU tensor takes the plain version (``ref.py``) because it lies on the
CPU; a CUDA tensor launches the kernel or raises.  There is no fallback from
the card to the plain version.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, counts
from repro_torch.kernels.bitset_ops.ref import (
    ExpandOut,
    batched_degrees_ref,
    clique_expand_ref,
    expand_stats_ref,
    vc_expand_ref,
)

_P, _I = ctypes.c_void_p, ctypes.c_int


def _launcher(lib_name: str, fn_name: str, n_ptrs: int, err_name: str, n_ints: int = 4):
    lib = build.load(lib_name)
    fn = getattr(lib, fn_name)
    if fn.argtypes is None:  # first use in this process
        fn.argtypes = [_P] * n_ptrs + [_I] * n_ints + [_P]  # ..., n, W, T, B[, ...], stream
        fn.restype = ctypes.c_int
        err = getattr(lib, err_name)
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
    return fn, getattr(lib, err_name)


def _check(name: str, adj: torch.Tensor, inst, **rows: torch.Tensor) -> torch.Tensor:
    """Validate the inputs; returns adj as (B, n, W)."""
    for arg, t in (("adj", adj), *rows.items()):
        if t.device != adj.device:
            raise ValueError(f"{name}: {arg} on {t.device}, adj on {adj.device}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: {arg} must be int32, got {t.dtype}")
    if adj.dim() == 2:
        adj = adj[None]
    if adj.dim() != 3:
        raise ValueError(f"{name}: adj must be (n, W) or (B, n, W), got {tuple(adj.shape)}")
    B, n, W = adj.shape
    T = rows["masks"].shape[0]
    for arg, t in rows.items():
        if t.shape != (T, W):
            raise ValueError(
                f"{name}: {arg} must be ({T}, {W}) words to match adj, "
                f"got {tuple(t.shape)}"
            )
    if n > 32 * W:
        raise ValueError(f"{name}: n={n} vertices do not fit W={W} words")
    if inst is not None:
        if inst.device != adj.device or inst.dtype != torch.int32:
            raise TypeError(f"{name}: inst must be int32 on {adj.device}")
        if inst.shape != (T,):
            raise ValueError(f"{name}: inst must be ({T},), got {tuple(inst.shape)}")
    elif B != 1:
        raise ValueError(f"{name}: adj holds {B} instances, so inst is required")
    return adj


def _route(name: str, adj: torch.Tensor, *tensors) -> bool:
    """True: launch the kernel (CUDA tensors).  False: the plain version
    (CPU tensors).  Any other device raises."""
    if adj.device.type == "cpu":
        return False
    if adj.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {adj.device}")
    if not all(t is None or t.is_contiguous() for t in (adj, *tensors)):
        raise ValueError(f"{name}: inputs must be contiguous")
    return True


def _raise(name: str, err, rc: int, shape: str) -> None:
    if rc != 0:
        msg = err(rc).decode()
        raise RuntimeError(f"{name} launch failed ({shape}): CUDA error {rc}: {msg}")


def batched_degrees(
    adj: torch.Tensor, masks: torch.Tensor, inst=None
) -> torch.Tensor:
    """adj (n, W) or (B, n, W), masks (T, W), inst (T,) or None, all int32
    -> (T, n) int32 degrees."""
    name = "batched_degrees"
    adj3 = _check(name, adj, inst, masks=masks)
    if not _route(name, adj3, masks, inst):
        return batched_degrees_ref(adj, masks, inst)
    B, n, W = adj3.shape
    T = masks.shape[0]
    out = torch.empty((T, n), dtype=torch.int32, device=adj.device)
    if T == 0:
        return out
    fn, err = _launcher("bitset_ops", "batched_degrees_launch", 4, "bitset_ops_error_string")
    with torch.cuda.device(adj.device):
        stream = torch.cuda.current_stream(adj.device).cuda_stream
        rc = fn(adj3.data_ptr(), masks.data_ptr(),
                None if inst is None else inst.data_ptr(), out.data_ptr(),
                n, W, T, B, stream)
    _raise(name, err, rc, f"T={T}, B={B}, n={n}, W={W}")
    counts.bump(name)
    return out


def batched_expand_stats(
    adj: torch.Tensor, masks: torch.Tensor, sols: torch.Tensor, inst=None
):
    """adj (n, W) or (B, n, W), masks/sols (T, W), inst (T,) or None, all
    int32 -> (deg (T, n) int32, pc (T, 2) int32) with pc[:, 0] =
    popcount(mask) and pc[:, 1] = popcount(sol)."""
    name = "batched_expand_stats"
    adj3 = _check(name, adj, inst, masks=masks, sols=sols)
    if not _route(name, adj3, masks, sols, inst):
        deg, pc_mask, pc_sol = expand_stats_ref(adj, masks, sols, inst)
        return deg, torch.stack([pc_mask, pc_sol], dim=1)
    B, n, W = adj3.shape
    T = masks.shape[0]
    deg = torch.empty((T, n), dtype=torch.int32, device=adj.device)
    pc = torch.empty((T, 2), dtype=torch.int32, device=adj.device)
    if T == 0:
        return deg, pc
    fn, err = _launcher(
        "expand_stats", "batched_expand_stats_launch", 6, "expand_stats_error_string"
    )
    with torch.cuda.device(adj.device):
        stream = torch.cuda.current_stream(adj.device).cuda_stream
        rc = fn(adj3.data_ptr(), masks.data_ptr(), sols.data_ptr(),
                None if inst is None else inst.data_ptr(),
                deg.data_ptr(), pc.data_ptr(), n, W, T, B, stream)
    _raise(name, err, rc, f"T={T}, B={B}, n={n}, W={W}")
    counts.bump(name)
    return deg, pc


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _expand_outputs(T: int, W: int, n_words: int, n_stats: int, device):
    words = torch.empty((n_words, T, W), dtype=torch.int32, device=device)
    stats = torch.empty((n_stats, T), dtype=torch.int32, device=device)
    is_terminal = torch.empty((T,), dtype=torch.bool, device=device)
    return words, stats, is_terminal


def vc_expand(adj: torch.Tensor, masks: torch.Tensor, sols: torch.Tensor,
              inst=None) -> ExpandOut:
    """Vertex cover's ``expand_tasks`` for T task rows in one launch: adj
    (n, W) or (B, n, W), masks/sols (T, W), inst (T,) or None, all int32 ->
    :class:`ExpandOut` with each row's reduction trip count in ``sweeps``.

    One block a row runs the row's reduction loop to its fixpoint on the
    card (``csrc/vc_expand.cu``)."""
    name = "vc_expand"
    adj3 = _check(name, adj, inst, masks=masks, sols=sols)
    if not _route(name, adj3, masks, sols, inst):
        return vc_expand_ref(adj, masks, sols, inst)
    B, n, W = adj3.shape
    T = masks.shape[0]
    words, stats, is_terminal = _expand_outputs(T, W, 5, 5, adj.device)
    if T > 0:
        fn, err = _launcher("vc_expand", "vc_expand_launch", 7, "vc_expand_error_string")
        with torch.cuda.device(adj.device):
            stream = torch.cuda.current_stream(adj.device).cuda_stream
            rc = fn(adj3.data_ptr(), masks.data_ptr(), sols.data_ptr(),
                    None if inst is None else inst.data_ptr(),
                    words.data_ptr(), stats.data_ptr(), is_terminal.data_ptr(),
                    n, W, T, B, stream)
        _raise(name, err, rc, f"T={T}, B={B}, n={n}, W={W}")
        counts.bump(name)
    return ExpandOut(
        bound=stats[0], left_mask=words[0], left_sol=words[1], right_mask=words[2],
        right_sol=words[3], is_terminal=is_terminal, terminal_sol=words[4],
        terminal_value=stats[1], left_bound=stats[2], right_bound=stats[3],
        sweeps=stats[4],
    )


def clique_expand(adj: torch.Tensor, masks: torch.Tensor, sols: torch.Tensor,
                  inst=None) -> ExpandOut:
    """Max clique's ``expand_tasks`` (MIS: on the complement adjacency) for T
    task rows in one launch -> :class:`ExpandOut` (``sweeps`` None).

    A block serves ceil(T / SMs) consecutive rows with its instance's
    adjacency staged once (``csrc/clique_expand.cu``).  ``right_sol`` and
    ``terminal_sol`` are ``sols`` itself, as in the JAX package."""
    name = "clique_expand"
    adj3 = _check(name, adj, inst, masks=masks, sols=sols)
    if not _route(name, adj3, masks, sols, inst):
        return clique_expand_ref(adj, masks, sols, inst)
    B, n, W = adj3.shape
    T = masks.shape[0]
    words, stats, is_terminal = _expand_outputs(T, W, 3, 4, adj.device)
    if T > 0:
        rows_per_block = -(-T // _sm_count(adj.device.index))
        fn, err = _launcher("clique_expand", "clique_expand_launch", 7,
                            "clique_expand_error_string", n_ints=5)
        with torch.cuda.device(adj.device):
            stream = torch.cuda.current_stream(adj.device).cuda_stream
            rc = fn(adj3.data_ptr(), masks.data_ptr(), sols.data_ptr(),
                    None if inst is None else inst.data_ptr(),
                    words.data_ptr(), stats.data_ptr(), is_terminal.data_ptr(),
                    n, W, T, B, rows_per_block, stream)
        _raise(name, err, rc, f"T={T}, B={B}, n={n}, W={W}")
        counts.bump(name)
    return ExpandOut(
        bound=stats[0], left_mask=words[0], left_sol=words[1], right_mask=words[2],
        right_sol=sols, is_terminal=is_terminal, terminal_sol=sols,
        terminal_value=stats[1], left_bound=stats[2], right_bound=stats[3],
    )
