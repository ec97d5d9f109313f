"""``batched_degrees`` and ``batched_expand_stats``: wrappers of the
hand-written CUDA kernels.

They replace the Pallas TPU kernels ``repro/kernels/bitset_ops/kernel.py:180``
(``batched_degrees``, body ``_degrees_kernel`` at :72) and
``repro/kernels/bitset_ops/kernel.py:138`` (``batched_expand_stats``, body
``_expand_stats_kernel`` at :95).  The sources are ``csrc/degrees.cu`` and
``csrc/expand_stats.cu``; each is built with nvcc for ``sm_90a`` on first use
(see :mod:`repro_torch.kernels.build`) and called through ``ctypes``.

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

import torch

from repro_torch.kernels import build, counts
from repro_torch.kernels.bitset_ops.ref import batched_degrees_ref, expand_stats_ref

_P, _I = ctypes.c_void_p, ctypes.c_int


def _launcher(lib_name: str, fn_name: str, n_ptrs: int, err_name: str):
    lib = build.load(lib_name)
    fn = getattr(lib, fn_name)
    if fn.argtypes is None:  # first use in this process
        fn.argtypes = [_P] * n_ptrs + [_I, _I, _I, _I, _P]  # ..., n, W, T, B, stream
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
