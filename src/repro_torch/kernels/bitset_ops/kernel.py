"""``batched_degrees``: wrapper of the hand-written CUDA kernel.

Replaces the Pallas TPU kernel ``repro/kernels/bitset_ops/kernel.py:180``
(``batched_degrees``, body ``_degrees_kernel`` at :72).  The kernel source is
``csrc/degrees.cu``; it is built with nvcc for ``sm_90a`` on first use (see
:mod:`repro_torch.kernels.build`) and called through ``ctypes``.

What bounds it on an H100: at the solver's shape (T = 128, n = 600, W = 19)
it moves ~0.36 MB, ~0.1 us at 3.35 TB/s, so each call costs its launch
latency; the degree panels per explore round, not the kernel body, set the
path's cost.

A CPU tensor takes the plain version (``ref.batched_degrees_ref``) because it
lies on the CPU; a CUDA tensor launches the kernel or raises.  There is no
fallback from the card to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, counts
from repro_torch.kernels.bitset_ops.ref import batched_degrees_ref

NAME = "batched_degrees"


def _launcher():
    lib = build.load("bitset_ops")
    fn = lib.batched_degrees_launch
    if fn.argtypes is None:  # first use in this process
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        lib.bitset_ops_error_string.argtypes = [ctypes.c_int]
        lib.bitset_ops_error_string.restype = ctypes.c_char_p
    return lib, fn


def _check(adj: torch.Tensor, masks: torch.Tensor) -> None:
    if adj.device != masks.device:
        raise ValueError(
            f"batched_degrees: adj on {adj.device}, masks on {masks.device}"
        )
    for name, t in (("adj", adj), ("masks", masks)):
        if t.dtype != torch.int32:
            raise TypeError(f"batched_degrees: {name} must be int32, got {t.dtype}")
        if t.dim() != 2:
            raise ValueError(
                f"batched_degrees: {name} must be 2-D, got shape {tuple(t.shape)}"
            )
    n, W = adj.shape
    if masks.shape[1] != W:
        raise ValueError(
            f"batched_degrees: masks have {masks.shape[1]} words, adj has {W}"
        )
    if n > 32 * W:
        raise ValueError(f"batched_degrees: n={n} vertices do not fit W={W} words")


def batched_degrees(adj: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """adj (n, W) int32, masks (T, W) int32 -> (T, n) int32 degrees."""
    _check(adj, masks)
    if adj.device.type == "cpu":
        return batched_degrees_ref(adj, masks)
    if adj.device.type != "cuda":
        raise ValueError(f"batched_degrees: no kernel for device {adj.device}")
    if not (adj.is_contiguous() and masks.is_contiguous()):
        raise ValueError("batched_degrees: adj and masks must be contiguous")
    n, W = adj.shape
    T = masks.shape[0]
    out = torch.empty((T, n), dtype=torch.int32, device=adj.device)
    if T == 0 or n == 0:
        return out
    lib, fn = _launcher()
    with torch.cuda.device(adj.device):
        stream = torch.cuda.current_stream(adj.device).cuda_stream
        rc = fn(adj.data_ptr(), masks.data_ptr(), out.data_ptr(), n, W, T, stream)
    if rc != 0:
        msg = lib.bitset_ops_error_string(rc).decode()
        raise RuntimeError(
            f"batched_degrees launch failed (T={T}, n={n}, W={W}): "
            f"CUDA error {rc}: {msg}"
        )
    counts.bump(NAME)
    return out
