"""``wkv6``: the wrapper of the hand-written CUDA kernel.

It replaces the Pallas TPU kernel ``repro/kernels/wkv6/kernel.py:92``
(``wkv6``, body ``_wkv6_kernel`` at :31).  The source is ``csrc/wkv6.cu``,
built with nvcc for ``sm_90a`` on first use (:mod:`repro_torch.kernels.build`)
and called through ``ctypes``.  The kernel runs the recurrence of ``ref.py``
in time order, split over blocks of 16 value columns (the columns of one
(batch, head) are independent given r, k and decay) and, inside a block,
over 16 slices of 4 keys: a thread keeps a 4 x 4 register tile of the f32
state, reads r, k and decay as float4 broadcasts from a double-buffered
shared-memory stage, and o's partial sums over the slices meet in shared
memory once a chunk.  The TPU's chunked reformulation, which exists to feed
the MXU and overflows f32 in its factored form at decays near 1e-30, is not
carried over.

What bounds it on an H100: at RWKV6-3B's prefill (B 4, T 1024, 40 heads,
K = V = 64, f32) the call moves 213 MB (0.064 ms at 3.35 TB/s) and does
671 M state updates at 3 instructions each (~0.07 ms of f32 issue): bytes
and issue alike; the time order leaves each thread a chain of T dependent
fused multiply-adds.

Decays are clipped to [1e-30, 1] as the TPU kernel does
(``log(clip(decay, 1e-30, 1))``, kernel.py:113); multiplying by the clipped
decay is the same function.  A CPU tensor takes the plain version
(``wkv6_ref`` on the clipped decays) because it lies on the CPU; a CUDA
tensor launches the kernel or raises.  There is no fallback.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, counts
from repro_torch.kernels.wkv6.ref import wkv6_ref

MAX_K = MAX_V = 64  # the model's HEAD_SIZE (csrc/wkv6.cu kMaxK, kMaxV)

_P, _I = ctypes.c_void_p, ctypes.c_int


def _launcher():
    lib = build.load("wkv6")
    fn = lib.wkv6_launch
    if fn.argtypes is None:  # first use in this process
        # r, k, v, decay, u, s0, o, sT, B, T, H, K, V, stream
        fn.argtypes = [_P] * 8 + [_I] * 5 + [_P]
        fn.restype = ctypes.c_int
        lib.wkv6_error_string.argtypes = [ctypes.c_int]
        lib.wkv6_error_string.restype = ctypes.c_char_p
    return fn, lib.wkv6_error_string


def _check(r, k, v, decay, u, initial_state) -> None:
    name = "wkv6"
    if r.dim() != 4:
        raise ValueError(f"{name}: r must be (B, T, H, K), got {tuple(r.shape)}")
    B, T, H, K = r.shape
    if k.shape != r.shape or decay.shape != r.shape:
        raise ValueError(f"{name}: k {tuple(k.shape)} and decay {tuple(decay.shape)} "
                         f"must match r {tuple(r.shape)}")
    if v.dim() != 4 or v.shape[:3] != (B, T, H):
        raise ValueError(f"{name}: v must be ({B}, {T}, {H}, V), got {tuple(v.shape)}")
    if u.shape != (H, K):
        raise ValueError(f"{name}: u must be ({H}, {K}), got {tuple(u.shape)}")
    if initial_state is not None and initial_state.shape != (B, H, K, v.shape[3]):
        raise ValueError(f"{name}: initial_state must be ({B}, {H}, {K}, {v.shape[3]}), "
                         f"got {tuple(initial_state.shape)}")
    tensors = [t for t in (r, k, v, decay, u, initial_state) if t is not None]
    if any(t.device != r.device for t in tensors):
        raise ValueError(f"{name}: inputs on {[str(t.device) for t in tensors]}")


def wkv6(
    r: torch.Tensor,  # (B, T, H, K)
    k: torch.Tensor,
    v: torch.Tensor,  # (B, T, H, V)
    decay: torch.Tensor,  # (B, T, H, K) in (0, 1]
    u: torch.Tensor,  # (H, K)
    initial_state: torch.Tensor | None = None,  # (B, H, K, V)
):
    """The WKV6 recurrence -> (out (B, T, H, V), final_state (B, H, K, V)
    f32)."""
    name = "wkv6"
    _check(r, k, v, decay, u, initial_state)
    if r.device.type == "cpu":
        return wkv6_ref(r, k, v, decay.clamp(1e-30, 1.0), u, initial_state)
    if r.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {r.device}")
    tensors = [t for t in (r, k, v, decay, u, initial_state) if t is not None]
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"{name}: the kernel takes float32 inputs (the model's path), "
                        f"got {[t.dtype for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")
    B, T, H, K = r.shape
    V = v.shape[3]
    if K > MAX_K or V > MAX_V:
        raise ValueError(f"{name}: K={K}, V={V}; the kernel takes K, V <= {MAX_K}")
    out = torch.empty((B, T, H, V), dtype=torch.float32, device=r.device)
    state = torch.empty((B, H, K, V), dtype=torch.float32, device=r.device)
    if B * H * K * V == 0:
        return out, state.zero_()
    fn, err = _launcher()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        rc = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), decay.data_ptr(), u.data_ptr(),
                None if initial_state is None else initial_state.data_ptr(),
                out.data_ptr(), state.data_ptr(), B, T, H, K, V, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed (B={B}, T={T}, H={H}, K={K}, V={V}): "
                           f"CUDA error {rc}: {err(rc).decode()}")
    counts.bump(name)
    return out, state
