"""``flash_attention``: the wrapper of the hand-written CUDA kernel.

It replaces the Pallas TPU kernel ``repro/kernels/flash_attention/kernel.py:91``
(``flash_attention``, body ``_flash_kernel`` at :29).  The source is
``csrc/flash_attention.cu``, built with nvcc for ``sm_90a`` on first use
(:mod:`repro_torch.kernels.build`) and called through ``ctypes``.  It reads
q (B, Sq, Hq, D) and k/v (B, Sk, Hkv, D) in place through their strides (the
last dimension contiguous), so the JAX wrapper's transposes and pads are
gone; one block per 32-query tile of one query head reads its KV head
``hq // (Hq / Hkv)``.

What bounds it on an H100: at the transformer prefill's shape (B 4, S 1024,
16 heads of 64, causal, bf16) the call moves 34 MB (~0.01 ms at 3.35 TB/s)
and does 8.6 GFLOP of products (~0.009 ms on the bf16 tensor cores), so a
kernel that reached the roofline would be bound by bytes and compute alike.
This first kernel does its products in f32 on the CUDA cores from shared
memory (67 TFLOP/s peak, 0.13 ms), so it is bound by operations; ``wgmma``
and TMA are a later PR's work.

A CPU tensor takes the plain version (the blockwise online softmax of
``ops.py`` on f32 copies of q, k and v, cast back to q's dtype: the
arithmetic of the Pallas kernel) because it lies on the CPU; a CUDA tensor
launches the kernel or raises.  There is no fallback.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, counts

BLOCK_Q = 32  # query rows per block (csrc/flash_attention.cu kBq)
BLOCK_K = 64  # keys per tile (kBk)
MAX_HEAD_DIM = 128

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _launcher():
    lib = build.load("flash_attention")
    fn = lib.flash_attention_launch
    if fn.argtypes is None:  # first use in this process
        fn.argtypes = (
            [_P] * 4  # q, k, v, o
            + [_I] * 6  # B, Sq, Sk, Hq, Hkv, D
            + [_L] * 9  # (b, s, h) strides of q, k, v in elements
            + [_I, _I, ctypes.c_float, _I, _P]  # causal, window, scale, dtype, stream
        )
        fn.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
    return fn, lib.flash_attention_error_string


def _check(q, k, v, window) -> None:
    name = "flash_attention"
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{name}: q, k, v must be (B, S, H, D)")
    B, Sq, Hq, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(
            f"{name}: k {tuple(k.shape)} and v {tuple(v.shape)} must be "
            f"({B}, Sk, Hkv, {D})"
        )
    if Hq % k.shape[2]:
        raise ValueError(f"{name}: {Hq} query heads are not a multiple of {k.shape[2]} kv heads")
    if not (q.device == k.device == v.device):
        raise ValueError(f"{name}: q, k, v on {q.device}, {k.device}, {v.device}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"{name}: q, k, v dtypes {q.dtype}, {k.dtype}, {v.dtype} differ")
    if window is not None and window < 1:
        raise ValueError(f"{name}: window must be >= 1, got {window}")


def flash_attention_plain(q, k, v, *, causal=True, window=None):
    """The kernel's plain version: the Pallas kernel's arithmetic (q, k, v
    in f32, q scaled in f32, f32 accumulators, output in q's dtype)."""
    from repro_torch.kernels.flash_attention.ops import blockwise_attention

    out = blockwise_attention(
        q.float(), k.float(), v.float(), causal=causal, window=window, block_k=BLOCK_K,
    )
    return out.to(q.dtype)


def flash_attention(
    q: torch.Tensor,  # (B, Sq, Hq, D)
    k: torch.Tensor,  # (B, Sk, Hkv, D)
    v: torch.Tensor,  # (B, Sk, Hkv, D)
    *,
    causal: bool = True,
    window: int | None = None,
) -> torch.Tensor:
    """Attention with queries at the end of the key timeline
    (``q_offset = Sk - Sq``), causal and sliding-window masks and GQA;
    -> (B, Sq, Hq, D) in q's dtype."""
    name = "flash_attention"
    _check(q, k, v, window)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"{name}: the kernel takes float32 or bfloat16, got {q.dtype}")
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    if D > MAX_HEAD_DIM:
        raise ValueError(f"{name}: head size {D} > {MAX_HEAD_DIM}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError(f"{name}: the head dimension of q, k, v must be contiguous")
    out = torch.empty((B, Sq, Hq, D), dtype=q.dtype, device=q.device)
    if out.numel() == 0 or Sk == 0:
        return out.zero_()
    fn, err = _launcher()
    strides = [s for t in (q, k, v) for s in t.stride()[:3]]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                B, Sq, Sk, Hq, Hkv, D, *strides, int(causal),
                -1 if window is None else int(window), 1.0 / (D**0.5), _DTYPES[q.dtype],
                stream)
    if rc != 0:
        raise RuntimeError(
            f"{name} launch failed (B={B}, Sq={Sq}, Sk={Sk}, Hq={Hq}, Hkv={Hkv}, "
            f"D={D}, {q.dtype}): CUDA error {rc}: {err(rc).decode()}"
        )
    counts.bump(name)
    return out
