"""``flash_attention``: the wrapper of the hand-written CUDA kernels.

They replace the Pallas TPU kernel ``repro/kernels/flash_attention/kernel.py:91``
(``flash_attention``, body ``_flash_kernel`` at :29).  Two variants compute
the same function, each built with nvcc for ``sm_90a`` on first use
(:mod:`repro_torch.kernels.build`) and called through ``ctypes``:

* ``tensor_core`` (``csrc/flash_attention_wgmma.cu``): bf16 on Hopper's
  tensor cores, ``wgmma`` fed by a two-stage TMA ring of K/V tiles, one
  consumer warpgroup per 64-query tile, the online softmax in registers, P
  carried as three bf16 terms; 64-key tiles up to D 128, 32-key tiles at D
  up to 256 (four 64-column panels), where the 128-register O accumulator
  leaves no room for a 64-key S and P;
* ``cuda_core`` (``csrc/flash_attention.cu``): f32 products on the CUDA
  cores, f32 or bf16 inputs, any D <= 256.

``select_variant`` is the dispatch rule, a pure function of dtype, head size,
strides and base pointers: bf16 with D % 16 == 0, D <= 256 and TMA's 16-byte
alignment of strides and bases goes to the tensor cores (the transformer
prefill: qwen1.5 at D 64, starcoder2 at D 128; recurrentgemma's local
attention at D 256; whisper's encoder and decoder at D 64); every f32 call
and any other bf16 shape (D = 8, say) to the CUDA cores, whose f32 products
the f32 tolerances (1e-5) need.  It is a dispatch by shape, not a fallback: a failed
launch of either variant raises.  Each variant counts its own launches
(``flash_attention.tensor_core``, ``flash_attention.cuda_core``), and
``variant=`` names one explicitly so that tests and ``chip_smoke.py`` can time
both; the model never passes it.

Both read q (B, Sq, Hq, D) and k/v (B, Sk, Hkv, D) in place through their
strides (the last dimension contiguous), so the JAX wrapper's transposes and
pads are gone; a block serves one query head and reads its KV head
``hq // (Hq / Hkv)``.

What bounds it on an H100: at the transformer prefill's shape (B 4, S 1024,
16 heads of 64, causal, bf16) the call moves 34 MB (~0.01 ms at 3.35 TB/s)
and does 8.6 GFLOP of products (~0.009 ms on the bf16 tensor cores).

A CPU tensor takes the plain version (the blockwise online softmax of
``ops.py`` on f32 copies of q, k and v, cast back to q's dtype: the
arithmetic of the Pallas kernel) because it lies on the CPU; a CUDA tensor
launches a kernel or raises.  There is no fallback.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, counts

BLOCK_K = 64  # the plain version's key block: Pallas', CUDA-core's, tensor-core's to D 128
MAX_HEAD_DIM = 256
VARIANTS = ("tensor_core", "cuda_core")

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


# variant -> (library, C function); the tensor-core launch takes no dtype
_LIBS = {
    "cuda_core": ("flash_attention", "flash_attention_launch"),
    "tensor_core": ("flash_attention_wgmma", "flash_attention_wgmma_launch"),
}


def _launcher(variant: str):
    lib_name, fn_name = _LIBS[variant]
    lib = build.load(lib_name)
    fn = getattr(lib, fn_name)
    err = getattr(lib, f"{lib_name}_error_string")
    if fn.argtypes is None:  # first use in this process
        fn.argtypes = (
            [_P] * 4  # q, k, v, o
            + [_I] * 6  # B, Sq, Sk, Hq, Hkv, D
            + [_L] * 9  # (b, s, h) strides of q, k, v in elements
            + [_I, _I, ctypes.c_float]  # causal, window, scale
            + ([_I] if variant == "cuda_core" else [])  # dtype
            + [_P]  # stream
        )
        fn.restype = ctypes.c_int
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
    return fn, err


def select_variant(dtype: torch.dtype, head_dim: int, strides, data_ptrs) -> str:
    """The dispatch rule: ``"tensor_core"`` for bf16 with ``head_dim`` a
    multiple of 16 up to 256, every stride in ``strides`` (elements) a
    multiple of 8 and every address in ``data_ptrs`` a multiple of 16 (TMA
    reads 16-byte-aligned rows); ``"cuda_core"`` for everything else, every
    f32 call included."""
    ok = (
        dtype == torch.bfloat16
        and head_dim % 16 == 0
        and head_dim <= MAX_HEAD_DIM
        and all(s % 8 == 0 for s in strides)
        and all(p % 16 == 0 for p in data_ptrs)
    )
    return "tensor_core" if ok else "cuda_core"


def _tma_strides(t: torch.Tensor) -> list[int]:
    """t's (b, s, h) strides in elements, a dimension of size 1 given the
    stride ``t.shape[-1]``: it is never stepped over, and TMA takes any
    16-byte multiple there."""
    return [st if n > 1 else t.shape[-1] for n, st in zip(t.shape[:3], t.stride()[:3])]


def variant_for(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The variant ``select_variant`` gives these tensors."""
    return select_variant(
        q.dtype, q.shape[-1], [s for t in (q, k, v) for s in _tma_strides(t)],
        [t.data_ptr() for t in (q, k, v)],
    )


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
    variant: str = "auto",
) -> torch.Tensor:
    """Attention with queries at the end of the key timeline
    (``q_offset = Sk - Sq``), causal and sliding-window masks and GQA;
    -> (B, Sq, Hq, D) in q's dtype.  ``variant``: ``"auto"`` (the rule of
    ``select_variant``), ``"tensor_core"`` (raises where the rule would not
    take it) or ``"cuda_core"``."""
    name = "flash_attention"
    _check(q, k, v, window)
    if variant != "auto" and variant not in VARIANTS:
        raise ValueError(f"{name}: unknown variant {variant!r}; known: auto, {', '.join(VARIANTS)}")
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
    rule = variant_for(q, k, v)
    if variant == "auto":
        variant = rule
    elif variant == "tensor_core" and rule != "tensor_core":
        raise ValueError(
            f"{name}: the tensor-core kernel takes bfloat16 with D % 16 == 0, D <= "
            f"{MAX_HEAD_DIM} and 16-byte-aligned strides and bases; got {q.dtype}, D={D}"
        )
    out = torch.empty((B, Sq, Hq, D), dtype=q.dtype, device=q.device)
    if out.numel() == 0 or Sk == 0:
        return out.zero_()
    fn, err = _launcher(variant)
    if variant == "tensor_core":
        strides = [s for t in (q, k, v) for s in _tma_strides(t)]
        dtype_arg = []
    else:
        strides = [s for t in (q, k, v) for s in t.stride()[:3]]
        dtype_arg = [_DTYPES[q.dtype]]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                B, Sq, Sk, Hq, Hkv, D, *strides, int(causal),
                -1 if window is None else int(window), 1.0 / (D**0.5), *dtype_arg,
                stream)
    if rc != 0:
        raise RuntimeError(
            f"{name} ({variant}) launch failed (B={B}, Sq={Sq}, Sk={Sk}, Hq={Hq}, "
            f"Hkv={Hkv}, D={D}, {q.dtype}): error {rc}: {err(rc).decode()}"
        )
    counts.bump(f"{name}.{variant}")
    return out
