"""Public attention entry point: the hand-written kernel or a plain path.

The port of ``repro/kernels/flash_attention/ops.py``.  Three tiers with the
same semantics:

* ``attention_ref``       -- (S, S) materialized; test sizes only.
* ``blockwise_attention`` -- online softmax as a loop over KV blocks in
  plain torch, with the JAX path's rounding points (scores in q's dtype,
  accumulators in f32).
* ``flash_attention``     -- the hand-written CUDA kernels on a CUDA tensor
  (bf16 on the tensor cores where ``select_variant`` allows, else on the
  CUDA cores), their plain version on a CPU tensor.

``attention_op`` defaults to the kernel, where the JAX package defaults to
``"blockwise"``: on the TPU no entry point ever selected ``"pallas"``, so
the Pallas kernel never ran outside its tests.  In the port the kernel is
the path; ``"ref"`` and ``"blockwise"`` stay as named plain versions for
the tests and the card smoke.

The kernel has no backward of its own.  ``FlashAttention``, the autograd
Function that ``attention_op(impl="kernel")`` goes through when grad mode
is on and an input requires grad, launches the kernel forward and saves
only q, k and v; its backward recomputes the kernel's plain version
(``flash_attention_plain``: the blockwise online softmax on f32 copies)
under autograd and returns that gradient.  It is the gradient JAX takes:
the JAX package has no ``custom_vjp`` for its Pallas kernel and trains
through ``"blockwise"``.  Under ``no_grad`` or ``inference_mode`` the kernel
is called directly and nothing is saved.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention.kernel import flash_attention, flash_attention_plain
from repro_torch.kernels.flash_attention.ref import attention_ref

NEG_INF = -1e30


def blockwise_attention(
    q: torch.Tensor,  # (B, Sq, Hq, D)
    k: torch.Tensor,  # (B, Sk, Hkv, D)
    v: torch.Tensor,  # (B, Sk, Hkv, D)
    *,
    causal: bool = True,
    window: int | None = None,
    block_k: int = 512,
) -> torch.Tensor:
    """Online-softmax attention as a loop over KV blocks (plain torch)."""
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    G = Hq // Hkv
    scale = 1.0 / (D**0.5)
    Bk = min(block_k, Sk)
    nblk = -(-Sk // Bk)
    pad = nblk * Bk - Sk

    # (B, Hkv, G, Sq, D) query layout so GQA needs no KV repeat
    qh = q.transpose(1, 2).reshape(B, Hkv, G, Sq, D) * scale
    kh = k.transpose(1, 2)  # (B, Hkv, Sk, D)
    vh = v.transpose(1, 2)
    if pad:  # zero rows, masked by kpos < Sk, as the JAX path pads
        kh = F.pad(kh, (0, 0, 0, pad))
        vh = F.pad(vh, (0, 0, 0, pad))

    qpos = torch.arange(Sq, device=q.device) + (Sk - Sq)
    acc = torch.zeros((B, Hkv, G, Sq, D), dtype=torch.float32, device=q.device)
    m = torch.full((B, Hkv, G, Sq, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, Hkv, G, Sq, 1), dtype=torch.float32, device=q.device)
    for j in range(nblk):
        kj = kh[:, :, j * Bk : (j + 1) * Bk]
        vj = vh[:, :, j * Bk : (j + 1) * Bk]
        s = torch.einsum("bhgqd,bhkd->bhgqk", qh, kj)  # (B, Hkv, G, Sq, Bk)
        kpos = j * Bk + torch.arange(Bk, device=q.device)
        mask = (kpos[None, :] < Sk).expand(Sq, Bk)
        if causal:
            mask = mask & (kpos[None, :] <= qpos[:, None])
        if window is not None:
            mask = mask & (kpos[None, :] > qpos[:, None] - window)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhgqk,bhkd->bhgqd", p, vj.to(p.dtype))
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)
    out = out.reshape(B, Hq, Sq, D).transpose(1, 2)
    return out.to(q.dtype)


class FlashAttention(torch.autograd.Function):
    """``flash_attention`` forward; the gradient of its plain version."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.save_for_backward(q, k, v)
        ctx.mask = (causal, window)
        return flash_attention(q, k, v, causal=causal, window=window)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        causal, window = ctx.mask
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_(True) for t in (q, k, v)]
            out = flash_attention_plain(*qkv, causal=causal, window=window)
            grads = torch.autograd.grad(out, qkv, g)
        return (*grads, None, None)


def attention_op(q, k, v, *, causal=True, window=None, impl: str = "kernel"):
    """Dispatch: impl in {'kernel', 'blockwise', 'ref'}.  The kernel goes
    through ``FlashAttention`` when a gradient is to be taken."""
    if impl == "kernel":
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
            return FlashAttention.apply(q, k, v, causal, window)
        return flash_attention(q, k, v, causal=causal, window=window)
    if impl == "blockwise":
        return blockwise_attention(q, k, v, causal=causal, window=window)
    if impl == "ref":
        return attention_ref(q, k, v, causal=causal, window=window)
    raise ValueError(f"unknown attention impl {impl!r}; known: kernel, blockwise, ref")
