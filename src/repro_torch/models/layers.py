"""Building-block layers of the LM scaffold (serving and training).

The port of ``repro/models/layers.py``.  Parameters live in ``nn.Module``s
in the JAX package's layout (a dense weight is ``(d_in, d_out)`` and is
applied as ``x @ W``), so a JAX parameter tree loads leaf for leaf
(:mod:`repro_torch.models.convert`).  The rounding points of the JAX layers
are kept one by one: rmsnorm and rope compute in f32 and cast back to x's
dtype; matmuls run in the parameters' dtype.

Parameters are trainable (``requires_grad``); serving runs under
``torch.inference_mode()``, so its forwards build no graph.  ``remat`` is the
per-block rematerialisation of training, the counterpart of ``jax.checkpoint``
under ``REMAT_POLICY``: ``"nothing"`` (JAX's default ``nothing_saveable``:
a block keeps only its inputs and reruns its forward in the backward pass)
or ``"dots"`` (``checkpoint_dots_with_no_batch_dims``, through
``torch.utils.checkpoint``'s selective-checkpoint contexts).  Left out:
``SCAN_UNROLL`` (the port has no scan: eager code runs every layer) and the
sharding calls, which serve only XLA lowering.  ``jax.nn.gelu`` defaults to the tanh
approximation, so the GELU MLP (Griffin, Whisper) uses
``F.gelu(approximate="tanh")``, not torch's default erf.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.ops import attention_op


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def param(shape, dtype, *, std=None, fill=None, generator=None, device=None) -> nn.Parameter:
    """A trainable parameter: normal(0, std) from ``generator``, or ``fill``."""
    if fill is not None:
        t = torch.full(shape, fill, dtype=torch.float32, device=device)
    else:
        t = torch.randn(shape, generator=generator, device=device) * std
    return nn.Parameter(t.to(dtype))


# The remat policy of every block (JAX's ``layers.REMAT_POLICY``, the dry
# run's ``--remat``): "nothing" keeps only the block's inputs and reruns its
# forward in the backward pass (``nothing_saveable``); "dots" saves the
# outputs of the unbatched matrix products and reruns the rest
# (``checkpoint_dots_with_no_batch_dims``).
REMAT_POLICY = ["nothing"]
REMAT_POLICIES = ("nothing", "dots")

# the products "dots" saves: a 2-D product (``x @ W`` folds its leading dims
# into one ``mm``).  A batched product (``bmm``: attention's einsums, the
# MoE experts) is recomputed, as JAX's policy saves no dot with batch dims.
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy

    if op in _SAVED_DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat_context():
    from torch.utils.checkpoint import create_selective_checkpoint_contexts

    return create_selective_checkpoint_contexts(_save_dots)


def remat(fn, *args):
    """``fn(*args)``, its activations recomputed in the backward pass
    (``torch.utils.checkpoint``, non-reentrant) under ``REMAT_POLICY``
    when a gradient is to be taken; a plain call otherwise."""
    if not torch.is_grad_enabled():
        return fn(*args)
    policy = REMAT_POLICY[0]
    if policy == "nothing":
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)
    if policy == "dots":
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                                 context_fn=_remat_context)
    raise ValueError(f"unknown remat policy {policy!r}; known: {', '.join(REMAT_POLICIES)}")


def dense(d_in, d_out, dtype, generator, device) -> nn.Parameter:
    """A (d_in, d_out) weight, normal with std d_in^-0.5."""
    return param((d_in, d_out), dtype, std=d_in**-0.5, generator=generator, device=device)


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]`` through ``F.embedding``, whose gradient adds each
    row's contributions in a fixed order (the gradient of an index
    expression is scattered with atomic adds, so it varies run to run)."""
    return F.embedding(tokens, table)


def token_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy in f32: logsumexp minus the gold logit, as the
    JAX loss computes it."""
    l32 = logits.float()
    lse = torch.logsumexp(l32, dim=-1)
    gold = torch.gather(l32, -1, labels[..., None].long())[..., 0]
    return (lse - gold).mean()


# -- norms ----------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, g: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * g).to(x.dtype)


# -- rotary embeddings ------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x (..., S, H, D) with positions (..., S) or (S,): half-split rotation,
    angles in f32, the result cast to x's dtype."""
    D = x.shape[-1]
    half = D // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    angles = positions[..., :, None].float() * freqs  # (..., S, half)
    cos = torch.cos(angles)[..., :, None, :]  # (..., S, 1, half)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -- attention --------------------------------------------------------------------


class Attention(nn.Module):
    """wq (d, H*Dh), wk/wv (d, KV*Dh), wo (H*Dh, d), optional QKV biases."""

    def __init__(self, cfg: ModelConfig, generator=None, device=None):
        super().__init__()
        d, H, KV, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        dt = torch_dtype(cfg)
        self.wq = dense(d, H * Dh, dt, generator, device)
        self.wk = dense(d, KV * Dh, dt, generator, device)
        self.wv = dense(d, KV * Dh, dt, generator, device)
        self.wo = dense(H * Dh, d, dt, generator, device)
        if cfg.qkv_bias:
            self.bq = param((H * Dh,), dt, fill=0.0, device=device)
            self.bk = param((KV * Dh,), dt, fill=0.0, device=device)
            self.bv = param((KV * Dh,), dt, fill=0.0, device=device)


def attention_apply(
    cfg: ModelConfig,
    p: Attention,
    x: torch.Tensor,  # (B, S, d)
    positions: torch.Tensor,  # (S,) or (B, S)
    *,
    causal: bool = True,
    window: int | None = None,
    cache: tuple | None = None,  # (k_cache, v_cache, cache_len) for decode
    attn_impl: str = "kernel",
):
    """Attention with JAX's keywords: causal or bidirectional (an encoder),
    over ``window`` keys when given.  Returns (out (B, S, d), new_cache | None).

    With a cache, the new keys and values are written into ``k_cache`` and
    ``v_cache`` in place (the JAX package returns updated copies), at
    ``cache_len`` clamped to ``[0, Smax - S]`` as ``dynamic_update_slice``
    clamps its start, and the queries attend over the whole cache with the
    valid-length mask of ``_cached_attention``.
    """
    B, S, d = x.shape
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = x @ p.wq
    k = x @ p.wk
    v = x @ p.wv
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = rope(q.reshape(B, S, H, Dh), positions, cfg.rope_theta)
    k = rope(k.reshape(B, S, KV, Dh), positions, cfg.rope_theta)
    v = v.reshape(B, S, KV, Dh)

    if cache is not None:
        k_cache, v_cache, cache_len = cache
        start = min(max(cache_len, 0), k_cache.shape[1] - S)
        k_cache[:, start : start + S] = k.to(k_cache.dtype)
        v_cache[:, start : start + S] = v.to(v_cache.dtype)
        out = _cached_attention(q, k_cache, v_cache, cache_len, window)
        new_cache = (k_cache, v_cache, cache_len + S)
    else:
        out = attention_op(q, k, v, causal=causal, window=window, impl=attn_impl)
        new_cache = None
    out = out.reshape(B, S, H * Dh) @ p.wo
    return out, new_cache


def _cached_attention(q, k_cache, v_cache, cache_len: int, window):
    """Decode attention over a fixed-size cache with a valid length: plain
    torch, as the JAX package's is plain jnp (einsum, f32 softmax, the
    probabilities cast to q's dtype before the PV product)."""
    B, S, H, Dh = q.shape
    KV = k_cache.shape[2]
    G = H // KV
    scale = Dh**-0.5
    qh = q.transpose(1, 2).reshape(B, KV, G, S, Dh) * scale
    kh = k_cache.transpose(1, 2)  # (B, KV, Smax, Dh)
    vh = v_cache.transpose(1, 2)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qh, kh.to(qh.dtype))
    kpos = torch.arange(k_cache.shape[1], device=q.device)
    valid = kpos[None, :] <= cache_len  # queries sit at cache_len
    if window is not None:
        valid = valid & (kpos[None, :] > cache_len - window)
    s = torch.where(valid[None, None, None], s, -1e30)
    prob = torch.softmax(s.float(), dim=-1).to(qh.dtype)
    out = torch.einsum("bhgqk,bhkd->bhgqd", prob, vh.to(qh.dtype))
    return out.reshape(B, H, S, Dh).transpose(1, 2)


def make_kv_cache(cfg: ModelConfig, batch: int, max_len: int, layers: int, device=None):
    """(L, B, Smax, KV, Dh) stacked K and V caches."""
    shape = (layers, batch, max_len, cfg.n_kv_heads, cfg.d_head)
    dt = torch_dtype(cfg)
    return (torch.zeros(shape, dtype=dt, device=device),
            torch.zeros(shape, dtype=dt, device=device))


# -- MLPs -------------------------------------------------------------------------


class MLP(nn.Module):
    """SwiGLU: w1 gate (d, f), w3 up (d, f), w2 down (f, d)."""

    def __init__(self, cfg: ModelConfig, generator=None, device=None):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        dt = torch_dtype(cfg)
        self.w1 = dense(d, f, dt, generator, device)
        self.w3 = dense(d, f, dt, generator, device)
        self.w2 = dense(f, d, dt, generator, device)


def mlp_apply(p: MLP, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU."""
    return (F.silu(x @ p.w1) * (x @ p.w3)) @ p.w2


class GeluMLP(nn.Module):
    """wi (d, f), wo (f, d)."""

    def __init__(self, cfg: ModelConfig, generator=None, device=None):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        dt = torch_dtype(cfg)
        self.wi = dense(d, f, dt, generator, device)
        self.wo = dense(f, d, dt, generator, device)


def gelu_mlp_apply(p: GeluMLP, x: torch.Tensor) -> torch.Tensor:
    """GELU with JAX's default tanh approximation."""
    return F.gelu(x @ p.wi, approximate="tanh") @ p.wo
