"""RWKV6 "Finch" language model (attention-free, data-dependent decay).

The port of ``repro/models/rwkv6.py``: time-mix, channel-mix,
``block_apply`` with and without state, ``init_lm``, ``forward``,
``loss_fn``, ``init_decode_cache`` and ``decode_fn``.  ``forward`` builds a
graph when grad mode is on, each block rematerialised (``layers.remat``) as
JAX's ``jax.checkpoint`` does; serving calls it under
``torch.inference_mode()``.  The JAX rounding points are kept:
the token-shift mixes in x's dtype (``mu`` cast to it), r/k/v cast to f32
before the recurrence, the decay ``exp(-exp(w))`` in f32, the per-head group
norm in f32 with eps 64e-5, then cast back.  Heads are ``d_model // 64``, not
``cfg.n_heads``.

The multi-token time-mix (every ``forward``, and ``decode_fn`` given more
than one token) runs ``wkv6_op`` with ``wkv_impl="kernel"`` by default, one
``wkv6`` launch per layer on the card, where the JAX package defaults to
``"ref"`` (no JAX entry point ever selected its Pallas kernel).  A training
step launches it once more per layer in the recompute, and takes the
gradient of its plain version (``kernels/wkv6/ops.py``).  A single
token against a state takes ``wkv6_decode_step``, plain torch as in JAX.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.wkv6.ops import wkv6_decode_step, wkv6_op
from repro_torch.models import layers as L

HEAD_SIZE = 64


def _heads(cfg: ModelConfig) -> int:
    return cfg.d_model // HEAD_SIZE


class TimeMix(nn.Module):
    def __init__(self, cfg: ModelConfig, generator=None, device=None):
        super().__init__()
        d, r = cfg.d_model, cfg.decay_lora
        H, K = _heads(cfg), HEAD_SIZE
        dt = L.torch_dtype(cfg)
        f32 = torch.float32
        # token-shift interpolation weights (r, k, v, w, g)
        self.mu = L.param((5, d), f32, fill=0.5, device=device)
        self.wr = L.dense(d, d, dt, generator, device)
        self.wk = L.dense(d, d, dt, generator, device)
        self.wv = L.dense(d, d, dt, generator, device)
        self.wg = L.dense(d, d, dt, generator, device)
        self.wo = L.dense(d, d, dt, generator, device)
        # data-dependent decay LoRA: w_t = w0 + tanh(x A) B
        self.w0 = L.param((d,), f32, fill=-2.0, device=device)
        self.wa = L.dense(d, r, dt, generator, device)
        self.wb = L.dense(r, d, dt, generator, device)
        self.u = L.param((H, K), f32, std=0.1, generator=generator, device=device)
        self.ln_g = L.param((d,), f32, fill=1.0, device=device)


class ChannelMix(nn.Module):
    def __init__(self, cfg: ModelConfig, generator=None, device=None):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        dt = L.torch_dtype(cfg)
        self.mu = L.param((2, d), torch.float32, fill=0.5, device=device)
        self.wk = L.dense(d, f, dt, generator, device)
        self.wv = L.dense(f, d, dt, generator, device)
        self.wr = L.dense(d, d, dt, generator, device)


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, generator=None, device=None):
        super().__init__()
        self.ln1 = L.param((cfg.d_model,), torch.float32, fill=1.0, device=device)
        self.tmix = TimeMix(cfg, generator, device)
        self.ln2 = L.param((cfg.d_model,), torch.float32, fill=1.0, device=device)
        self.cmix = ChannelMix(cfg, generator, device)


class RWKV6LM(nn.Module):
    """embed (vocab, d), blocks[L], ln_f (d,), unembed (d, vocab)."""

    def __init__(self, cfg: ModelConfig, generator=None, device=None):
        super().__init__()
        self.cfg = cfg
        dt = L.torch_dtype(cfg)
        d = cfg.d_model
        self.embed = L.param((cfg.vocab, d), dt, std=d**-0.5, generator=generator, device=device)
        self.blocks = nn.ModuleList(Block(cfg, generator, device) for _ in range(cfg.n_layers))
        self.ln_f = L.param((d,), torch.float32, fill=1.0, device=device)
        self.unembed = L.param((d, cfg.vocab), dt, std=d**-0.5, generator=generator,
                               device=device)


def init_lm(cfg: ModelConfig, generator: torch.Generator | None = None, device=None):
    """The JAX init's distributions drawn from ``generator``; the numbers
    differ from ``jax.random``'s."""
    return RWKV6LM(cfg, generator, device)


def _token_shift(x, last):
    """xs[t] = x[t-1]; position 0 takes ``last`` (decode state) or zeros."""
    first = torch.zeros_like(x[:, :1]) if last is None else last
    return torch.cat([first, x[:, :-1]], dim=1)


def _mix(x, xs, mu):
    return x + (xs - x) * mu


def tmix_apply(cfg, p: TimeMix, x, *, wkv_state=None, shift_last=None, wkv_impl="kernel"):
    """x (B, T, d).  Returns (out, (new_wkv_state, new_shift_last))."""
    B, T, d = x.shape
    H, K = _heads(cfg), HEAD_SIZE
    xs = _token_shift(x, shift_last)
    mu = p.mu.to(x.dtype)
    xr, xk, xv, xw, xg = (_mix(x, xs, mu[i]) for i in range(5))
    r = (xr @ p.wr).reshape(B, T, H, K)
    k = (xk @ p.wk).reshape(B, T, H, K)
    v = (xv @ p.wv).reshape(B, T, H, K)
    g = F.silu(xg @ p.wg)
    w = p.w0 + torch.tanh(xw @ p.wa) @ p.wb  # (B, T, d) log-log decay, f32
    decay = torch.exp(-torch.exp(w.float())).reshape(B, T, H, K)

    if T == 1 and wkv_state is not None:
        o, new_state = wkv6_decode_step(
            r[:, 0].float(), k[:, 0].float(), v[:, 0].float(), decay[:, 0], p.u, wkv_state,
        )
        o = o[:, None]  # (B, 1, H, K)
    else:
        o, new_state = wkv6_op(
            r.float(), k.float(), v.float(), decay, p.u, wkv_state, impl=wkv_impl,
        )
    # per-head group norm, then gate
    o32 = o.reshape(B, T, H, K).float()
    o = (o32 - o32.mean(-1, keepdim=True)) * torch.rsqrt(
        o32.var(-1, keepdim=True, unbiased=False) + 64e-5
    )
    o = (o.reshape(B, T, d) * p.ln_g).to(x.dtype)
    out = (o * g) @ p.wo
    return out, (new_state, x[:, -1:])


def cmix_apply(cfg, p: ChannelMix, x, *, shift_last=None):
    xs = _token_shift(x, shift_last)
    mu = p.mu.to(x.dtype)
    xk, xr = _mix(x, xs, mu[0]), _mix(x, xs, mu[1])
    kk = torch.square(torch.relu(xk @ p.wk))
    out = torch.sigmoid(xr @ p.wr) * (kk @ p.wv)
    return out, x[:, -1:]


def block_apply(cfg, bp: Block, x, *, state=None, wkv_impl="kernel"):
    """state = None (prefill) or dict(wkv, shift_t, shift_c)."""
    st = state or {}
    h, (wkv, shift_t) = tmix_apply(
        cfg, bp.tmix, L.rmsnorm(x, bp.ln1, cfg.norm_eps),
        wkv_state=st.get("wkv"), shift_last=st.get("shift_t"), wkv_impl=wkv_impl,
    )
    x = x + h
    c, shift_c = cmix_apply(
        cfg, bp.cmix, L.rmsnorm(x, bp.ln2, cfg.norm_eps), shift_last=st.get("shift_c"),
    )
    x = x + c
    return x, {"wkv": wkv, "shift_t": shift_t, "shift_c": shift_c}


def forward(model: RWKV6LM, tokens: torch.Tensor, *, wkv_impl: str = "kernel") -> torch.Tensor:
    """-> logits (B, S, vocab)."""
    cfg = model.cfg
    x = L.embed(model.embed, tokens).to(L.torch_dtype(cfg))
    for bp in model.blocks:
        x = L.remat(lambda x, bp=bp: block_apply(cfg, bp, x, wkv_impl=wkv_impl)[0], x)
    x = L.rmsnorm(x, model.ln_f, cfg.norm_eps)
    return x @ model.unembed


def loss_fn(model: RWKV6LM, batch: dict, *, wkv_impl: str = "kernel") -> torch.Tensor:
    """The mean f32 cross-entropy of ``batch["labels"]``."""
    return L.token_ce(forward(model, batch["tokens"], wkv_impl=wkv_impl), batch["labels"])


def init_decode_cache(cfg: ModelConfig, batch: int, max_len: int, device=None) -> dict:
    """O(1)-in-sequence state: WKV (L, B, H, K, K) f32 and two token-shift
    slots (L, B, 1, d); ``max_len`` is unused, as in the JAX package."""
    H, K = _heads(cfg), HEAD_SIZE
    Lr, d = cfg.n_layers, cfg.d_model
    dt = L.torch_dtype(cfg)
    return {
        "wkv": torch.zeros((Lr, batch, H, K, K), dtype=torch.float32, device=device),
        "shift_t": torch.zeros((Lr, batch, 1, d), dtype=dt, device=device),
        "shift_c": torch.zeros((Lr, batch, 1, d), dtype=dt, device=device),
        "len": 0,
    }


@torch.no_grad()
def decode_fn(model: RWKV6LM, cache: dict, tokens: torch.Tensor):
    """tokens (B, T) against the state -> (logits (B, T, vocab), cache).

    One token takes the plain decode step; more than one runs the
    recurrence with the state as its initial state (the kernel on the
    card).  The cache's tensors are updated in place and the same dict is
    returned; its ``len`` counts the tokens consumed (the JAX package adds
    one a call; nothing reads it)."""
    cfg = model.cfg
    x = L.embed(model.embed, tokens).to(L.torch_dtype(cfg))
    for i, bp in enumerate(model.blocks):
        state = {"wkv": cache["wkv"][i], "shift_t": cache["shift_t"][i],
                 "shift_c": cache["shift_c"][i]}
        x, new = block_apply(cfg, bp, x, state=state)
        for name, t in new.items():
            cache[name][i].copy_(t)
    x = L.rmsnorm(x, model.ln_f, cfg.norm_eps)
    cache["len"] += tokens.shape[1]
    return x @ model.unembed, cache
