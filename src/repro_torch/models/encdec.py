"""Whisper-style encoder-decoder backbone.

The port of ``repro/models/encdec.py``: ``encode``, the cross-attention
(``cross_attend``, ``enc_kv``), ``dec_block``, ``init_lm``, ``forward``,
``loss_fn``, ``init_decode_cache``, ``prime_cross_cache`` and ``decode_fn``.
``encode`` and ``forward`` build a graph when grad mode is on, every encoder
and decoder block rematerialised (``layers.remat``) as JAX's
``jax.checkpoint`` does; serving calls them under ``torch.inference_mode()``,
and the decode path runs under ``no_grad``.  The conv/mel frontend is a stub
in both packages: a batch carries precomputed frame
embeddings (B, enc_seq, d), to which the encoder adds sinusoidal positions
before its bidirectional blocks (RoPE over ``arange(enc_seq)`` on top, as JAX
applies it).  The decoder is a causal stack with cross-attention into the
encoder's output; decode carries a self-attention K/V cache and every
layer's cross K/V, computed once by ``prime_cross_cache``.

The encoder's attention goes through ``attention_apply(causal=False)`` and
the decoder's self-attention through ``attention_apply(causal=True)``, so
with ``attn_impl="kernel"`` a forward is ``n_enc_layers`` non-causal and
``n_layers`` causal ``flash_attention`` launches on the card, and
``prime_cross_cache`` ``n_enc_layers`` non-causal ones.  Cross-attention is
plain torch einsum, as JAX computes it outside any Pallas kernel; decode
launches no kernel.  ``decode_fn`` reads the cache's cross K/V whether or not
``primed`` is set, as JAX's does.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L


def sinusoid(S: int, d: int, device=None) -> torch.Tensor:
    """(S, d) f32: sin then cos of pos / 10000^(2i/d), i < d/2."""
    pos = torch.arange(S, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / (10_000 ** (2 * dim / d))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _norm(d: int, device) -> nn.Parameter:
    return L.param((d,), torch.float32, fill=1.0, device=device)


class EncBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, generator=None, device=None):
        super().__init__()
        self.ln1 = _norm(cfg.d_model, device)
        self.attn = L.Attention(cfg, generator, device)
        self.ln2 = _norm(cfg.d_model, device)
        self.mlp = L.GeluMLP(cfg, generator, device)


class DecBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, generator=None, device=None):
        super().__init__()
        self.ln1 = _norm(cfg.d_model, device)
        self.attn = L.Attention(cfg, generator, device)
        self.lnx = _norm(cfg.d_model, device)
        self.xattn = L.Attention(cfg, generator, device)  # q from the decoder, k/v from the encoder
        self.ln2 = _norm(cfg.d_model, device)
        self.mlp = L.GeluMLP(cfg, generator, device)


class EncDecLM(nn.Module):
    """embed (vocab, d), enc_blocks[n_enc_layers], enc_ln (d,),
    dec_blocks[n_layers], ln_f (d,), unembed (d, vocab)."""

    def __init__(self, cfg: ModelConfig, generator=None, device=None):
        super().__init__()
        self.cfg = cfg
        dt = L.torch_dtype(cfg)
        d = cfg.d_model
        self.embed = L.param((cfg.vocab, d), dt, std=d**-0.5, generator=generator, device=device)
        self.enc_blocks = nn.ModuleList(EncBlock(cfg, generator, device)
                                        for _ in range(cfg.n_enc_layers))
        self.enc_ln = _norm(d, device)
        self.dec_blocks = nn.ModuleList(DecBlock(cfg, generator, device)
                                        for _ in range(cfg.n_layers))
        self.ln_f = _norm(d, device)
        self.unembed = L.param((d, cfg.vocab), dt, std=d**-0.5, generator=generator,
                               device=device)


def init_lm(cfg: ModelConfig, generator: torch.Generator | None = None, device=None):
    """The JAX init's distributions drawn from ``generator``; the numbers
    differ from ``jax.random``'s."""
    return EncDecLM(cfg, generator, device)


def encode(model: EncDecLM, frames: torch.Tensor, *, attn_impl: str = "kernel") -> torch.Tensor:
    """frames (B, enc_seq, d) -> the encoder's output (B, enc_seq, d)."""
    cfg = model.cfg
    x = frames.to(L.torch_dtype(cfg))
    x = x + sinusoid(x.shape[1], cfg.d_model, x.device).to(x.dtype)
    positions = torch.arange(x.shape[1], device=x.device)

    def enc_block(bp, x):
        h, _ = L.attention_apply(cfg, bp.attn, L.rmsnorm(x, bp.ln1, cfg.norm_eps), positions,
                                 causal=False, attn_impl=attn_impl)
        x = x + h
        return x + L.gelu_mlp_apply(bp.mlp, L.rmsnorm(x, bp.ln2, cfg.norm_eps))

    for bp in model.enc_blocks:
        x = L.remat(lambda x, bp=bp: enc_block(bp, x), x)
    return L.rmsnorm(x, model.enc_ln, cfg.norm_eps)


def cross_attend(cfg: ModelConfig, xp: L.Attention, y: torch.Tensor, enc_kv) -> torch.Tensor:
    """y (B, S, d) queries against the encoder's K/V (B, Se, KV, Dh): plain
    torch, as JAX's (no mask, f32 softmax, probabilities in q's dtype)."""
    B, S, _ = y.shape
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = (y @ xp.wq).reshape(B, S, H, Dh)
    k, v = enc_kv
    G = H // KV
    qh = q.transpose(1, 2).reshape(B, KV, G, S, Dh) * (Dh**-0.5)
    kh = k.transpose(1, 2)
    vh = v.transpose(1, 2)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qh, kh.to(qh.dtype))
    p = torch.softmax(s.float(), dim=-1).to(qh.dtype)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, vh.to(qh.dtype))
    o = o.reshape(B, H, S, Dh).transpose(1, 2).reshape(B, S, H * Dh)
    return o @ xp.wo


def enc_kv(cfg: ModelConfig, xp: L.Attention, enc_out: torch.Tensor):
    """A layer's cross K and V (B, Se, KV, Dh) from the encoder's output."""
    B, Se, _ = enc_out.shape
    KV, Dh = cfg.n_kv_heads, cfg.d_head
    return ((enc_out @ xp.wk).reshape(B, Se, KV, Dh),
            (enc_out @ xp.wv).reshape(B, Se, KV, Dh))


def dec_block(cfg: ModelConfig, bp: DecBlock, x, positions, enc_out, *, cache=None,
              attn_impl: str = "kernel"):
    """One decoder layer -> (x, the self-attention's (k, v, len) or None,
    the cross K/V used).  With a ``cache`` holding ``xk``/``xv`` those are the
    cross K/V; else they are computed from ``enc_out``."""
    h, new_kv = L.attention_apply(
        cfg, bp.attn, L.rmsnorm(x, bp.ln1, cfg.norm_eps), positions, causal=True,
        cache=None if cache is None else (cache["k"], cache["v"], cache["len"]),
        attn_impl=attn_impl,
    )
    x = x + h
    if cache is not None and "xk" in cache:
        xkv = (cache["xk"], cache["xv"])
    else:
        xkv = enc_kv(cfg, bp.xattn, enc_out)
    x = x + cross_attend(cfg, bp.xattn, L.rmsnorm(x, bp.lnx, cfg.norm_eps), xkv)
    x = x + L.gelu_mlp_apply(bp.mlp, L.rmsnorm(x, bp.ln2, cfg.norm_eps))
    return x, new_kv, xkv


def forward(model: EncDecLM, tokens: torch.Tensor, *, frames: torch.Tensor | None = None,
            attn_impl: str = "kernel") -> torch.Tensor:
    """The decoder teacher-forced over the encoded frames: tokens (B, S),
    frames (B, enc_seq, d) -> logits (B, S, vocab)."""
    if frames is None:
        raise ValueError("the encdec forward needs frames")
    cfg = model.cfg
    enc_out = encode(model, frames, attn_impl=attn_impl)
    x = L.embed(model.embed, tokens).to(L.torch_dtype(cfg))
    positions = torch.arange(x.shape[1], device=x.device)
    for bp in model.dec_blocks:
        x = L.remat(lambda x, bp=bp: dec_block(cfg, bp, x, positions, enc_out,
                                               attn_impl=attn_impl)[0], x)
    x = L.rmsnorm(x, model.ln_f, cfg.norm_eps)
    return x @ model.unembed


def loss_fn(model: EncDecLM, batch: dict, *, attn_impl: str = "kernel") -> torch.Tensor:
    """The mean f32 cross-entropy of ``batch["labels"]``, the decoder over
    ``batch["frames"]``."""
    logits = forward(model, batch["tokens"], frames=batch["frames"], attn_impl=attn_impl)
    return L.token_ce(logits, batch["labels"])


def init_decode_cache(cfg: ModelConfig, batch: int, max_len: int, device=None) -> dict:
    """Self-attention K/V (L, B, max_len, KV, Dh) and slots for the cross K/V
    (L, B, enc_seq, KV, Dh), zero and unprimed."""
    KV, Dh, Ld = cfg.n_kv_heads, cfg.d_head, cfg.n_layers
    dt = L.torch_dtype(cfg)
    z = lambda S: torch.zeros((Ld, batch, S, KV, Dh), dtype=dt, device=device)
    return {"k": z(max_len), "v": z(max_len), "xk": z(cfg.enc_seq), "xv": z(cfg.enc_seq),
            "primed": False, "len": 0}


@torch.no_grad()
def prime_cross_cache(model: EncDecLM, cache: dict, frames: torch.Tensor, *,
                      attn_impl: str = "kernel") -> dict:
    """Runs the encoder once over ``frames`` and stores every layer's cross
    K/V; -> a new dict, ``primed`` set."""
    enc_out = encode(model, frames, attn_impl=attn_impl)
    kv = [enc_kv(model.cfg, bp.xattn, enc_out) for bp in model.dec_blocks]
    return {**cache, "xk": torch.stack([k for k, _ in kv]),
            "xv": torch.stack([v for _, v in kv]), "primed": True}


@torch.no_grad()
def decode_fn(model: EncDecLM, cache: dict, tokens: torch.Tensor):
    """One decode step: tokens (B, 1) -> (logits (B, 1, vocab), cache).

    The self-attention K/V are written into the cache in place and its length
    advanced; the same dict is returned.  The cross K/V are read as they
    stand: a cache that was never primed attends over zeros, as in JAX."""
    cfg = model.cfg
    x = L.embed(model.embed, tokens).to(L.torch_dtype(cfg))
    pos = cache["len"]
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    for i, bp in enumerate(model.dec_blocks):
        lcache = {"k": cache["k"][i], "v": cache["v"][i], "xk": cache["xk"][i],
                  "xv": cache["xv"][i], "len": pos}
        x, _, _ = dec_block(cfg, bp, x, positions, None, cache=lcache)
    x = L.rmsnorm(x, model.ln_f, cfg.norm_eps)
    cache["len"] = pos + 1
    return x @ model.unembed, cache
