"""Decoder-only transformer LM, the dense family, for serving.

The port of ``repro/models/transformer.py``: ``init_lm``, ``forward``,
``init_decode_cache`` and ``decode_fn``.  One ``Block`` per layer in an
``nn.ModuleList`` takes the place of the stacked ``(L, ...)`` leaves and
``lax.scan``.  Serving only: there is no backward, so ``loss_fn`` and remat
wait with training (ROADMAP queue 1, item 14f).

``forward`` runs the prefill attention through ``attention_op`` with
``attn_impl="kernel"`` by default, one ``flash_attention`` launch per layer
on the card, where the JAX package defaults to ``"blockwise"`` (no JAX entry
point ever selected its Pallas kernel).  Decode attends over the cache with
the plain ``_cached_attention``, as the JAX package does.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, generator=None, device=None):
        super().__init__()
        self.ln1 = L.param((cfg.d_model,), torch.float32, fill=1.0, device=device)
        self.attn = L.Attention(cfg, generator, device)
        self.ln2 = L.param((cfg.d_model,), torch.float32, fill=1.0, device=device)
        self.mlp = L.MLP(cfg, generator, device)


class TransformerLM(nn.Module):
    """embed (vocab, d), blocks[L], ln_f (d,), unembed (d, vocab)."""

    def __init__(self, cfg: ModelConfig, generator=None, device=None):
        super().__init__()
        if cfg.is_moe:
            raise NotImplementedError(
                f"{cfg.name}: MoE blocks are not ported yet (ROADMAP queue 1, item 14b)"
            )
        self.cfg = cfg
        dt = L.torch_dtype(cfg)
        d = cfg.d_model
        self.embed = L.param((cfg.vocab, d), dt, std=d**-0.5, generator=generator, device=device)
        self.blocks = nn.ModuleList(Block(cfg, generator, device) for _ in range(cfg.n_layers))
        self.ln_f = L.param((d,), torch.float32, fill=1.0, device=device)
        self.unembed = L.param((d, cfg.vocab), dt, std=d**-0.5, generator=generator,
                               device=device)


def init_lm(cfg: ModelConfig, generator: torch.Generator | None = None, device=None):
    """The JAX init's distributions (normal weights scaled by d_in^-0.5,
    unit norms, zero biases) drawn from ``generator``; the numbers differ
    from ``jax.random``'s."""
    return TransformerLM(cfg, generator, device)


def block_apply(cfg, bp: Block, x, positions, attn_impl="kernel", cache=None):
    """One layer: -> (x, the layer's updated (k, v, len) cache or None)."""
    h, new_kv = L.attention_apply(
        cfg, bp.attn, L.rmsnorm(x, bp.ln1, cfg.norm_eps), positions,
        cache=cache, attn_impl=attn_impl,
    )
    x = x + h
    x = x + L.mlp_apply(bp.mlp, L.rmsnorm(x, bp.ln2, cfg.norm_eps))
    return x, new_kv


@torch.no_grad()
def forward(
    model: TransformerLM,
    tokens: torch.Tensor,  # (B, S) int
    *,
    attn_impl: str = "kernel",
    extra_embeds: torch.Tensor | None = None,
) -> torch.Tensor:
    """-> logits (B, S, vocab).  (The JAX forward also returns the MoE aux
    loss, which is 0 for the dense family.)"""
    cfg = model.cfg
    if extra_embeds is not None:
        raise NotImplementedError(
            f"{cfg.name}: the VLM patch prefix is not ported yet (ROADMAP queue 1, item 14e)"
        )
    x = model.embed[tokens].to(L.torch_dtype(cfg))
    positions = torch.arange(x.shape[1], device=x.device)
    for bp in model.blocks:
        x, _ = block_apply(cfg, bp, x, positions, attn_impl)
    x = L.rmsnorm(x, model.ln_f, cfg.norm_eps)
    return x @ model.unembed


def init_decode_cache(cfg: ModelConfig, batch: int, max_len: int, device=None) -> dict:
    k, v = L.make_kv_cache(cfg, batch, max_len, cfg.n_layers, device)
    return {"k": k, "v": v, "len": 0}


@torch.no_grad()
def decode_fn(model: TransformerLM, cache: dict, tokens: torch.Tensor):
    """One decode step: tokens (B, 1) -> (logits (B, 1, vocab), cache).

    The cache's K and V are updated in place and its length advanced; the
    same dict is returned.  ``len`` is a host int (the JAX package carries
    it as a traced scalar)."""
    cfg = model.cfg
    x = model.embed[tokens].to(L.torch_dtype(cfg))
    pos = cache["len"]
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    for i, bp in enumerate(model.blocks):
        x, _ = block_apply(cfg, bp, x, positions,
                           cache=(cache["k"][i], cache["v"][i], pos))
    x = L.rmsnorm(x, model.ln_f, cfg.norm_eps)
    cache["len"] = pos + 1
    return x @ model.unembed, cache
