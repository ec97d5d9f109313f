"""Decoder-only transformer LM (dense / MoE / VLM backbone), for serving.

The port of ``repro/models/transformer.py``: ``init_lm``, ``forward``,
``init_decode_cache`` and ``decode_fn``.  One ``Block`` per layer in an
``nn.ModuleList`` takes the place of the stacked ``(L, ...)`` leaves and
``lax.scan``; a block holds an ``MoE`` in place of its MLP when the config
has experts.  ``forward`` prepends a VLM's patch embeddings
(``extra_embeds``) and returns the summed MoE aux loss on request.  Serving
only: there is no backward, so ``loss_fn`` and remat wait with training
(ROADMAP queue 1, item 14f).

``forward`` runs the prefill attention through ``attention_op`` with
``attn_impl="kernel"`` by default, one ``flash_attention`` launch per layer
on the card, where the JAX package defaults to ``"blockwise"`` (no JAX entry
point ever selected its Pallas kernel).  Decode attends over the cache with
the plain ``_cached_attention``, as the JAX package does, and sees tokens
only: JAX's ``decode_fn`` takes no patch prefix.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.moe import MoE, moe_apply


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, generator=None, device=None):
        super().__init__()
        self.ln1 = L.param((cfg.d_model,), torch.float32, fill=1.0, device=device)
        self.attn = L.Attention(cfg, generator, device)
        self.ln2 = L.param((cfg.d_model,), torch.float32, fill=1.0, device=device)
        if cfg.is_moe:
            self.moe = MoE(cfg, generator, device)
        else:
            self.mlp = L.MLP(cfg, generator, device)


class TransformerLM(nn.Module):
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
    """The JAX init's distributions (normal weights scaled by d_in^-0.5,
    unit norms, zero biases) drawn from ``generator``; the numbers differ
    from ``jax.random``'s."""
    return TransformerLM(cfg, generator, device)


def block_apply(cfg, bp: Block, x, positions, attn_impl="kernel", cache=None):
    """One layer: -> (x, the layer's updated (k, v, len) cache or None, the
    layer's MoE aux loss, an f32 0 without experts)."""
    h, new_kv = L.attention_apply(
        cfg, bp.attn, L.rmsnorm(x, bp.ln1, cfg.norm_eps), positions,
        causal=True, window=cfg.window, cache=cache, attn_impl=attn_impl,
    )
    x = x + h
    y = L.rmsnorm(x, bp.ln2, cfg.norm_eps)
    if cfg.is_moe:
        m, aux = moe_apply(cfg, bp.moe, y)
    else:
        m, aux = L.mlp_apply(bp.mlp, y), torch.zeros((), device=x.device)
    return x + m, new_kv, aux


@torch.no_grad()
def forward(
    model: TransformerLM,
    tokens: torch.Tensor,  # (B, S) int
    *,
    attn_impl: str = "kernel",
    extra_embeds: torch.Tensor | None = None,  # VLM patch prefix (B, P, d)
    return_aux: bool = False,
):
    """-> logits (B, P + S, vocab), or (logits, aux) with ``return_aux``:
    the layers' MoE aux losses summed, as the JAX forward returns them (0
    without experts).  The patch prefix is cast to the model's dtype and
    takes positions 0..P-1, the tokens P..P+S-1."""
    cfg = model.cfg
    x = model.embed[tokens].to(L.torch_dtype(cfg))
    if extra_embeds is not None:
        x = torch.cat([extra_embeds.to(x.dtype), x], dim=1)
    positions = torch.arange(x.shape[1], device=x.device)
    aux = torch.zeros((), device=x.device)
    for bp in model.blocks:
        x, _, layer_aux = block_apply(cfg, bp, x, positions, attn_impl)
        aux = aux + layer_aux
    x = L.rmsnorm(x, model.ln_f, cfg.norm_eps)
    logits = x @ model.unembed
    return (logits, aux) if return_aux else logits


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
        x, _, _ = block_apply(cfg, bp, x, positions,
                              cache=(cache["k"][i], cache["v"][i], pos))
    x = L.rmsnorm(x, model.ln_f, cfg.norm_eps)
    cache["len"] = pos + 1
    return x @ model.unembed, cache
