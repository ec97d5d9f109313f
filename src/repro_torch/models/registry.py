"""Model dispatch: one serving interface over the ported families.

The port of ``repro/models/registry.py``.  ``get_model(cfg)`` returns a
``Model`` facade with

  init(generator=None, device=None) -> params (an nn.Module)
  forward(params, batch) -> logits (B, S, vocab)
  init_decode_cache(batch, max_len, device=None) -> cache
  decode_fn(params, cache, tokens) -> (logits, cache)

for every family the JAX package serves: ``dense``, ``moe``, ``vlm``,
``ssm``, ``hybrid`` (Griffin) and ``encdec`` (Whisper).  A ``vlm`` batch may
carry ``patch_embeds`` (B, n_patches, d), prepended to the tokens as the JAX
facade's ``fwd`` does; an ``encdec`` batch carries ``frames`` (B, enc_seq,
d).  An unknown family raises ``ValueError``, as JAX's ``get_model`` does.
Serving only: ``loss_fn`` and ``batch_spec`` wait with training (ROADMAP
queue 1, item 14f).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, griffin, rwkv6, transformer


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable
    forward: Callable
    init_decode_cache: Callable
    decode_fn: Callable


def _transformer_model(cfg: ModelConfig) -> Model:
    return Model(
        cfg=cfg,
        init=lambda generator=None, device=None: transformer.init_lm(cfg, generator, device),
        forward=lambda params, batch: transformer.forward(
            params, batch["tokens"], extra_embeds=batch.get("patch_embeds")),
        init_decode_cache=lambda b, m, device=None: transformer.init_decode_cache(
            cfg, b, m, device),
        decode_fn=transformer.decode_fn,
    )


def _rwkv_model(cfg: ModelConfig) -> Model:
    return Model(
        cfg=cfg,
        init=lambda generator=None, device=None: rwkv6.init_lm(cfg, generator, device),
        forward=lambda params, batch: rwkv6.forward(params, batch["tokens"]),
        init_decode_cache=lambda b, m, device=None: rwkv6.init_decode_cache(cfg, b, m, device),
        decode_fn=rwkv6.decode_fn,
    )


def _griffin_model(cfg: ModelConfig) -> Model:
    return Model(
        cfg=cfg,
        init=lambda generator=None, device=None: griffin.init_lm(cfg, generator, device),
        forward=lambda params, batch: griffin.forward(params, batch["tokens"]),
        init_decode_cache=lambda b, m, device=None: griffin.init_decode_cache(cfg, b, m, device),
        decode_fn=griffin.decode_fn,
    )


def _encdec_model(cfg: ModelConfig) -> Model:
    return Model(
        cfg=cfg,
        init=lambda generator=None, device=None: encdec.init_lm(cfg, generator, device),
        forward=lambda params, batch: encdec.forward(
            params, batch["tokens"], frames=batch["frames"]),
        init_decode_cache=lambda b, m, device=None: encdec.init_decode_cache(cfg, b, m, device),
        decode_fn=encdec.decode_fn,
    )


def get_model(cfg: ModelConfig) -> Model:
    if cfg.family in ("dense", "moe", "vlm"):
        return _transformer_model(cfg)
    if cfg.family == "ssm":
        return _rwkv_model(cfg)
    if cfg.family == "hybrid":
        return _griffin_model(cfg)
    if cfg.family == "encdec":
        return _encdec_model(cfg)
    raise ValueError(f"unknown family {cfg.family!r}")
