"""Model dispatch: one serving interface over the ported families.

The port of ``repro/models/registry.py``.  ``get_model(cfg)`` returns a
``Model`` facade with

  init(generator=None, device=None) -> params (an nn.Module)
  forward(params, batch) -> logits (B, S, vocab)
  init_decode_cache(batch, max_len, device=None) -> cache
  decode_fn(params, cache, tokens) -> (logits, cache)

for the ``dense``, ``moe``, ``vlm`` and ``ssm`` families; a ``vlm`` batch
may carry ``patch_embeds`` (B, n_patches, d), prepended to the tokens as the
JAX facade's ``fwd`` does.  The other families are refused with their
ROADMAP item.  Serving only: ``loss_fn`` and ``batch_spec`` wait with
training (ROADMAP queue 1, item 14f).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.configs.base import ModelConfig
from repro_torch.models import rwkv6, transformer

# family -> the ROADMAP item that ports it
NOT_PORTED = {
    "hybrid": "ROADMAP queue 1, item 14c",
    "encdec": "ROADMAP queue 1, item 14d",
}


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


def get_model(cfg: ModelConfig) -> Model:
    if cfg.family in NOT_PORTED:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet "
            f"({NOT_PORTED[cfg.family]})"
        )
    if cfg.family in ("dense", "moe", "vlm"):
        return _transformer_model(cfg)
    if cfg.family == "ssm":
        return _rwkv_model(cfg)
    raise ValueError(f"unknown family {cfg.family!r}")
