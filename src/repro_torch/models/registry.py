"""Model dispatch: one interface over the ported families.

The port of ``repro/models/registry.py``.  ``get_model(cfg)`` returns a
``Model`` facade with

  init(generator=None, device=None) -> params (an nn.Module)
  loss_fn(params, batch) -> the scalar training loss (a graph)
  forward(params, batch) -> logits (B, S, vocab), under inference_mode
  init_decode_cache(batch, max_len, device=None) -> cache
  decode_fn(params, cache, tokens) -> (logits, cache)

for every family the JAX package serves: ``dense``, ``moe``, ``vlm``,
``ssm``, ``hybrid`` (Griffin) and ``encdec`` (Whisper).  A ``vlm`` batch may
carry ``patch_embeds`` (B, n_patches, d), prepended to the tokens as the JAX
facade's ``fwd`` does; an ``encdec`` batch carries ``frames`` (B, enc_seq,
d).  ``loss_fn`` runs both LM kernels (their gradients are their plain
versions'), where JAX's trains through its plain paths.  An unknown family
raises ``ValueError``, as JAX's ``get_model`` does.  ``batch_spec(shape)``
describes one train or prefill batch as ``meta`` tensors (the shapes and
dtypes of JAX's ``ShapeDtypeStruct``s), the inputs of the dry run
(:mod:`repro_torch.launch.dryrun`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import encdec, griffin, rwkv6, transformer


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable
    loss_fn: Callable
    forward: Callable
    init_decode_cache: Callable
    decode_fn: Callable

    def batch_spec(self, shape: ShapeConfig, device="meta") -> dict:
        """One train/prefill batch of ``shape`` as empty tensors on
        ``device`` (meta: no storage), JAX's ``Model.batch_spec``: token
        dims at the GLOBAL batch; a vlm's ``patch_embeds`` and an encdec's
        ``frames`` in the config's dtype, ``tokens`` (and for ``train``
        ``labels``) int32."""
        B, S = shape.global_batch, shape.seq_len
        cfg = self.cfg
        dt = getattr(torch, cfg.dtype)
        spec: dict = {}
        if cfg.family == "encdec":
            spec["frames"] = torch.empty((B, cfg.enc_seq, cfg.d_model), dtype=dt, device=device)
        if cfg.family == "vlm":
            spec["patch_embeds"] = torch.empty((B, cfg.n_patches, cfg.d_model), dtype=dt,
                                               device=device)
        spec["tokens"] = torch.empty((B, S), dtype=torch.int32, device=device)
        if shape.kind == "train":
            spec["labels"] = torch.empty((B, S), dtype=torch.int32, device=device)
        return spec


def _serving(fn: Callable) -> Callable:
    """``fn`` under ``torch.inference_mode()``: a serving call builds no graph."""
    return torch.inference_mode()(fn)


def _transformer_model(cfg: ModelConfig) -> Model:
    return Model(
        cfg=cfg,
        init=lambda generator=None, device=None: transformer.init_lm(cfg, generator, device),
        loss_fn=transformer.loss_fn,
        forward=_serving(lambda params, batch: transformer.forward(
            params, batch["tokens"], extra_embeds=batch.get("patch_embeds"))),
        init_decode_cache=lambda b, m, device=None: transformer.init_decode_cache(
            cfg, b, m, device),
        decode_fn=transformer.decode_fn,
    )


def _rwkv_model(cfg: ModelConfig) -> Model:
    return Model(
        cfg=cfg,
        init=lambda generator=None, device=None: rwkv6.init_lm(cfg, generator, device),
        loss_fn=rwkv6.loss_fn,
        forward=_serving(lambda params, batch: rwkv6.forward(params, batch["tokens"])),
        init_decode_cache=lambda b, m, device=None: rwkv6.init_decode_cache(cfg, b, m, device),
        decode_fn=rwkv6.decode_fn,
    )


def _griffin_model(cfg: ModelConfig) -> Model:
    return Model(
        cfg=cfg,
        init=lambda generator=None, device=None: griffin.init_lm(cfg, generator, device),
        loss_fn=griffin.loss_fn,
        forward=_serving(lambda params, batch: griffin.forward(params, batch["tokens"])),
        init_decode_cache=lambda b, m, device=None: griffin.init_decode_cache(cfg, b, m, device),
        decode_fn=griffin.decode_fn,
    )


def _encdec_model(cfg: ModelConfig) -> Model:
    return Model(
        cfg=cfg,
        init=lambda generator=None, device=None: encdec.init_lm(cfg, generator, device),
        loss_fn=encdec.loss_fn,
        forward=_serving(lambda params, batch: encdec.forward(
            params, batch["tokens"], frames=batch["frames"])),
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
