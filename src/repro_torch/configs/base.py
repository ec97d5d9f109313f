"""Model / run configuration schema (one dataclass covers all 10 families).

Every assigned architecture gets a ``configs/<id>.py`` exporting ``config()``
(the exact published shape) and ``smoke_config()`` (same family, reduced
dims, CPU-runnable).  ``--arch <id>`` resolves through
``repro_torch.configs.registry``.

A copy of the JAX package's ``configs/base.py``: the port imports nothing of
``repro``, so it keeps its own copies of the configs, value for value.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0  # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"

    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25

    # hybrid (recurrentgemma / griffin): layer pattern unit, tiled over depth
    pattern: Sequence[str] = ()  # e.g. ("rec", "rec", "attn")
    window: Optional[int] = None  # sliding-window size for local attention
    d_rnn: int = 0  # RG-LRU width (griffin uses ~4/3 d_model)
    conv_width: int = 4

    # rwkv6
    decay_lora: int = 64  # rank of the data-dependent decay LoRA

    # encoder-decoder (whisper): encoder stream
    n_enc_layers: int = 0
    enc_seq: int = 0  # stubbed frontend frames (whisper: 1500)

    # vlm (pixtral): stubbed patch-embedding prefix
    n_patches: int = 0

    # which attention families this config can lower for long_500k
    subquadratic: bool = False

    def __post_init__(self):
        if self.d_head == 0:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def layer_kinds(self) -> tuple[str, ...]:
        """Per-layer block kind for the decoder stack."""
        if self.family == "hybrid" and self.pattern:
            reps = -(-self.n_layers // len(self.pattern))
            return tuple((list(self.pattern) * reps)[: self.n_layers])
        if self.family == "ssm":
            return ("rwkv",) * self.n_layers
        return ("attn",) * self.n_layers

    def params_count(self) -> int:
        """Approximate parameter count (embedding + blocks), for 6ND math."""
        d, L = self.d_model, self.n_layers
        emb = self.vocab * d
        kinds = self.layer_kinds()
        total = emb
        dh = self.d_head
        attn = d * (self.n_heads * dh) + 2 * d * (self.n_kv_heads * dh) + (
            self.n_heads * dh
        ) * d
        if self.is_moe:
            mlp = self.n_experts * 3 * d * self.d_ff
        else:
            mlp = 3 * d * self.d_ff
        for kind in kinds:
            if kind == "attn":
                total += attn + mlp
            elif kind == "rec":
                dr = self.d_rnn or d
                total += 2 * d * dr + dr * d + 2 * dr + mlp
            elif kind == "rwkv":
                total += 4 * d * d + d * self.d_ff + self.d_ff * d
        total += d * self.vocab  # unembed
        if self.family == "encdec":
            total += self.n_enc_layers * (attn + mlp)
        return total

    def active_params_count(self) -> int:
        """Active parameters per token (MoE: only routed experts count)."""
        if not self.is_moe:
            return self.params_count()
        d = self.d_model
        dense_like = dataclasses.replace(self, n_experts=0, top_k=0)
        # replace the full expert bank with top_k experts per layer
        full = self.params_count()
        bank = self.n_layers * self.n_experts * 3 * d * self.d_ff
        active = self.n_layers * self.top_k * 3 * d * self.d_ff
        del dense_like
        return full - bank + active


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str  # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}
