"""Deterministic synthetic token pipeline (shard-aware, checkpointable).

The port of ``repro/data/pipeline.py``.  Tokens for (step, shard) are a
pure function of (seed, step, shard), drawn with numpy exactly as the JAX
package draws them, so a batch equals JAX's bit for bit and a restarted or
re-sharded job regenerates the same global batch.  The state is one integer
(``step``).

The stream mimics Zipf-ish natural-text marginals (vocab ranks from a power
law) with a learnable bigram pattern: ``token[t+1] = token[t] + delta`` for a
per-sequence delta with probability ``pattern_p``.  ``next_batch`` hands the
tokens to torch as int32 tensors on ``device`` (None: the card).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig


@dataclasses.dataclass
class SyntheticTokens:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    pattern_p: float = 0.75
    step: int = 0  # checkpointable cursor

    def state(self) -> dict:
        return {"step": self.step}

    def restore(self, state: dict) -> None:
        self.step = int(state["step"])

    def _batch_np(self, step: int, shard: int = 0, num_shards: int = 1):
        """This shard's slice of the global batch for ``step``."""
        assert self.global_batch % num_shards == 0
        b = self.global_batch // num_shards
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, step, shard]))
        # power-law marginals over an effective vocab
        veff = min(self.vocab, 32_768)
        base = rng.zipf(1.3, size=(b, self.seq_len)).astype(np.int64)
        tokens = np.clip(base, 1, veff - 1).astype(np.int32)
        # inject a learnable bigram pattern
        delta = rng.integers(1, 17, size=(b, 1)).astype(np.int32)
        use = rng.random((b, self.seq_len)) < self.pattern_p
        for t in range(1, self.seq_len):
            nxt = (tokens[:, t - 1] + delta[:, 0]) % veff
            tokens[:, t] = np.where(use[:, t], nxt, tokens[:, t])
        return tokens

    def next_batch(self, shard: int = 0, num_shards: int = 1, device=None) -> dict:
        """{"tokens", "labels"}: (b, seq_len - 1) int32 tensors on ``device``."""
        from repro_torch.api.session import resolve_device

        dev = resolve_device(device)
        tokens = self._batch_np(self.step, shard, num_shards)
        self.step += 1
        return {
            "tokens": torch.from_numpy(np.ascontiguousarray(tokens[:, :-1])).to(dev),
            "labels": torch.from_numpy(np.ascontiguousarray(tokens[:, 1:])).to(dev),
        }


def make_batch_for(cfg: ModelConfig, shape: ShapeConfig, seed: int = 0, device=None) -> dict:
    """One concrete batch for cfg x shape (smoke tests and examples): the
    pipeline's first batch, plus seeded frames (encdec) or patch embeddings
    (vlm) in the model's dtype, drawn as the JAX package draws them."""
    from repro_torch.api.session import resolve_device

    dev = resolve_device(device)
    pipe = SyntheticTokens(vocab=cfg.vocab, seq_len=shape.seq_len + 1,
                           global_batch=shape.global_batch, seed=seed)
    batch = pipe.next_batch(device=dev)
    dt = getattr(torch, cfg.dtype)
    if cfg.family == "encdec":
        rng = np.random.default_rng(seed + 1)
        a = rng.standard_normal((shape.global_batch, cfg.enc_seq, cfg.d_model), np.float32)
        batch["frames"] = torch.from_numpy(a).to(dev, dt)
    if cfg.family == "vlm":
        rng = np.random.default_rng(seed + 2)
        a = rng.standard_normal((shape.global_batch, cfg.n_patches, cfg.d_model), np.float32)
        batch["patch_embeds"] = torch.from_numpy(a).to(dev, dt)
    return batch
