"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 1 attn : 2 rec.

38L d_model=4096 16H (GQA kv=1 -> MQA local attention) d_ff=12288
vocab=256000, window=2048, lru width = d_model.  [arXiv:2402.19427]
Sub-quadratic (RG-LRU state + windowed KV) => runs long_500k.
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b",
        family="hybrid",
        n_layers=38,
        d_model=4096,
        n_heads=16,
        n_kv_heads=1,
        d_ff=12288,
        vocab=256_000,
        pattern=("rec", "rec", "attn"),
        window=2048,
        d_rnn=4096,
        subquadratic=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-smoke",
        family="hybrid",
        n_layers=5,
        d_model=64,
        n_heads=4,
        n_kv_heads=1,
        d_ff=128,
        vocab=512,
        pattern=("rec", "rec", "attn"),
        window=16,
        d_rnn=64,
        subquadratic=True,
        dtype="float32",
    )
