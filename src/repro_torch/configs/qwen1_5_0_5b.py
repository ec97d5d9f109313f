"""qwen1.5-0.5b [dense] — QKV bias.  24L d=1024 16H kv=16 d_ff=2816
vocab=151936.  [hf:Qwen/Qwen1.5-0.5B]"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-0.5b",
        family="dense",
        n_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        d_ff=2816,
        vocab=151_936,
        qkv_bias=True,
        rope_theta=1_000_000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab=512,
        qkv_bias=True,
        dtype="float32",
    )
