"""rwkv6-3b "Finch" [ssm] — attention-free, data-dependent decay.

32L d=2560 (40 heads of 64) d_ff=8960 vocab=65536.  [arXiv:2404.05892]
O(1) decode state => runs long_500k.
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-3b",
        family="ssm",
        n_layers=32,
        d_model=2560,
        n_heads=40,
        n_kv_heads=40,
        d_head=64,
        d_ff=8960,
        vocab=65_536,
        subquadratic=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-smoke",
        family="ssm",
        n_layers=2,
        d_model=128,
        n_heads=2,
        n_kv_heads=2,
        d_head=64,
        d_ff=256,
        vocab=512,
        decay_lora=16,
        subquadratic=True,
        dtype="float32",
    )
