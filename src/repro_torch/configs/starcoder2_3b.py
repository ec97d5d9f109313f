"""starcoder2-3b [dense] — GQA, RoPE.  30L d=3072 24H kv=2 d_ff=12288
vocab=49152.  [arXiv:2402.19173]"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-3b",
        family="dense",
        n_layers=30,
        d_model=3072,
        n_heads=24,
        n_kv_heads=2,
        d_ff=12_288,
        vocab=49_152,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-smoke",
        family="dense",
        n_layers=2,
        d_model=48,
        n_heads=4,
        n_kv_heads=2,
        d_ff=96,
        vocab=512,
        dtype="float32",
    )
