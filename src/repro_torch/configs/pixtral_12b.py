"""pixtral-12b [vlm] — pixtral-ViT frontend (STUB) + mistral-nemo backbone.

40L d=5120 32H kv=8 d_ff=14336 vocab=131072; input_specs feeds precomputed
patch embeddings (1024 patches) prepended to the token stream.
[hf:mistralai/Pixtral-12B-2409]
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="pixtral-12b",
        family="vlm",
        n_layers=40,
        d_model=5120,
        n_heads=32,
        n_kv_heads=8,
        d_head=128,
        d_ff=14_336,
        vocab=131_072,
        n_patches=1024,
        rope_theta=1_000_000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="pixtral-smoke",
        family="vlm",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=512,
        n_patches=8,
        dtype="float32",
    )
