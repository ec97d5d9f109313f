"""llama4-scout-17b-a16e [moe] — MoE 16 experts top-1, early fusion.

48L d=5120 40H kv=8 d_ff=8192(expert) vocab=202048.
[hf:meta-llama/Llama-4-Scout-17B-16E]
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-17b-a16e",
        family="moe",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        d_head=128,
        d_ff=8192,
        vocab=202_048,
        n_experts=16,
        top_k=1,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama4-smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=96,
        vocab=512,
        n_experts=4,
        top_k=1,
        dtype="float32",
    )
