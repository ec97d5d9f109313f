"""qwen3-moe-235b-a22b [moe] — 128 experts top-8, fine-grained (d_ff=1536).

94L d=4096 64H kv=4 d_ff=1536(expert) vocab=151936.  [hf:Qwen/Qwen3-30B-A3B
scaled family; assigned shape]
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-235b-a22b",
        family="moe",
        n_layers=94,
        d_model=4096,
        n_heads=64,
        n_kv_heads=4,
        d_head=128,
        d_ff=1536,
        vocab=151_936,
        n_experts=128,
        top_k=8,
        rope_theta=1_000_000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=48,
        vocab=512,
        n_experts=8,
        top_k=2,
        dtype="float32",
    )
