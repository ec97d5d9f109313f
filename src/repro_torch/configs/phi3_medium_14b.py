"""phi3-medium-14b [dense] — RoPE SwiGLU GQA.  40L d=5120 40H kv=10
d_ff=17920 vocab=100352.  [arXiv:2404.14219]"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi3-medium-14b",
        family="dense",
        n_layers=40,
        d_model=5120,
        n_heads=40,
        n_kv_heads=10,
        d_ff=17_920,
        vocab=100_352,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="phi3-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=1,
        d_ff=192,
        vocab=512,
        dtype="float32",
    )
