"""whisper-large-v3 [audio] — encoder-decoder, stubbed conv frontend.

32(+32 enc)L d_model=1280 20H (kv=20) d_ff=5120 vocab=51866; the frontend is
a stub: input_specs feeds 1500 precomputed frame embeddings.
[arXiv:2212.04356]
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-large-v3",
        family="encdec",
        n_layers=32,
        n_enc_layers=32,
        enc_seq=1500,
        d_model=1280,
        n_heads=20,
        n_kv_heads=20,
        d_ff=5120,
        vocab=51_866,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-smoke",
        family="encdec",
        n_layers=2,
        n_enc_layers=2,
        enc_seq=24,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab=512,
        dtype="float32",
    )
