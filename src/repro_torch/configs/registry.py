"""--arch <id> resolution for the launcher, tests and benchmarks."""

from __future__ import annotations

import importlib

ARCH_IDS = [
    "recurrentgemma_9b",
    "whisper_large_v3",
    "qwen1_5_0_5b",
    "phi3_medium_14b",
    "minitron_4b",
    "starcoder2_3b",
    "pixtral_12b",
    "llama4_scout_17b_16e",
    "qwen3_moe_235b_a22b",
    "rwkv6_3b",
]

# canonical external names (the assignment spelling) -> module ids
ALIASES = {
    "recurrentgemma-9b": "recurrentgemma_9b",
    "whisper-large-v3": "whisper_large_v3",
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "phi3-medium-14b": "phi3_medium_14b",
    "minitron-4b": "minitron_4b",
    "starcoder2-3b": "starcoder2_3b",
    "pixtral-12b": "pixtral_12b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_16e",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "rwkv6-3b": "rwkv6_3b",
}


def resolve(arch: str):
    """Return the config module for an arch id or alias."""
    mod_id = ALIASES.get(arch, arch.replace("-", "_").replace(".", "_"))
    if mod_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ALIASES)}")
    return importlib.import_module(f"repro_torch.configs.{mod_id}")


def get_config(arch: str):
    return resolve(arch).config()


def get_smoke_config(arch: str):
    return resolve(arch).smoke_config()
