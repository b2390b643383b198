"""Architecture registry: ``--arch <id>`` -> ModelConfig.

The paper's own networks (BinarEye chip programs) live in
``repro.core.chip.networks.REGISTRY`` — they are ISA programs, not LM
configs, and are exercised by the chip benchmarks/examples.
"""

from __future__ import annotations

import importlib

_MODULES = {
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "qwen2-vl-2b": "qwen2_vl_2b",
    "qwen1.5-110b": "qwen1_5_110b",
    "gemma2-2b": "gemma2_2b",
    "qwen3-8b": "qwen3_8b",
    "smollm-360m": "smollm_360m",
    "musicgen-medium": "musicgen_medium",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "rwkv6-3b": "rwkv6_3b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str, **overrides):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    cfg = mod.CONFIG
    return cfg.with_(**overrides) if overrides else cfg
