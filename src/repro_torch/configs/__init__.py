"""Architecture registry of the port: ``get_config("<arch-id>")`` returns
the exact published configuration, ``get_smoke_config`` the reduced
same-family one. Every architecture of the JAX package is listed."""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig, smoke_config

ARCH_MODULES = {
    "yi-9b": "yi_9b",
    "gemma3-4b": "gemma3_4b",
    "minitron-8b": "minitron_8b",
    "qwen1.5-110b": "qwen15_110b",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b",
    "grok-1-314b": "grok1_314b",
    "musicgen-large": "musicgen_large",
    "xlstm-125m": "xlstm_125m",
    "jamba-v0.1-52b": "jamba_52b",
}

ARCH_IDS = tuple(ARCH_MODULES)

__all__ = ["ARCH_IDS", "ModelConfig", "get_config", "get_smoke_config",
           "smoke_config"]


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCH_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCH_MODULES[arch_id]}")
    return mod.CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    return smoke_config(get_config(arch_id))
