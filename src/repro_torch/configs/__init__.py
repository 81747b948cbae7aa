"""Architecture registry of the port: ``get_config("<arch-id>")`` returns
the exact published configuration, ``get_smoke_config`` the reduced
same-family one. Only the architectures the port serves are listed."""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig, smoke_config

ARCH_MODULES = {
    "yi-9b": "yi_9b",
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
