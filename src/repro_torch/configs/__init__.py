"""Architecture registry: one module per assigned architecture.

The same ten configurations as ``repro.configs``, as data:
``get_config(arch_id)`` returns the exact published configuration;
``get_config(arch_id, reduced=True)`` returns the smoke-test reduction
of the same family. ``repro_torch.models.LM`` builds every one of them.
"""
from __future__ import annotations

import importlib

from repro_torch.models.common import ModelConfig

__all__ = ["ARCHS", "get_config", "list_archs"]

ARCHS = [
    "gemma3-12b",
    "nemotron-4-15b",
    "gemma2-9b",
    "mistral-large-123b",
    "llama-3.2-vision-11b",
    "mamba2-780m",
    "deepseek-v3-671b",
    "deepseek-v2-236b",
    "recurrentgemma-2b",
    "whisper-base",
]

_MODULES = {a: a.replace("-", "_").replace(".", "_") for a in ARCHS}


def get_config(arch: str, reduced: bool = False) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; choose from {ARCHS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    cfg = mod.config()
    return cfg.reduced() if reduced else cfg


def list_archs() -> list[str]:
    return list(ARCHS)
