"""Architecture registry: ``get_config(arch_id)`` for the ported architectures."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig

_MODULES = {
    "dlrm-mlperf": "dlrm_mlperf",
    "wide-deep": "wide_deep",
    "sasrec": "sasrec",
    "mind": "mind",
    "qwen2.5-3b": "qwen2_5_3b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "granite-20b": "granite_20b",
    "internlm2-20b": "internlm2_20b",
    "gin-tu": "gin_tu",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str, smoke: bool = False) -> ArchConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown or not yet ported arch {arch_id!r}; known: {list(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.smoke() if smoke else mod.ARCH
