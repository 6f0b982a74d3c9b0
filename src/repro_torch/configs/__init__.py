"""Assigned architecture registry: ``get_config("<arch-id>")``.

Every entry reproduces the published configuration named in the assignment
table; see each module's docstring for the source and any interpretation
notes.  The fields equal those of `repro.configs`, entry for entry.
"""

from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig

_ARCH_MODULES = {
    "nemotron-4-15b": "nemotron_4_15b",
    "qwen1.5-110b": "qwen1_5_110b",
    "granite-3-2b": "granite_3_2b",
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "xlstm-1.3b": "xlstm_1_3b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "qwen2-vl-2b": "qwen2_vl_2b",
    "dbrx-132b": "dbrx_132b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "zamba2-7b": "zamba2_7b",
}

ARCH_IDS: List[str] = list(_ARCH_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch_id]}")
    return mod.CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
