"""Architecture registry of the port (mirrors :mod:`repro.configs`).

``get_config(name)`` returns the published config and
``get_smoke_config(name)`` a reduced same-family config for CPU tests;
the port carries all eleven architectures of the reference's registry,
in its order, and an unknown name raises ``KeyError``.
"""

from __future__ import annotations

import importlib
from typing import Dict, List

from ..models.config import ModelConfig

__all__ = ["ARCH_NAMES", "get_config", "get_smoke_config", "all_configs"]

#: every architecture of the reference's registry → its module name
_ALIASES = {
    "whisper-medium": "whisper_medium",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "qwen1.5-110b": "qwen1_5_110b",
    "gemma3-27b": "gemma3_27b",
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "codeqwen1.5-7b": "codeqwen1_5_7b",
    "hymba-1.5b": "hymba_1_5b",
    "phi-3-vision-4.2b": "phi_3_vision_4_2b",
    "mamba2-130m": "mamba2_130m",
    "pipit-lm-100m": "pipit_lm_100m",
}
ARCH_NAMES: List[str] = list(_ALIASES)


def _module(name: str):
    key = _ALIASES.get(name, name)
    if key not in _ALIASES.values():
        raise KeyError(f"unknown architecture {name!r}; have {ARCH_NAMES}")
    return importlib.import_module(f".{key}", __package__)


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).SMOKE


def all_configs() -> Dict[str, ModelConfig]:
    return {n: get_config(n) for n in ARCH_NAMES}
