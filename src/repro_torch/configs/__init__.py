"""Architecture registry: one module per assigned architecture.

``get_config(name)`` returns the full published configuration;
``get_smoke_config(name)`` returns the reduced same-family configuration
used by the CPU smoke tests (few layers, narrow widths, tiny vocab).
"""

from __future__ import annotations

from importlib import import_module
from typing import Dict, List

from ..models.config import ModelConfig

ARCHS: List[str] = [
    "deepseek_moe_16b",
    "deepseek_v2_lite_16b",
    "chatglm3_6b",
    "stablelm_1_6b",
    "qwen3_32b",
    "qwen1_5_0_5b",
    "hymba_1_5b",
    "llava_next_34b",
    "mamba2_370m",
    "seamless_m4t_large_v2",
]

# assignment ids use dashes / dots
ALIASES = {
    "deepseek-moe-16b": "deepseek_moe_16b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "chatglm3-6b": "chatglm3_6b",
    "stablelm-1.6b": "stablelm_1_6b",
    "qwen3-32b": "qwen3_32b",
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "hymba-1.5b": "hymba_1_5b",
    "llava-next-34b": "llava_next_34b",
    "mamba2-370m": "mamba2_370m",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
}


def _module(name: str):
    key = ALIASES.get(name, name).replace("-", "_").replace(".", "_")
    if key not in ARCHS:
        raise KeyError(f"unknown architecture {name!r}; known: {sorted(ALIASES)}")
    return import_module(f".{key}", __package__)


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).SMOKE


def all_arch_names() -> List[str]:
    return list(ALIASES.keys())
