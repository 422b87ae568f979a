"""Architecture registry of the port: the 5 MoEs the paper itself evaluates
(Table 1). Select with ``get_config("<id>")``; ``.reduced()`` gives the
CPU-sized variant of the same topology."""

from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.models.config import ModelConfig, InputShape, INPUT_SHAPES

_PAPER = [
    "mixtral_8x7b",
    "phi_3_5_moe",
    "olmoe_1b_7b",
    "deepseek_moe_16b",
    "qwen15_moe_a2_7b",
]

PAPER_ARCHS = [m.replace("_", "-") for m in _PAPER]
ALL_ARCHS = list(PAPER_ARCHS)

_REGISTRY: Dict[str, ModelConfig] = {}


def get_config(arch: str) -> ModelConfig:
    """Look up an architecture id like 'olmoe-1b-7b'."""
    key = arch.replace("-", "_").replace(".", "_")
    if key not in _PAPER:
        raise KeyError(f"unknown architecture {arch!r}; the port has "
                       f"{PAPER_ARCHS}")
    if key not in _REGISTRY:
        mod = importlib.import_module(f"repro_torch.configs.{key}")
        _REGISTRY[key] = mod.CONFIG
    return _REGISTRY[key]


def list_configs():
    return {a: get_config(a) for a in ALL_ARCHS}
