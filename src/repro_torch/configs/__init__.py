"""Architecture registry of the port: the 5 MoEs the paper itself evaluates
(Table 1), and the JAX package's other ten architectures (RWKV-6,
RecurrentGemma, StableLM-2 1.6B and 3B, Minitron-4B, Kimi-K2,
DeepSeek-V2, ChatGLM3-6B, Qwen2-VL-7B, Whisper-large-v3).
Select with ``get_config("<id>")``; ``.reduced()`` gives the CPU-sized
variant of the same topology."""

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

_OTHER = [
    "rwkv6_3b",
    "recurrentgemma_9b",
    "stablelm_1_6b",
    "stablelm_3b",
    "minitron_4b",
    "kimi_k2_1t_a32b",
    "deepseek_v2_236b",
    "chatglm3_6b",
    "qwen2_vl_7b",
    "whisper_large_v3",
]

PAPER_ARCHS = [m.replace("_", "-") for m in _PAPER]
ALL_ARCHS = PAPER_ARCHS + [m.replace("_", "-") for m in _OTHER]

_REGISTRY: Dict[str, ModelConfig] = {}


def get_config(arch: str) -> ModelConfig:
    """Look up an architecture id like 'olmoe-1b-7b'."""
    key = arch.replace("-", "_").replace(".", "_")
    if key not in _PAPER + _OTHER:
        raise KeyError(f"unknown architecture {arch!r}; the port has "
                       f"{ALL_ARCHS}")
    if key not in _REGISTRY:
        mod = importlib.import_module(f"repro_torch.configs.{key}")
        _REGISTRY[key] = mod.CONFIG
    return _REGISTRY[key]


def list_configs():
    return {a: get_config(a) for a in ALL_ARCHS}
