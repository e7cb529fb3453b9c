"""Architecture registry: ``get_config(arch_id)`` + shape helpers.

Arch ids are the assignment ids (e.g. ``qwen3-8b``); module names are
underscored. ``list_archs()`` returns all ten assigned architectures.
The modules are copies of `repro.configs`' (data only).
"""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import (  # noqa: F401  (re-exported)
    AttnConfig,
    BlockConfig,
    MambaConfig,
    MeshConfig,
    ModelConfig,
    MoEConfig,
    MULTI_POD,
    PowerControlConfig,
    SHAPES,
    SINGLE_POD,
    ShapeConfig,
    TrainConfig,
    XLSTMConfig,
    applicable_shapes,
    reduced,
)

_ARCH_MODULES: Dict[str, str] = {
    "phi3.5-moe-42b-a6.6b": "phi35_moe_42b",
    "granite-moe-3b-a800m": "granite_moe_3b",
    "qwen3-8b": "qwen3_8b",
    "starcoder2-3b": "starcoder2_3b",
    "h2o-danube-3-4b": "h2o_danube3_4b",
    "llama3-405b": "llama3_405b",
    "musicgen-medium": "musicgen_medium",
    "jamba-v0.1-52b": "jamba_v01_52b",
    "xlstm-350m": "xlstm_350m",
    "phi-3-vision-4.2b": "phi3_vision_42b",
}


def list_archs():
    return tuple(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[arch]}")
    return mod.CONFIG


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]
