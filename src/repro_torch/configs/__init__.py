"""Config registry: ``get_config(name)`` / ``--arch <id>``.

A copy of the reference package's ``configs`` (plain dataclasses, one
module per architecture), kept field for field equal to it by
``tests/test_torch_numpy_copies.py``.
"""

from __future__ import annotations

import importlib

from .base import (
    DECODE_32K,
    LONG_500K,
    PREFILL_32K,
    SHAPES,
    TRAIN_4K,
    LayerKind,
    ModelConfig,
    ShapeConfig,
    shapes_for,
)

_ARCH_MODULES = {
    "recurrentgemma-2b": "recurrentgemma_2b",
    "phi3-medium-14b": "phi3_medium_14b",
    "qwen3-8b": "qwen3_8b",
    "gemma3-27b": "gemma3_27b",
    "h2o-danube-3-4b": "h2o_danube3_4b",
    "whisper-base": "whisper_base",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b",
    "rwkv6-7b": "rwkv6_7b",
    "phi-3-vision-4.2b": "phi3_vision_4_2b",
}

# non-assigned extras (examples / paper experiments); selectable by name
# but excluded from the assigned-architecture sweep
_EXTRA_MODULES = {
    "repro-100m": "repro_100m",
}

ARCH_NAMES = tuple(_ARCH_MODULES)


def get_config(name: str) -> ModelConfig:
    if name.endswith("-reduced"):
        return get_config(name[: -len("-reduced")]).reduced()
    modules = {**_ARCH_MODULES, **_EXTRA_MODULES}
    if name not in modules:
        raise KeyError(f"unknown arch {name!r}; known: "
                       f"{ARCH_NAMES + tuple(_EXTRA_MODULES)}")
    mod = importlib.import_module(f".{modules[name]}", __package__)
    return mod.CONFIG


def all_configs() -> dict[str, ModelConfig]:
    return {n: get_config(n) for n in ARCH_NAMES}


__all__ = [
    "ARCH_NAMES", "get_config", "all_configs", "ModelConfig", "ShapeConfig",
    "LayerKind", "SHAPES", "TRAIN_4K", "PREFILL_32K", "DECODE_32K",
    "LONG_500K", "shapes_for",
]
