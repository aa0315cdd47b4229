"""Configs of the port: the shared dataclasses of ``configs/base.py`` and
the ``--arch <id>`` registry of the model zoo (copies of the reference's
``repro/configs/*.py``, which are jax-free)."""
from __future__ import annotations

from repro_torch.configs.base import (
    ARCH_KINDS,
    INPUT_SHAPES,
    ControlConfig,
    DynamicsConfig,
    HierarchyConfig,
    InputShape,
    ModelConfig,
    TopologyConfig,
    TrainConfig,
    TTHFConfig,
)

from repro_torch.configs.whisper_small import CONFIG as _whisper_small
from repro_torch.configs.gemma_2b import CONFIG as _gemma_2b
from repro_torch.configs.recurrentgemma_9b import CONFIG as _recurrentgemma_9b
from repro_torch.configs.llama4_maverick_400b_a17b import CONFIG as _maverick
from repro_torch.configs.paligemma_3b import CONFIG as _paligemma_3b
from repro_torch.configs.granite_3_8b import CONFIG as _granite_3_8b
from repro_torch.configs.mamba2_370m import CONFIG as _mamba2_370m
from repro_torch.configs.starcoder2_3b import CONFIG as _starcoder2_3b
from repro_torch.configs.qwen15_05b import CONFIG as _qwen15_05b
from repro_torch.configs.llama4_scout_17b_a16e import CONFIG as _scout

ARCHS: dict[str, ModelConfig] = {
    c.name: c
    for c in (
        _whisper_small,
        _gemma_2b,
        _recurrentgemma_9b,
        _maverick,
        _paligemma_3b,
        _granite_3_8b,
        _mamba2_370m,
        _starcoder2_3b,
        _qwen15_05b,
        _scout,
    )
}


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; choose from {sorted(ARCHS)}")
    return ARCHS[name]


def get_shape(name: str) -> InputShape:
    if name not in INPUT_SHAPES:
        raise KeyError(
            f"unknown shape {name!r}; choose from {sorted(INPUT_SHAPES)}")
    return INPUT_SHAPES[name]


__all__ = [
    "ARCHS", "ARCH_KINDS", "INPUT_SHAPES", "ControlConfig",
    "DynamicsConfig",
    "HierarchyConfig", "InputShape", "ModelConfig", "TopologyConfig",
    "TrainConfig", "TTHFConfig", "get_arch", "get_shape",
]
