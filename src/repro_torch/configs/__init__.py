"""Configs of the port: the shared dataclasses of ``configs/base.py``.

The architecture configs of the model zoo (``--arch``) come with the
scale-mode leg; only the algorithm and topology knobs are here.
"""
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

__all__ = [
    "ARCH_KINDS", "INPUT_SHAPES", "ControlConfig", "DynamicsConfig",
    "HierarchyConfig", "InputShape", "ModelConfig", "TopologyConfig",
    "TrainConfig", "TTHFConfig",
]
