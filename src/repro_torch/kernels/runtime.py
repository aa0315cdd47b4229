"""Where the port runs: one device rule for every entry point.

The reference picks interpret mode off-TPU (``repro/kernels/runtime.py``).
The port's counterpart is the device: entry points run on ``cuda`` unless
the caller asks for another device by name. With no GPU and no explicit
request they raise — a run never carries on quietly on the CPU.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> the current CUDA device, or raise when there is none;
    an explicit device (``"cpu"``, ``"cuda:1"``) is taken as given."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: pass device='cpu' to run on "
            "the CPU explicitly")
    return torch.device("cuda", torch.cuda.current_device())


__all__ = ["DeviceLike", "resolve_device"]
