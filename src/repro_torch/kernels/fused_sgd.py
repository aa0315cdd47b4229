"""Fused SGD update ``w - eta (g + wd w)`` — the Hopper kernel and its
plain version.

:func:`fused_sgd` replaces the Pallas TPU kernel ``repro/kernels/
fused_sgd.py::fused_sgd``: the update half of
:mod:`repro_torch.kernels.fused_consensus_sgd`, one elementwise pass over
any contiguous tensor, float32 inside. On a CUDA tensor it launches the
hand-written kernel of ``csrc/fused_consensus_sgd.cu`` on the flattened
tensor seen as one cluster of one replica, ``(1, 1, numel)``, with a 1x1
W of ones: ``fmaf(1, w', 0) = w'`` exactly, so that instance computes the
update with the same rounding, and the port keeps one body to build and
speed up. On a CPU tensor it runs :func:`fused_sgd_plain`. There is no
fallback from one to the other.

No trainer calls it, in the reference or in the port (the reference
reaches it only from ``benchmarks/kernel_bench.py`` and
``tests/test_kernels.py``); the port keeps that wiring.

Bound: one read of w, one of g and one write, ``3 * bytes(w) / 3.35
TB/s`` on an H100 SXM. ``fused_sgd.launches`` counts kernel launches.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.kernels.fused_consensus_sgd import eta_tensor, launch

_DTYPES = (torch.float32, torch.bfloat16)
_ONES: dict[torch.device, torch.Tensor] = {}   # the 1x1 W, per device


def fused_sgd_plain(w: torch.Tensor, g: torch.Tensor, eta: Any,
                    weight_decay: float = 0.0) -> torch.Tensor:
    """``w - eta (g + wd w)`` in float32, rounded to w's dtype once."""
    eta = eta_tensor(eta, w.device)
    wf, gf = w.float(), g.float()
    if weight_decay:
        gf = gf + weight_decay * wf
    return (wf - eta * gf).to(w.dtype)


def fused_sgd(w: torch.Tensor, g: torch.Tensor, eta: Any,
              weight_decay: float = 0.0) -> torch.Tensor:
    """w, g: one shape, float32/bfloat16; eta: a scalar -> the updated w
    (a new tensor of w's shape and dtype).

    CPU tensors take :func:`fused_sgd_plain`; CUDA tensors launch the
    kernel, which needs contiguous w and g.
    """
    if g.shape != w.shape:
        raise ValueError(f"g must match w's {tuple(w.shape)}, "
                         f"got {tuple(g.shape)}")
    if w.dtype not in _DTYPES:
        raise TypeError(f"w must be float32 or bfloat16, got {w.dtype}")
    if g.dtype != w.dtype:
        raise TypeError(f"g must be {w.dtype} like w, got {g.dtype}")
    if g.device != w.device:
        raise ValueError(f"w is on {w.device}, g on {g.device}")
    if w.device.type == "cpu":
        return fused_sgd_plain(w, g, eta, weight_decay)
    if w.device.type != "cuda":
        raise ValueError(f"fused_sgd runs on cpu or cuda, not {w.device}")
    if not (w.is_contiguous() and g.is_contiguous()):
        raise ValueError("fused_sgd needs contiguous w and g")
    ones = _ONES.get(w.device)
    if ones is None:
        ones = _ONES[w.device] = torch.ones((1, 1, 1), device=w.device)
    n = w.numel()
    out = launch(w.view(1, 1, n), g.view(1, 1, n), ones, eta,
                 weight_decay).view(w.shape)
    fused_sgd.launches += 1
    return out


fused_sgd.launches = 0


__all__ = ["fused_sgd", "fused_sgd_plain"]
