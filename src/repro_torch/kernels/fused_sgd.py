"""Fused SGD update ``w - eta (g + wd w)`` — the Hopper kernel and its
plain version.

:func:`fused_sgd` replaces the Pallas TPU kernel ``repro/kernels/
fused_sgd.py::fused_sgd``: the update half of
:mod:`repro_torch.kernels.fused_consensus_sgd`, one elementwise pass over
any contiguous tensor, float32 inside. On a CUDA tensor it launches
``fused_sgd_kernel`` of ``csrc/fused_consensus_sgd.cu``, a streaming
kernel of its own (16-byte loads and stores, a grid-stride loop) that
takes the update from the same ``__device__`` function as the mixing
kernel, so the port keeps one SGD arithmetic; in float32 its result is
bitwise that of :func:`fused_sgd_plain`. On a CPU tensor it runs
:func:`fused_sgd_plain`. There is no fallback from one to the other.

No trainer calls it, in the reference or in the port (the reference
reaches it only from ``benchmarks/kernel_bench.py`` and
``tests/test_kernels.py``); the port keeps that wiring.

Bound: one read of w, one of g and one write, ``3 * bytes(w) / 3.35
TB/s`` on an H100 SXM. ``fused_sgd.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Any

import torch

from repro_torch.kernels import build
from repro_torch.kernels.fused_consensus_sgd import eta_tensor

_ENTRY = {torch.float32: "fused_sgd_f32", torch.bfloat16: "fused_sgd_bf16"}


def fused_sgd_plain(w: torch.Tensor, g: torch.Tensor, eta: Any,
                    weight_decay: float = 0.0) -> torch.Tensor:
    """``w - eta (g + wd w)`` in float32, rounded to w's dtype once."""
    eta = eta_tensor(eta, w.device)
    wf, gf = w.float(), g.float()
    if weight_decay:
        gf = gf + weight_decay * wf
    return (wf - eta * gf).to(w.dtype)


def _library() -> ctypes.CDLL:
    lib = build.load("fused_consensus_sgd")
    for entry in _ENTRY.values():
        fn = getattr(lib, entry)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_float, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def out_like(w: torch.Tensor) -> torch.Tensor:
    """An empty tensor of w's shape and dtype whose address shares w's
    offset mod 16 bytes, so that a view such as ``big[1:]`` still takes
    the kernel's 16-byte path (a fresh allocation is 512-byte aligned)."""
    skip = w.data_ptr() % 16 // w.element_size()
    buf = torch.empty(w.numel() + skip, dtype=w.dtype, device=w.device)
    return buf[skip:].view(w.shape)


def fused_sgd(w: torch.Tensor, g: torch.Tensor, eta: Any,
              weight_decay: float = 0.0) -> torch.Tensor:
    """w, g: one shape, float32/bfloat16; eta: a scalar -> the updated w
    (a new tensor of w's shape and dtype).

    CPU tensors take :func:`fused_sgd_plain`; CUDA tensors launch the
    kernel, which needs contiguous w and g (at any offset).
    """
    if g.shape != w.shape:
        raise ValueError(f"g must match w's {tuple(w.shape)}, "
                         f"got {tuple(g.shape)}")
    if w.dtype not in _ENTRY:
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
    eta = eta_tensor(eta, w.device)
    out = out_like(w)
    if out.numel() == 0:
        return out
    fn = getattr(_library(), _ENTRY[w.dtype])
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        err = fn(w.data_ptr(), g.data_ptr(), eta.data_ptr(),
                 float(weight_decay), out.data_ptr(), w.numel(), stream)
    if err != 0:
        raise RuntimeError(
            f"fused_sgd kernel launch failed with CUDA error {err}")
    fused_sgd.launches += 1
    return out


fused_sgd.launches = 0


__all__ = ["fused_sgd", "fused_sgd_plain", "out_like"]
