"""Fused last-microstep SGD + D2D consensus mixing — the Hopper kernel
and its plain version.

:func:`fused_consensus_sgd` computes ``W_c @ (w_c - eta (g_c + wd w_c))``
for N stacked clusters in one pass, float32 inside and one write in w's
dtype. It ends every consensus block of the fused-interval scale step
(:func:`repro_torch.core.distributed.make_tthf_train_step` with
``fused_interval=True``). It replaces the Pallas TPU kernel
``repro/kernels/fused_consensus_sgd.py::fused_consensus_sgd``: on a CUDA
tensor it launches the hand-written kernel of
``csrc/fused_consensus_sgd.cu`` (built for ``sm_90a`` at first use by
:mod:`repro_torch.kernels.build`; its SGD step is the ``__device__``
function that :mod:`repro_torch.kernels.fused_sgd`'s kernel uses too);
on a CPU tensor it runs :func:`fused_consensus_sgd_plain`. There is no
fallback from one to the other: a CUDA tensor launches the kernel or
raises.

The kernel reads w and g once and writes the result once, so it is
bound by device memory: ``3 * bytes(w) / 3.35 TB/s`` on an H100 SXM. The
source note in ``csrc/fused_consensus_sgd.cu`` gives the design.

On fake tensors (the dry run) it launches nothing and runs no plain
arithmetic: it returns a fake result and charges the kernel's bytes (w
and g read once, the result written once) and the 2 N s^2 M operations
of the mix.

``fused_consensus_sgd.launches`` counts kernel launches (CPU calls do
not count); a caller resets it to 0 before a run it wants to read.
"""
from __future__ import annotations

import ctypes
from typing import Any

import torch

from repro_torch.kernels import build
from repro_torch.kernels.runtime import charge, is_fake, nbytes

MAX_CLUSTER_SIZE = 16          # kMaxClusterSize in csrc/fused_consensus_sgd.cu
_MAX_CLUSTERS = 65_535         # the kernel's grid.y
_ENTRY = {torch.float32: "fused_consensus_sgd_f32",
          torch.bfloat16: "fused_consensus_sgd_bf16"}


def eta_tensor(eta: Any, device: torch.device) -> torch.Tensor:
    """A scalar learning rate (float or 1-element tensor) -> a 0-d
    float32 tensor on ``device`` (the kernels read it from device
    memory)."""
    eta = torch.as_tensor(eta, dtype=torch.float32, device=device)
    if eta.numel() != 1:
        raise ValueError(f"eta must be a scalar, got shape {tuple(eta.shape)}")
    return eta.reshape(())


def fused_consensus_sgd_plain(w: torch.Tensor, g: torch.Tensor,
                              W: torch.Tensor, eta: Any,
                              weight_decay: float = 0.0) -> torch.Tensor:
    """w, g: (N, s, M); W: (N, s, s) -> ``W @ (w - eta (g + wd w))``.

    The SGD step and the mix both in float32 (as the TPU kernel), rounded
    to w's dtype once at the end."""
    eta = eta_tensor(eta, w.device)
    wf, gf = w.float(), g.float()
    if weight_decay:
        gf = gf + weight_decay * wf
    wp = wf - eta * gf
    return torch.einsum("nij,njm->nim", W.float(), wp).to(w.dtype)


def _library() -> ctypes.CDLL:
    lib = build.load("fused_consensus_sgd")
    for entry in _ENTRY.values():
        fn = getattr(lib, entry)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check(w: torch.Tensor, g: torch.Tensor, W: torch.Tensor) -> None:
    if w.ndim != 3:
        raise ValueError(f"w must be (N, s, M), got {tuple(w.shape)}")
    N, s, _ = w.shape
    if g.shape != w.shape:
        raise ValueError(f"g must match w's {tuple(w.shape)}, "
                         f"got {tuple(g.shape)}")
    if tuple(W.shape) != (N, s, s):
        raise ValueError(f"W must be ({N}, {s}, {s}), got {tuple(W.shape)}")
    if w.dtype not in _ENTRY:
        raise TypeError(f"w must be float32 or bfloat16, got {w.dtype}")
    if g.dtype != w.dtype:
        raise TypeError(f"g must be {w.dtype} like w, got {g.dtype}")
    if W.dtype != torch.float32:
        raise TypeError(f"W must be float32, got {W.dtype}")
    if not (g.device == W.device == w.device):
        raise ValueError(f"w, g and W must share a device, got {w.device}, "
                         f"{g.device} and {W.device}")


def fused_consensus_sgd(w: torch.Tensor, g: torch.Tensor, W: torch.Tensor,
                        eta: Any, weight_decay: float = 0.0) -> torch.Tensor:
    """w, g: (N, s, M) float32/bfloat16, W: (N, s, s) float32, eta: a
    scalar -> ``W_c @ (w_c - eta (g_c + wd w_c))`` in w's dtype (a new
    tensor).

    CPU tensors take :func:`fused_consensus_sgd_plain`; CUDA tensors
    launch the kernel, which needs contiguous w, g and W,
    s <= MAX_CLUSTER_SIZE and N <= 65,535.
    """
    _check(w, g, W)
    if is_fake(w):
        out = torch.empty_like(w)
        N, s, M = w.shape
        charge("fused_consensus_sgd", 2 * N * s * s * M,
               nbytes(w, g, W, out))
        return out
    if w.device.type == "cpu":
        return fused_consensus_sgd_plain(w, g, W, eta, weight_decay)
    if w.device.type != "cuda":
        raise ValueError(
            f"fused_consensus_sgd runs on cpu or cuda, not {w.device}")
    N, s, M = w.shape
    if s > MAX_CLUSTER_SIZE:
        raise ValueError(
            f"cluster size {s} exceeds the kernel's {MAX_CLUSTER_SIZE}")
    if N > _MAX_CLUSTERS:
        raise ValueError(f"{N} clusters exceed the kernel's {_MAX_CLUSTERS}")
    if not (w.is_contiguous() and g.is_contiguous() and W.is_contiguous()):
        raise ValueError("fused_consensus_sgd needs contiguous w, g and W")
    eta = eta_tensor(eta, w.device)
    out = torch.empty_like(w)
    if out.numel() == 0:
        return out
    fn = getattr(_library(), _ENTRY[w.dtype])
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        err = fn(w.data_ptr(), g.data_ptr(), W.data_ptr(), eta.data_ptr(),
                 float(weight_decay), out.data_ptr(), N, s, M, stream)
    if err != 0:
        raise RuntimeError(
            f"fused_consensus_sgd kernel launch failed with CUDA error {err}")
    fused_consensus_sgd.launches += 1
    return out


fused_consensus_sgd.launches = 0


__all__ = ["MAX_CLUSTER_SIZE", "eta_tensor", "fused_consensus_sgd",
           "fused_consensus_sgd_plain"]
