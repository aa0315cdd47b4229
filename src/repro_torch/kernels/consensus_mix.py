"""Fused Γ-round D2D consensus mixing — the Hopper kernel and its plain
version.

:func:`consensus_mix` computes ``z_c <- V_c^{gamma_c} z_c`` for N
stacked clusters, with each cluster's own round count (Remark 1). It
replaces the Pallas TPU kernel ``repro/kernels/consensus_mix.py::
consensus_mix``: on a CUDA tensor it launches the hand-written kernel
of ``csrc/consensus_mix.cu`` (built for ``sm_90a`` at first use by
:mod:`repro_torch.kernels.build`); on a CPU tensor it runs
:func:`consensus_mix_plain`, the port of the reference oracle
``repro/kernels/ref.py::consensus_mix_ref``. There is no fallback from
one to the other: a CUDA tensor launches the kernel or raises.

The kernel reads z once and writes the result once whatever Γ is, so it
is bound by device memory: ``2 * bytes(z) / 3.35 TB/s`` on an H100 SXM.
The source note in ``csrc/consensus_mix.cu`` gives the design.

``consensus_mix.launches`` counts kernel launches (CPU calls do not
count); a caller resets it to 0 before a run it wants to read.
"""
from __future__ import annotations

import ctypes
from typing import Any

import torch

from repro_torch.kernels import build

MAX_CLUSTER_SIZE = 16          # kMaxClusterSize in csrc/consensus_mix.cu
_MAX_CLUSTERS = 65_535         # the kernel's grid.y
_ENTRY = {torch.float32: "consensus_mix_f32",
          torch.bfloat16: "consensus_mix_bf16"}


def gamma_vector(gamma: Any, num_clusters: int,
                 device: torch.device) -> torch.Tensor:
    """Scalar or (N,) round counts -> an (N,) int32 tensor on ``device``."""
    gamma = torch.as_tensor(gamma, dtype=torch.int32, device=device)
    if gamma.ndim == 0:
        gamma = gamma.expand(num_clusters)
    if gamma.shape != (num_clusters,):
        raise ValueError(
            f"gamma must be scalar or ({num_clusters},), "
            f"got {tuple(gamma.shape)}")
    return gamma.contiguous()


def consensus_mix_plain(z: torch.Tensor, V: torch.Tensor,
                        gamma: Any) -> torch.Tensor:
    """z: (N, s, M); V: (N, s, s); gamma: scalar or (N,) -> V_c^{gamma_c} z_c.

    Explicit per-round product with per-cluster masking, every round in
    float32, rounded to z's dtype once at the end.
    """
    gamma = gamma_vector(gamma, z.shape[0], z.device)
    max_gamma = int(gamma.max()) if gamma.numel() else 0
    out = z.float()
    Vf = V.float()
    for r in range(max_gamma):
        mixed = torch.einsum("nij,njm->nim", Vf, out)
        out = torch.where((r < gamma)[:, None, None], mixed, out)
    return out.to(z.dtype)


def _library() -> ctypes.CDLL:
    lib = build.load("consensus_mix")
    for entry in _ENTRY.values():
        fn = getattr(lib, entry)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check(z: torch.Tensor, V: torch.Tensor) -> None:
    if z.ndim != 3:
        raise ValueError(f"z must be (N, s, M), got {tuple(z.shape)}")
    N, s, _ = z.shape
    if tuple(V.shape) != (N, s, s):
        raise ValueError(f"V must be ({N}, {s}, {s}), got {tuple(V.shape)}")
    if z.dtype not in _ENTRY:
        raise TypeError(f"z must be float32 or bfloat16, got {z.dtype}")
    if V.dtype != torch.float32:
        raise TypeError(f"V must be float32, got {V.dtype}")
    if V.device != z.device:
        raise ValueError(f"V is on {V.device}, z on {z.device}")


def consensus_mix(z: torch.Tensor, V: torch.Tensor,
                  gamma: Any) -> torch.Tensor:
    """z: (N, s, M) float32/bfloat16, V: (N, s, s) float32, gamma: scalar
    or (N,) int -> ``V_c^{gamma_c} z_c`` in z's dtype (a new tensor).

    CPU tensors take :func:`consensus_mix_plain`; CUDA tensors launch
    the kernel, which needs contiguous z and V, s <= MAX_CLUSTER_SIZE
    and N <= 65,535.
    """
    _check(z, V)
    gamma = gamma_vector(gamma, z.shape[0], z.device)
    if z.device.type == "cpu":
        return consensus_mix_plain(z, V, gamma)
    if z.device.type != "cuda":
        raise ValueError(f"consensus_mix runs on cpu or cuda, not {z.device}")
    N, s, M = z.shape
    if s > MAX_CLUSTER_SIZE:
        raise ValueError(
            f"cluster size {s} exceeds the kernel's {MAX_CLUSTER_SIZE}")
    if N > _MAX_CLUSTERS:
        raise ValueError(f"{N} clusters exceed the kernel's {_MAX_CLUSTERS}")
    if not (z.is_contiguous() and V.is_contiguous()):
        raise ValueError("consensus_mix needs contiguous z and V")
    out = torch.empty_like(z)
    if out.numel() == 0:
        return out
    fn = getattr(_library(), _ENTRY[z.dtype])
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream(z.device).cuda_stream
        err = fn(z.data_ptr(), V.data_ptr(), gamma.data_ptr(),
                 out.data_ptr(), N, s, M, stream)
    if err != 0:
        raise RuntimeError(
            f"consensus_mix kernel launch failed with CUDA error {err}")
    consensus_mix.launches += 1
    return out


consensus_mix.launches = 0


__all__ = ["MAX_CLUSTER_SIZE", "consensus_mix", "consensus_mix_plain",
           "gamma_vector"]
