"""D2D consensus operators (eq. 10) — simulation mode; the port of
``repro/core/consensus.py``.

State layout: device parameters stacked on a leading axis, reshaped per
cluster to ``(N, s, M)``. One consensus *round* is the block-diagonal
product ``z <- V_c z``; an *event* applies ``Gamma_c`` rounds. Execution
is delegated to :mod:`repro_torch.core.mixing`; this module keeps the
simulation-facing API and the consensus *metrics* (Definitions 2-3).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core import mixing


def mix_once(z: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """One consensus round. z: (N, s, M); V: (N, s, s)."""
    return torch.einsum("nij,njm->nim", V.to(z.dtype), z)


def _resolve_backend(use_kernel: bool, backend: str | None) -> str:
    if backend is not None:
        return mixing.canonical_backend(backend)
    return "pallas" if use_kernel else "masked_loop"


def mix(z: torch.Tensor, V: torch.Tensor, gamma: Any,
        use_kernel: bool = False, backend: str | None = None) -> torch.Tensor:
    """Apply per-cluster consensus: z_c <- V_c^{gamma_c} z_c.
    z: (N, s, M); V: (N, s, s); gamma: scalar or (N,) int."""
    return mixing.mix(z, V, gamma, backend=_resolve_backend(use_kernel,
                                                             backend))


def mix_pytree(params: dict, V: torch.Tensor, gamma: Any, num_clusters: int,
               use_kernel: bool = False, backend: str | None = None) -> dict:
    """Consensus over a parameter dict whose leaves have leading axis
    I = N*s (each leaf mixed independently as (N, s, M))."""
    return mixing.mix_pytree(params, V, gamma, num_clusters,
                             backend=_resolve_backend(use_kernel, backend))


def cluster_means(z: torch.Tensor) -> torch.Tensor:
    """(N, s, M) -> (N, M): the targets of perfect consensus."""
    return z.mean(dim=1)


def consensus_error(z: torch.Tensor) -> torch.Tensor:
    """Per-cluster mean squared consensus error (Definition 3):
    (1/s) sum_i ||e_i||^2 with e_i = z_i - zbar_c. Returns (N,)."""
    e = z - cluster_means(z)[:, None, :]
    return (e * e).sum(dim=-1).mean(dim=1)


def divergence_upsilon(z: torch.Tensor) -> torch.Tensor:
    """Definition 2: per-cluster max elementwise spread Upsilon_c.
    z: (N, s, M) -> (N,)."""
    lo, hi = torch.aminmax(z, dim=1)
    return (hi - lo).amax(dim=-1)


def masked_divergence_upsilon(z: torch.Tensor,
                              device_mask: torch.Tensor) -> torch.Tensor:
    """Definition-2 spread over the ACTIVE devices only (netsim churn).
    Clusters with < 2 active devices have zero spread.
    z: (N, s, M), device_mask: (N, s) bool -> (N,)."""
    mask = torch.as_tensor(device_mask, dtype=torch.bool, device=z.device)
    m = mask[..., None]
    big = torch.finfo(z.dtype).max
    hi = torch.where(m, z, -big).amax(dim=1)
    lo = torch.where(m, z, big).amin(dim=1)
    spread = (hi - lo).amax(dim=-1)
    enough = mask.sum(dim=1) >= 2
    return torch.where(enough, spread, torch.zeros_like(spread))


__all__ = ["cluster_means", "consensus_error", "divergence_upsilon",
           "masked_divergence_upsilon", "mix", "mix_once", "mix_pytree"]
