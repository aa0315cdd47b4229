"""Unified D2D consensus-mixing engine — the port of ``repro/core/
mixing.py``.

One operator, four interchangeable backends for the paper's eq. (10)
``z_c <- V_c^{Gamma_c} z_c`` applied to N stacked clusters:

=============  ============================================================
backend        execution strategy
=============  ============================================================
reference      per-round masked product in float32, Python-unrolled (the
               oracle, :func:`~repro_torch.kernels.consensus_mix.
               consensus_mix_plain`)
masked_loop    bounded loop with per-cluster masking in z's dtype, rounded
               after every round (as the reference's ``fori_loop``)
pallas         the fused Γ-round kernel (:mod:`repro_torch.kernels.
               consensus_mix`: the hand-written CUDA kernel on the card,
               its plain version on the CPU); the name is kept so configs
               carry over from the JAX package
fused_power    ONE product against the stacked matrix powers
               ``W_c = V_c^{Gamma_c}``
=============  ============================================================

Every backend accepts a per-cluster ``gamma: (N,)`` (Remark 1), and
the aliases ``kernel``/``fused``/``rounds`` resolve as in the reference.
Tensors stay on their device; the loop bounds read ``max(gamma)`` on
the host.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.kernels import consensus_mix as _cm
from repro_torch.kernels.runtime import DeviceLike, resolve_device

BACKENDS = ("reference", "masked_loop", "pallas", "fused_power")

# scale-mode consensus_mode names kept for backward compatibility
_BACKEND_ALIASES = {
    "fused": "fused_power",     # one collective of the same payload
    "rounds": "reference",      # paper-faithful sequential exchanges
    "kernel": "pallas",
}


def canonical_backend(name: str) -> str:
    """Resolve aliases ("fused", "rounds", "kernel") to backend names."""
    backend = _BACKEND_ALIASES.get(name, name)
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown mixing backend {name!r}; expected one of "
            f"{BACKENDS} or aliases {tuple(_BACKEND_ALIASES)}")
    return backend


def _max_rounds(gamma: torch.Tensor) -> int:
    return int(gamma.max()) if gamma.numel() else 0


def masked_consensus_matrix(V: torch.Tensor,
                            device_mask: torch.Tensor) -> torch.Tensor:
    """Drop devices from a consensus-matrix stack (netsim contract).

    Zeroes the dropped devices' rows and columns and returns the
    removed mass to each row's self-loop, so the result is still
    symmetric and row-stochastic: a dropped device's row becomes e_i,
    an active device mixes only among the remaining active devices.
    V: (N, s, s); device_mask: (N, s) bool/0-1.
    """
    m = torch.as_tensor(device_mask, device=V.device).to(V.dtype)
    s = V.shape[-1]
    eye = torch.eye(s, dtype=V.dtype, device=V.device)
    offdiag = V * (1.0 - eye) * m[:, :, None] * m[:, None, :]
    return offdiag + (1.0 - offdiag.sum(-1))[..., None] * eye


def matrix_powers(V: torch.Tensor, gamma: Any) -> torch.Tensor:
    """Stacked powers ``W_c = V_c^{gamma_c}`` in float32; (N, s, s)."""
    N, s, _ = V.shape
    gamma = _cm.gamma_vector(gamma, N, V.device)
    Vf = V.float()
    W = torch.eye(s, dtype=torch.float32, device=V.device).expand(N, s, s)
    for r in range(_max_rounds(gamma)):
        nxt = torch.einsum("nij,njk->nik", Vf, W)
        W = torch.where((r < gamma)[:, None, None], nxt, W)
    return W.contiguous()


# ---------------------------------------------------------------------------
# backend implementations — all (N, s, M) x (N, s, s) x (N,) -> (N, s, M)
# ---------------------------------------------------------------------------

def _mix_masked_loop(z, V, gamma):
    Vz = V.to(z.dtype)
    for r in range(_max_rounds(gamma)):
        mixed = torch.einsum("nij,njm->nim", Vz, z)
        z = torch.where((r < gamma)[:, None, None], mixed, z)
    return z


def _mix_pallas(z, V, gamma):
    # the kernel takes V in float32 (the TPU kernel upcasts it inside)
    return _cm.consensus_mix(z.contiguous(), V.float().contiguous(), gamma)


def _mix_fused_power(z, V, gamma, W=None):
    if W is None:
        W = matrix_powers(V, gamma)
    return torch.einsum("nij,njm->nim", W.to(z.dtype), z)


def mix(z: torch.Tensor, V: torch.Tensor, gamma: Any, *,
        backend: str = "masked_loop", W: Optional[torch.Tensor] = None,
        device_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Apply per-cluster consensus ``z_c <- V_c^{gamma_c} z_c``.

    z: (N, s, M); V: (N, s, s); gamma: scalar or (N,) int.
    ``W`` (fused_power only): precomputed stacked powers; derived when
    omitted. ``device_mask`` (N, s): drop devices via
    :func:`masked_consensus_matrix` before dispatch. Incompatible with a
    precomputed ``W`` (powers must be taken AFTER masking).
    """
    backend = canonical_backend(backend)
    gamma = _cm.gamma_vector(gamma, z.shape[0], z.device)
    if device_mask is not None:
        if W is not None:
            raise ValueError(
                "device_mask with precomputed W is ambiguous: powers "
                "must be taken after masking — pass V and let the "
                "backend derive W, or precompute W from the masked V")
        V = masked_consensus_matrix(V, device_mask)
    if backend == "reference":
        return _cm.consensus_mix_plain(z, V, gamma)
    if backend == "masked_loop":
        return _mix_masked_loop(z, V, gamma)
    if backend == "pallas":
        return _mix_pallas(z, V, gamma)
    return _mix_fused_power(z, V, gamma, W=W)


def mix_pytree(params: dict, V: torch.Tensor, gamma: Any,
               num_clusters: int, *, backend: str = "masked_loop",
               W: Optional[torch.Tensor] = None,
               device_mask: Optional[torch.Tensor] = None) -> dict:
    """Consensus over a parameter dict whose leaves have leading axis
    I = N*s: each leaf is reshaped (I, ...) -> (N, s, M) and mixed
    independently. Returns a new dict; the inputs are not modified."""
    if device_mask is not None:
        if W is not None:
            raise ValueError(
                "device_mask with precomputed W is ambiguous (see mix)")
        V = masked_consensus_matrix(V, device_mask)

    def one(leaf):
        s = leaf.shape[0] // num_clusters
        flat = leaf.reshape(num_clusters, s, -1)
        mixed = mix(flat, V.to(flat.dtype), gamma, backend=backend, W=W)
        return mixed.reshape(leaf.shape).to(leaf.dtype)

    return {k: one(v) for k, v in params.items()}


# ---------------------------------------------------------------------------
# step-build-time plans
# ---------------------------------------------------------------------------

def _exact_powers(V: np.ndarray, gamma: np.ndarray) -> np.ndarray:
    return np.stack([np.linalg.matrix_power(V[c], int(gamma[c]))
                     for c in range(V.shape[0])])


@dataclass(frozen=True)
class MixingPlan:
    """A consensus event bound to (topology, gamma, backend) at build
    time. ``W`` is the exact stacked power for ``fused_power`` —
    computed ONCE here (numpy integer matrix powers)."""
    backend: str
    num_clusters: int
    cluster_size: int
    V: torch.Tensor                     # (N, s, s) float32
    gamma: torch.Tensor                 # (N,) int32
    W: Optional[torch.Tensor] = None    # (N, s, s) float32, fused_power only

    @property
    def is_noop(self) -> bool:
        return bool((self.gamma == 0).all())

    def _matrices(self, refresh: Optional[torch.Tensor]):
        """Resolve (V, W) given an optional per-call refresh matrix:
        the stacked powers W for ``fused_power``, the (masked)
        consensus matrices V otherwise."""
        if refresh is None:
            return self.V, self.W
        if self.backend == "fused_power":
            return self.V, refresh
        return refresh, None

    def apply(self, z: torch.Tensor,
              refresh: Optional[torch.Tensor] = None) -> torch.Tensor:
        """z: (N, s, M) -> mixed (N, s, M)."""
        V, W = self._matrices(refresh)
        return mix(z, V, self.gamma, backend=self.backend, W=W)

    def fused_w(self, refresh: Optional[torch.Tensor] = None
                ) -> Optional[torch.Tensor]:
        """The stacked (N, s, s) powers if this plan applies as ONE
        matrix product (``fused_power`` backend), else None."""
        if self.backend != "fused_power":
            return None
        return self._matrices(refresh)[1]

    def apply_pytree(self, params: dict,
                     refresh: Optional[torch.Tensor] = None) -> dict:
        """params: dict with leading replica/device axis I = N*s."""
        if self.is_noop and refresh is None:
            return params
        V, W = self._matrices(refresh)
        return mix_pytree(params, V, self.gamma, self.num_clusters,
                          backend=self.backend, W=W)


def build_mixing_plan(net, gamma: Any, backend: str = "fused_power",
                      device: DeviceLike = None) -> MixingPlan:
    """Build a :class:`MixingPlan` from a ``Network`` (or a raw (N, s, s)
    consensus-matrix stack), concrete per-cluster gamma, and a backend.
    The plan's tensors live on ``device`` (see
    :func:`~repro_torch.kernels.runtime.resolve_device`)."""
    backend = canonical_backend(backend)
    device = resolve_device(device)
    V = np.asarray(getattr(net, "V", net), np.float32)
    N, s, _ = V.shape
    g = np.asarray(gamma, np.int32)
    if g.ndim == 0:
        g = np.full((N,), g, np.int32)
    if g.shape != (N,):
        raise ValueError(f"gamma must be scalar or ({N},), got {g.shape}")
    if (g < 0).any():
        raise ValueError(f"gamma must be >= 0 rounds, got {g.tolist()}")
    W = None
    if backend == "fused_power":
        W = torch.as_tensor(_exact_powers(V, g), dtype=torch.float32,
                            device=device)
    return MixingPlan(backend=backend, num_clusters=N, cluster_size=s,
                      V=torch.as_tensor(V, device=device),
                      gamma=torch.as_tensor(g, device=device), W=W)


def refresh_matrices(plan: MixingPlan, V: Any, device_mask: Any = None,
                     gamma: Any = None) -> torch.Tensor:
    """Host-side per-event matrices for ``MixingPlan.apply*(refresh=)``:
    exact numpy integer powers ``W = V^Gamma`` for ``fused_power``, the
    (masked) ``V`` itself otherwise, on the plan's device. A per-event
    ``gamma`` override needs ``fused_power`` (other backends read Γ from
    the plan)."""
    Vn = np.asarray(V, np.float32)
    if device_mask is not None:
        Vn = masked_consensus_matrix(
            torch.as_tensor(Vn), torch.as_tensor(np.asarray(device_mask))
        ).numpy()
    device = plan.V.device
    if plan.backend != "fused_power":
        if gamma is not None:
            raise ValueError(
                "per-event gamma refresh needs the fused_power backend "
                f"(plan is {plan.backend!r}: gamma is fixed in the plan "
                "and cannot change per interval)")
        return torch.as_tensor(Vn, device=device)
    g = np.asarray(plan.gamma.cpu() if gamma is None else gamma, np.int32)
    return torch.as_tensor(_exact_powers(Vn, g), dtype=torch.float32,
                           device=device)


__all__ = ["BACKENDS", "MixingPlan", "build_mixing_plan",
           "canonical_backend", "masked_consensus_matrix",
           "matrix_powers", "mix", "mix_pytree", "refresh_matrices"]
