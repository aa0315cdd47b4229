"""Availability-aware sampling and straggler pricing (DESIGN.md §8).

The sampling layer of eq. (7) assumes every device answers the server.
Under churn it must not: the server can only sample among *available*
devices, and a fully-dark cluster contributes nothing — its weight is
renormalized away. Rather than thread index juggling through the
device-side aggregation, everything is expressed as one per-device **aggregation
weight matrix** ``w`` with ``w.sum() == 1`` (or 0 when the whole fleet
is dark):

    w_hat = sum_{c,i} w[c, i] * z[c, i]

which keeps the device side a single einsum
(:func:`weighted_global_pytree`) and makes unbiasedness auditable: for
uniform sampling among availables, ``E[w_hat]`` is the
varrho'-weighted mean of the *available* devices' cluster means.

Straggler pricing: communication involving a straggling device pays its
tail multiplier. A D2D round completes when the slowest ACTIVE member
finishes (max over the cluster); an uplink pays the sampled device's
own multiplier. Both feed :class:`~repro_torch.core.energy.CommLedger`.
"""
from __future__ import annotations

import numpy as np
import torch


# ---------------------------------------------------------------------------
# availability-aware cluster sampling (host side — numpy)
# ---------------------------------------------------------------------------

def renormalized_varrho(device_up: np.ndarray,
                        base_varrho: np.ndarray) -> np.ndarray:
    """(N, s) availability + base varrho -> (N,) cluster weights.

    Clusters keep their paper weight varrho_c = s_c / I while they
    have ANY available device; a fully-dark cluster's weight is zeroed
    and the remainder renormalized to sum to 1. With everyone up this
    is exactly the base weighting. All-dark fleet: returns the base
    weights unchanged (the caller should skip the aggregation — there
    is nobody to sample).
    """
    counts = np.asarray(device_up, bool).sum(axis=1)
    base = np.asarray(base_varrho, np.float64)
    live = counts > 0
    mass = base[live].sum()
    if mass == 0:
        return base.copy()
    return np.where(live, base, 0.0) / mass


def availability_sample(rng: np.random.Generator, device_up: np.ndarray,
                        k: int = 1) -> tuple[np.ndarray, np.ndarray]:
    """Sample min(k, available_c) devices per cluster, uniformly
    WITHOUT replacement among the available ones.

    Returns ``(picks, counts)``: picks is (N, k) int32 (entries beyond
    counts[c] are -1), counts is (N,) int — how many were actually
    sampled (0 for a dark cluster).
    """
    up = np.asarray(device_up, bool)
    N, s = up.shape
    picks = np.full((N, k), -1, np.int32)
    counts = np.zeros(N, np.int64)
    for c in range(N):
        avail = np.flatnonzero(up[c])
        kc = min(k, len(avail))
        if kc:
            picks[c, :kc] = rng.choice(avail, size=kc, replace=False)
        counts[c] = kc
    return picks, counts


def aggregation_weights(picks: np.ndarray, counts: np.ndarray,
                        varrho: np.ndarray, cluster_size: int) -> np.ndarray:
    """(N, k) picks -> (N, s) per-device aggregation weights.

    Each sampled device in cluster c carries varrho'_c / counts_c (the
    within-cluster average of the k representatives, eq. (7) with
    multi-sampling); dark clusters carry 0 and the remaining weights
    are renormalized to sum to 1.
    """
    N, k = picks.shape
    w = np.zeros((N, cluster_size))
    live = counts > 0
    mass = varrho[live].sum()
    if mass == 0:
        return w
    for c in range(N):
        if counts[c]:
            w[c, picks[c, :counts[c]]] = varrho[c] / (counts[c] * mass)
    return w


def full_participation_weights(device_up: np.ndarray,
                               varrho: np.ndarray) -> np.ndarray:
    """Full-participation aggregation over the AVAILABLE devices only."""
    up = np.asarray(device_up, float)
    counts = up.sum(axis=1)
    w = np.zeros_like(up)
    live = counts > 0
    mass = varrho[live].sum()
    if mass == 0:
        return w
    w[live] = (up[live] * (varrho[live] / (counts[live] * mass))[:, None])
    return w


def weighted_global_pytree(params: dict, weights: torch.Tensor,
                           num_clusters: int) -> dict:
    """Aggregate leaves (I, ...) with per-device weights (N, s).

    The device-side counterpart of the host-side weight builders above:
    w_hat = sum_{c,i} w[c,i] z[c,i].
    """
    def one(leaf):
        I = leaf.shape[0]
        s = I // num_clusters
        z = leaf.reshape(num_clusters, s, -1)
        g = torch.einsum("cs,csm->m",
                         weights.to(device=z.device, dtype=z.dtype), z)
        return g.reshape(leaf.shape[1:])
    return {k: one(v) for k, v in params.items()}


# ---------------------------------------------------------------------------
# straggler tail latency
# ---------------------------------------------------------------------------

def consensus_tail_mult(delay_mult: np.ndarray, device_up: np.ndarray,
                        adj_active: np.ndarray) -> np.ndarray:
    """(N,) per-cluster D2D-round tail multiplier.

    A round is as slow as the slowest device that actually exchanges
    messages (active AND has at least one active edge); clusters with
    no exchanging devices pay the baseline 1.0.
    """
    exchanging = np.asarray(device_up, bool) & (adj_active.sum(-1) > 0)
    mult = np.where(exchanging, delay_mult, 1.0)
    return mult.max(axis=1)


def uplink_tail_mults(delay_mult: np.ndarray, picks: np.ndarray,
                      counts: np.ndarray) -> np.ndarray:
    """Flat array of the sampled devices' own uplink multipliers."""
    out = []
    for c in range(picks.shape[0]):
        for j in range(counts[c]):
            out.append(delay_mult[c, picks[c, j]])
    return np.asarray(out) if out else np.ones((0,))


__all__ = [
    "aggregation_weights", "availability_sample", "consensus_tail_mult",
    "full_participation_weights", "renormalized_varrho",
    "uplink_tail_mults", "weighted_global_pytree",
]
