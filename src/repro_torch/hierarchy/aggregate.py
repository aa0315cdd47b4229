"""Per-level sampled aggregation as weight matrices — the port of
``repro/hierarchy/aggregate.py``: the host part is a numpy copy, the two
appliers at the end are torch.

Every tier of the fog hierarchy is expressed as ONE weight matrix, the
multi-level generalization of :mod:`repro_torch.netsim.faults` (which states
the flat eq. (7) as a single per-device weight matrix):

* **rep extraction** ``A: (N, s)`` — row c carries the within-cluster
  average weights of the devices sampled from cluster c (each sampled
  device gets ``1 / counts_c``); rows sum to 1, a dark cluster's row
  is 0. This is the per-cluster-normalized cousin of
  :func:`repro_torch.netsim.faults.aggregation_weights`.
* **tier l >= 1** ``G_l: (P_l, P_{l-1})`` — row p carries the
  base-mass weights of the live (tier >= 2: *sampled* live) children
  of parent p, renormalized to sum to 1; a parent whose whole subtree
  is dark has an all-zero row. Churned subtrees renormalize exactly
  like netsim's dark clusters: live children keep their full base
  mass, the dark mass is redistributed proportionally.

An aggregation event of depth d composes bottom-up to one **(I, I)
device matrix** ``M``: device i's post-event model is
``sum_j M[i, j] w_j``. Live rows (devices that hear the broadcast of a
live subtree) sum to 1; every other row is the identity row e_i —
hold-your-parameters, the same contract as
:func:`repro_torch.core.mixing.masked_consensus_matrix`. The fixed (I, I)
shape serves every aggregation depth with one step.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import HierarchyConfig
from repro_torch.hierarchy.tree import AggregationTree


# ---------------------------------------------------------------------------
# event calendar
# ---------------------------------------------------------------------------

def interval_depth(t: int, taus: tuple[int, ...]) -> int:
    """Deepest aggregation tier firing at iteration t (0 = none).

    Periods nest (``HierarchyConfig`` validates divisibility), so the
    firing tiers at any t are exactly 1..depth — a deeper aggregation
    always composes with every shallower one below it.
    """
    depth = 0
    for l, tau in enumerate(taus, start=1):
        if t > 0 and t % tau == 0:
            depth = l
    return depth


# ---------------------------------------------------------------------------
# per-level weight matrices (host side — numpy, like netsim.faults)
# ---------------------------------------------------------------------------

def rep_matrix(picks: np.ndarray, counts: np.ndarray,
               cluster_size: int) -> np.ndarray:
    """(N, k) availability-aware picks -> (N, s) rep-extraction weights.

    Row c averages the ``counts_c`` sampled devices of cluster c (the
    within-cluster mean of eq. (7) with multi-sampling); dark clusters
    get an all-zero row. Unlike
    :func:`repro_torch.netsim.faults.aggregation_weights` the rows are
    normalized per cluster — cross-cluster weighting happens one tier
    up, in the G matrices.
    """
    N, _ = picks.shape
    A = np.zeros((N, cluster_size))
    for c in range(N):
        if counts[c]:
            A[c, picks[c, :counts[c]]] = 1.0 / counts[c]
    return A


def live_levels(tree: AggregationTree, device_up: np.ndarray
                ) -> list[np.ndarray]:
    """Per-level subtree liveness: ``live[l][p]`` is True iff node p at
    level l has at least one available device in its subtree."""
    up = np.asarray(device_up, bool).reshape(tree.num_clusters,
                                             tree.cluster_size)
    live = [up.any(axis=1)]
    for l in range(tree.levels - 1):
        nxt = np.zeros(tree.node_counts[l + 1], bool)
        np.logical_or.at(nxt, tree.parent[l], live[l])
        live.append(nxt)
    return live


def sample_children(rng: np.random.Generator, live_child: np.ndarray,
                    parent_map: np.ndarray, num_parents: int,
                    k: int) -> list[np.ndarray]:
    """Per parent: min(k, live) children drawn uniformly WITHOUT
    replacement among its live ones (k = 0 -> all live children)."""
    out = []
    for p in range(num_parents):
        ch = np.flatnonzero((parent_map == p) & live_child)
        kc = len(ch) if k == 0 else min(k, len(ch))
        out.append(np.sort(rng.choice(ch, size=kc, replace=False))
                   if kc else np.empty(0, np.int64))
    return out


def child_matrix(tree: AggregationTree, level: int,
                 sampled: list[np.ndarray]) -> np.ndarray:
    """(P_level, P_{level-1}) tier weights over the sampled children.

    Each parent's row renormalizes the sampled children's BASE subtree
    masses to sum to 1 (dark/unsampled mass is redistributed
    proportionally — the multi-level analogue of
    :func:`repro_torch.netsim.faults.renormalized_varrho`); parents with no
    sampled live child get an all-zero row.
    """
    G = np.zeros((tree.node_counts[level], tree.node_counts[level - 1]))
    base = tree.mass[level - 1]
    for p, ch in enumerate(sampled):
        if len(ch):
            G[p, ch] = base[ch] / base[ch].sum()
    return G


# ---------------------------------------------------------------------------
# the composed aggregation event
# ---------------------------------------------------------------------------

@dataclass
class HierarchyEvent:
    """One multi-level aggregation event, fully resolved on the host.

    ``level_weights`` holds ``(A, G_1, ..., G_depth)``;
    ``device_matrix`` their (I, I) composition with hold-rows for
    devices that must not receive the broadcast; ``global_weights``
    the root's (I,) source weights — set only when the root fired.
    ``uplinks_by_level[l]`` counts the models actually entering tier
    l's aggregates: sampled devices at tier 1, sampled child nodes at
    tiers >= 2.
    """
    t: int
    depth: int
    picks: np.ndarray
    counts: np.ndarray
    level_weights: tuple[np.ndarray, ...]
    device_matrix: np.ndarray
    global_weights: Optional[np.ndarray]
    uplinks_by_level: dict[int, int]

    @property
    def total_uplinks(self) -> int:
        return sum(self.uplinks_by_level.values())


def build_event(rng: np.random.Generator, tree: AggregationTree,
                cfg: HierarchyConfig, t: int, device_up: np.ndarray,
                receive_offline: bool = False) -> Optional[HierarchyEvent]:
    """Resolve iteration t's aggregation event (None when no tier fires).

    ``device_up``: (N, s) availability — sampling draws only among
    available devices and dark subtrees renormalize away.
    ``receive_offline``: scale mode broadcasts to every replica in a
    live subtree (replicas are physical shards); simulation mode keeps
    offline devices' hold-your-parameters rows.
    """
    depth = interval_depth(t, cfg.taus)
    if depth == 0:
        return None
    from repro_torch.netsim.faults import availability_sample

    up = np.asarray(device_up, bool)
    N, s, I = tree.num_clusters, tree.cluster_size, tree.num_devices
    picks, counts = availability_sample(rng, up, k=cfg.sample[0])
    A = rep_matrix(picks, counts, s)
    live = live_levels(tree, up)

    # tier 1 aggregates ALL its live child clusters (the cross-cluster
    # sampling of eq. (7) is the device sampling already inside A)
    sampled1 = [np.flatnonzero((tree.parent[0] == p) & live[0])
                for p in range(tree.node_counts[1])]
    Gs = [child_matrix(tree, 1, sampled1)]
    uplinks = {1: int(counts.sum())}
    for l in range(2, depth + 1):
        sampled = sample_children(rng, live[l - 1], tree.parent[l - 1],
                                  tree.node_counts[l], cfg.sample[l - 1])
        uplinks[l] = int(sum(len(c) for c in sampled))
        Gs.append(child_matrix(tree, l, sampled))

    # compose top-down weights over clusters, then through A to devices
    W = Gs[0]
    for G in Gs[1:]:
        W = G @ W                               # (P_depth, N)
    S = (W[:, :, None] * A[None, :, :]).reshape(W.shape[0], I)

    anc = tree.device_ancestors(depth)          # (I,)
    up_flat = up.reshape(I)
    sub_live = S.sum(axis=1) > 0.0
    recv = sub_live[anc] & (receive_offline | up_flat)
    M = np.where(recv[:, None], S[anc], np.eye(I))

    return HierarchyEvent(
        t=t, depth=depth, picks=picks, counts=counts,
        level_weights=(A, *Gs),
        device_matrix=M.astype(np.float32),
        global_weights=(S[0].astype(np.float32)
                        if depth == cfg.levels - 1 else None),
        uplinks_by_level=uplinks)


# ---------------------------------------------------------------------------
# appliers (torch): outside any kernel in the reference as well, so plain
# products here
# ---------------------------------------------------------------------------

def apply_device_matrix_pytree(params: dict, M: torch.Tensor) -> dict:
    """params leaves (I, ...) -> new leaves (I, ...): one ``(I, I) @ (I,
    M)`` product per leaf against the composed event matrix. Hold-rows
    (e_i) are built into M, so the application is unconditional."""
    def one(leaf):
        I = leaf.shape[0]
        z = leaf.reshape(I, -1)
        out = torch.matmul(M.to(device=z.device, dtype=z.dtype), z)
        return out.reshape(leaf.shape).to(leaf.dtype)
    return {k: one(v) for k, v in params.items()}


def global_from_weights(params: dict, gw: torch.Tensor) -> dict:
    """Root model from its (I,) source weights: leaves (I, ...) -> (...)."""
    def one(leaf):
        I = leaf.shape[0]
        g = torch.matmul(gw.to(device=leaf.device, dtype=leaf.dtype),
                         leaf.reshape(I, -1))
        return g.reshape(leaf.shape[1:]).to(leaf.dtype)
    return {k: one(v) for k, v in params.items()}


__all__ = [
    "HierarchyEvent", "apply_device_matrix_pytree", "build_event",
    "child_matrix", "global_from_weights", "interval_depth",
    "live_levels", "rep_matrix", "sample_children",
]
