"""Aggregation-tree construction — a numpy copy of ``repro/hierarchy/
tree.py``.

Turns a :class:`~repro_torch.configs.base.HierarchyConfig` plus the cluster
tier of a :class:`~repro_torch.configs.base.TopologyConfig` into an explicit
:class:`AggregationTree`: per-level parent maps over contiguous blocks
(matching the scale-mode cluster == contiguous-replica-block
convention) and per-level subtree *mass* — the fraction of all devices
under each node, which generalizes the paper's cluster weights
varrho_c = s_c / I to every tier (``mass[0]`` IS varrho).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.configs.base import HierarchyConfig


def _auto_branching(num_clusters: int, levels: int) -> tuple[int, ...]:
    """Balance the intermediate fan-ins: each tier's branching factor is
    the divisor of the remaining node count closest to the geometric
    target ``remaining ** (1 / tiers_left)`` (and >= 2, so every tier
    actually coarsens)."""
    branching = []
    remaining = num_clusters
    for tier in range(levels - 2):
        tiers_left = (levels - 1) - tier
        target = remaining ** (1.0 / tiers_left)
        divisors = [d for d in range(2, remaining + 1) if remaining % d == 0]
        if not divisors:
            raise ValueError(
                f"cannot branch {remaining} nodes at tier {tier + 1} "
                f"(num_clusters={num_clusters}, levels={levels}): no "
                f"divisor >= 2 — pick num_clusters with enough factors")
        b = min(divisors, key=lambda d: abs(d - target))
        branching.append(b)
        remaining //= b
    return tuple(branching)


@dataclass
class AggregationTree:
    """The resolved L-level tree over N clusters of s devices.

    ``node_counts[l]`` — nodes at level l (node_counts[0] = N,
    node_counts[-1] = 1, the root).
    ``parent[l]`` — (node_counts[l],) int array mapping each level-l
    node to its level-(l+1) parent, for l = 0..L-2.
    ``mass[l]`` — (node_counts[l],) device-mass fraction of each
    subtree; sums to 1 at every level, and ``mass[0]`` equals the
    paper's varrho.
    """
    levels: int
    num_clusters: int
    cluster_size: int
    branching: tuple[int, ...]
    node_counts: tuple[int, ...]
    parent: tuple[np.ndarray, ...]
    mass: tuple[np.ndarray, ...]
    _cluster_anc: dict[int, np.ndarray] = field(default_factory=dict,
                                                repr=False)

    @property
    def num_devices(self) -> int:
        return self.num_clusters * self.cluster_size

    def children(self, level: int, node: int) -> np.ndarray:
        """Level-(level-1) children of one level-``level`` node."""
        return np.flatnonzero(self.parent[level - 1] == node)

    def ancestors(self, level: int) -> np.ndarray:
        """(N,) level-``level`` ancestor of every cluster (level 0 is
        the identity map)."""
        anc = self._cluster_anc.get(level)
        if anc is None:
            anc = np.arange(self.num_clusters)
            for l in range(level):
                anc = self.parent[l][anc]
            self._cluster_anc[level] = anc
        return anc

    def device_ancestors(self, level: int) -> np.ndarray:
        """(I,) level-``level`` ancestor of every device (devices are
        ordered cluster-major, matching the trainers' leading axis)."""
        return np.repeat(self.ancestors(level), self.cluster_size)


def build_tree(cfg: HierarchyConfig, num_clusters: int,
               cluster_size: int) -> AggregationTree:
    """Resolve the tree shape for a concrete cluster tier.

    Intermediate tiers group *contiguous* runs of child nodes (the
    scale-mode cluster == contiguous-replica-block convention carries
    up the tree); the root absorbs every remaining top-tier node.
    """
    branching = cfg.branching or _auto_branching(num_clusters, cfg.levels)
    if len(branching) != max(cfg.levels - 2, 0):
        raise ValueError(
            f"branching must cover the {cfg.levels - 2} intermediate "
            f"tiers, got {branching}")

    node_counts = [num_clusters]
    for b in branching:
        if node_counts[-1] % b:
            raise ValueError(
                f"branching {branching} does not divide {num_clusters} "
                f"clusters evenly (stuck at {node_counts[-1]} % {b})")
        node_counts.append(node_counts[-1] // b)
    node_counts.append(1)                      # the root
    if node_counts[-2] < 1:
        raise ValueError(f"tree over-coarsened: {node_counts}")

    parent = []
    for l in range(cfg.levels - 1):
        n_child, n_parent = node_counts[l], node_counts[l + 1]
        group = n_child // n_parent
        parent.append(np.repeat(np.arange(n_parent), group))

    # mass: uniform over equal clusters, summed up the tree
    mass = [np.full((num_clusters,), 1.0 / num_clusters)]
    for l in range(cfg.levels - 1):
        m = np.zeros(node_counts[l + 1])
        np.add.at(m, parent[l], mass[l])
        mass.append(m)

    return AggregationTree(
        levels=cfg.levels, num_clusters=num_clusters,
        cluster_size=cluster_size, branching=tuple(branching),
        node_counts=tuple(node_counts), parent=tuple(parent),
        mass=tuple(np.asarray(m) for m in mass))


__all__ = ["AggregationTree", "build_tree"]
