"""Synthetic Fashion-MNIST analogue (offline container: no downloads).

``fashion_synth`` generates a 10-class, 784-dim image-like dataset from
class-conditional low-rank Gaussians + structured templates. It matches
Fashion-MNIST's shape/cardinality so the paper's experiment configs
(I=125 devices, 3-labels-per-device non-iid splits) transfer verbatim,
and is hard enough that a linear SVM does not saturate instantly.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class FederatedDataset:
    """Per-device data after partitioning.

    x: (I, D_i, m) float32 — padded per-device datasets
    y: (I, D_i) int32 — labels
    counts: (I,) int32 — true per-device counts (<= D_i pad size)
    """
    x: np.ndarray
    y: np.ndarray
    counts: np.ndarray
    num_classes: int

    @property
    def num_devices(self) -> int:
        return self.x.shape[0]

    @property
    def feature_dim(self) -> int:
        return self.x.shape[-1]


def fashion_synth(num_points: int = 70_000, dim: int = 784,
                  num_classes: int = 10, rank: int = 24,
                  noise: float = 0.35, seed: int = 0,
                  unit_norm: bool = False,
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Class-conditional low-rank Gaussian images.

    Each class c has a template mu_c (smooth random field) and a shared
    low-rank factor basis; samples are
    x = mu_c + B @ z + noise * eps, clipped to [0, 1] like pixel data.
    """
    rng = np.random.default_rng(seed)
    side = int(np.sqrt(dim))
    assert side * side == dim, "dim must be a perfect square"

    # smooth class templates: filtered random fields
    templates = []
    for c in range(num_classes):
        field = rng.normal(size=(side, side))
        # cheap smoothing: two passes of 3x3 box filter
        for _ in range(3):
            f = np.pad(field, 1, mode="edge")
            field = (
                f[:-2, :-2] + f[:-2, 1:-1] + f[:-2, 2:] +
                f[1:-1, :-2] + f[1:-1, 1:-1] + f[1:-1, 2:] +
                f[2:, :-2] + f[2:, 1:-1] + f[2:, 2:]) / 9.0
        field = (field - field.min()) / (np.ptp(field) + 1e-9)
        templates.append(field.reshape(-1))
    templates = np.stack(templates)          # (C, dim)

    basis = rng.normal(size=(dim, rank)) / np.sqrt(rank)
    y = rng.integers(0, num_classes, size=num_points).astype(np.int32)
    z = rng.normal(size=(num_points, rank)).astype(np.float32) * 0.5
    eps = rng.normal(size=(num_points, dim)).astype(np.float32)
    x = templates[y] + z @ basis.T.astype(np.float32) + noise * eps
    x = np.clip(x, 0.0, 1.0).astype(np.float32)
    if unit_norm:
        # unit-L2 rows: bounds the squared-hinge smoothness beta to O(1),
        # making the Theorem-2 parameter conditions exactly satisfiable
        x = x / (np.linalg.norm(x, axis=1, keepdims=True) + 1e-9)
    return x, y
