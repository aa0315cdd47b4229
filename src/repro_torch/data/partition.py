"""Federated partitioners (Sec. IV-A: non-iid, 3 labels per device)."""
from __future__ import annotations

import numpy as np

from repro_torch.data.synth import FederatedDataset


def partition_noniid_labels(x: np.ndarray, y: np.ndarray, num_devices: int,
                            labels_per_device: int = 3, seed: int = 0,
                            points_per_device: int | None = None,
                            ) -> FederatedDataset:
    """Each device draws only from ``labels_per_device`` classes, with the
    class triplets rotated across devices (paper Sec. IV-A)."""
    rng = np.random.default_rng(seed)
    num_classes = int(y.max()) + 1
    by_class = [np.flatnonzero(y == c) for c in range(num_classes)]
    for idx in by_class:
        rng.shuffle(idx)
    ptrs = [0] * num_classes

    if points_per_device is None:
        points_per_device = len(y) // num_devices
    per_label = points_per_device // labels_per_device

    xs, ys = [], []
    for i in range(num_devices):
        labels = [(i + j) % num_classes for j in range(labels_per_device)]
        xi, yi = [], []
        for c in labels:
            idx = by_class[c]
            take = idx[np.mod(np.arange(ptrs[c], ptrs[c] + per_label),
                              len(idx))]
            ptrs[c] += per_label
            xi.append(x[take])
            yi.append(y[take])
        xi = np.concatenate(xi)
        yi = np.concatenate(yi)
        perm = rng.permutation(len(yi))
        xs.append(xi[perm])
        ys.append(yi[perm])

    D = min(len(v) for v in ys)
    xs = np.stack([v[:D] for v in xs]).astype(np.float32)
    ys = np.stack([v[:D] for v in ys]).astype(np.int32)
    counts = np.full((num_devices,), D, np.int32)
    return FederatedDataset(xs, ys, counts, num_classes)


def partition_iid(x: np.ndarray, y: np.ndarray, num_devices: int,
                  seed: int = 0,
                  points_per_device: int | None = None) -> FederatedDataset:
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(y))
    x, y = x[perm], y[perm]
    if points_per_device is None:
        points_per_device = len(y) // num_devices
    D = points_per_device
    xs = np.stack([x[i * D:(i + 1) * D] for i in range(num_devices)])
    ys = np.stack([y[i * D:(i + 1) * D] for i in range(num_devices)])
    counts = np.full((num_devices,), D, np.int32)
    return FederatedDataset(xs.astype(np.float32), ys.astype(np.int32),
                            counts, int(y.max()) + 1)
