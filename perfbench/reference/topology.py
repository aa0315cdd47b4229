"""The D2D clusters of Sec. II-A, worked out again from the topology's
parameters: random geometric graphs in the unit square whose connection
radius is bisected until the clusters' mean spectral radius
rho(V - 11^T/s) is nearest its target (the paper's 0.7), or rings; and
Metropolis-Hastings consensus weights (Assumption 2)."""
from __future__ import annotations

import numpy as np


def ring(s: int) -> np.ndarray:
    a = np.zeros((s, s), bool)
    for i in range(s):
        j = (i + 1) % s
        if i != j:
            a[i, j] = a[j, i] = True
    return a


def connected(a: np.ndarray) -> bool:
    seen, todo = {0}, [0]
    while todo:
        for j in np.flatnonzero(a[todo.pop()]):
            if j not in seen:
                seen.add(int(j))
                todo.append(int(j))
    return len(seen) == a.shape[0]


def geometric(s: int, radius: float, rng: np.random.Generator) -> np.ndarray:
    """The first connected draw of 200; a ring if none is."""
    for _ in range(200):
        pts = rng.random((s, 2))
        d = np.linalg.norm(pts[:, None] - pts[None, :], axis=-1)
        a = (d < radius) & ~np.eye(s, dtype=bool)
        if connected(a):
            return a
    return ring(s)


def metropolis(a: np.ndarray) -> np.ndarray:
    deg = a.sum(1)
    v = np.where(a, 1.0 / (1.0 + np.maximum(deg[:, None], deg[None, :])),
                 0.0)
    np.fill_diagonal(v, 1.0 - v.sum(1))
    return v


def rho(v: np.ndarray) -> float:
    m = v - 1.0 / v.shape[0]
    return float(np.max(np.abs(np.linalg.eigvalsh((m + m.T) / 2))))


def clusters(num_clusters: int, cluster_size: int, graph: str,
             target: float = 0.7, seed: int = 0
             ) -> tuple[np.ndarray, np.ndarray]:
    """-> (adjacency (N, s, s) bool, V (N, s, s) float64)."""
    N, s = num_clusters, cluster_size
    if graph == "ring":
        adjs = np.stack([ring(s)] * N)
    elif graph == "geometric":
        rng = np.random.default_rng(seed)
        lo, hi = 0.3, 1.5
        best, best_err = None, np.inf
        for _ in range(12):
            mid = 0.5 * (lo + hi)
            trial = np.random.default_rng(rng.integers(2**31))
            adjs = np.stack([geometric(s, mid, trial) for _ in range(N)])
            r = float(np.mean([rho(metropolis(a)) for a in adjs]))
            if abs(r - target) < best_err:
                best, best_err = adjs, abs(r - target)
            if r > target:
                lo = mid
            else:
                hi = mid
        adjs = best
    else:
        raise ValueError(f"unknown graph {graph!r}")
    return adjs, np.stack([metropolis(a) for a in adjs])
