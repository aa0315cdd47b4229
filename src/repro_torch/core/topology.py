"""Cluster topologies and consensus matrices (Sec. II-A, Assumption 2).

Builds the D2D graphs G_c and consensus matrices V_c:

* random geometric graphs (paper Sec. IV-A), with the connection radius
  tuned so the average spectral radius rho(V_c - 11^T/s_c) hits a target
  (the paper uses 0.7);
* ring graphs (the TPU-native default in scale mode — ICI neighbours);
* complete graphs (fastest mixing, 1 round suffices with uniform weights).

Weights satisfy Assumption 2: (i) sparsity matches E_c, (ii) row sums 1,
(iii) symmetric, (iv) rho(V - 11^T/s) < 1 (for connected G).
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass

import numpy as np

from repro_torch.configs.base import TopologyConfig


# ---------------------------------------------------------------------------
# graph generators -> adjacency (s, s) bool, no self loops
# ---------------------------------------------------------------------------

def ring_adjacency(s: int) -> np.ndarray:
    a = np.zeros((s, s), bool)
    for i in range(s):
        a[i, (i + 1) % s] = a[(i + 1) % s, i] = True
    if s == 2:
        a[0, 1] = a[1, 0] = True
    return a


def complete_adjacency(s: int) -> np.ndarray:
    a = np.ones((s, s), bool)
    np.fill_diagonal(a, False)
    return a


def geometric_adjacency(s: int, radius: float,
                        rng: np.random.Generator,
                        fallback_counter: list | None = None) -> np.ndarray:
    """Random geometric graph in the unit square; re-draws until connected.

    If 200 draws never produce a connected graph (the radius is too
    small for s points) we fall back to a ring — which is NOT a
    geometric graph and has a very different spectral radius, so the
    fallback is loud: a ``RuntimeWarning`` is emitted and, when the
    caller passes a ``fallback_counter`` list, an entry is appended so
    :func:`build_network` can surface the count on the
    :class:`Network` (``geometric_fallbacks``)."""
    for _ in range(200):
        pts = rng.random((s, 2))
        d = np.linalg.norm(pts[:, None] - pts[None, :], axis=-1)
        a = (d < radius) & ~np.eye(s, dtype=bool)
        if _connected(a):
            return a
    warnings.warn(
        f"geometric_adjacency: no connected graph in 200 draws "
        f"(s={s}, radius={radius:.3f}); falling back to a ring — the "
        f"tuned spectral radius will NOT match the geometric target",
        RuntimeWarning, stacklevel=2)
    if fallback_counter is not None:
        fallback_counter.append((s, radius))
    return ring_adjacency(s)


def _connected(a: np.ndarray) -> bool:
    s = a.shape[0]
    seen = {0}
    frontier = [0]
    while frontier:
        i = frontier.pop()
        for j in np.flatnonzero(a[i]):
            if j not in seen:
                seen.add(j)
                frontier.append(j)
    return len(seen) == s


# ---------------------------------------------------------------------------
# consensus weights (Assumption 2)
# ---------------------------------------------------------------------------

def metropolis_weights(adj: np.ndarray) -> np.ndarray:
    """Metropolis–Hastings: v_ij = 1/(1+max(d_i,d_j)), v_ii = 1 - sum."""
    deg = adj.sum(1)
    s = adj.shape[0]
    v = np.zeros((s, s))
    for i in range(s):
        for j in range(s):
            if adj[i, j]:
                v[i, j] = 1.0 / (1.0 + max(deg[i], deg[j]))
    np.fill_diagonal(v, 1.0 - v.sum(1))
    return v


def laplacian_weights(adj: np.ndarray, eps: float | None = None) -> np.ndarray:
    """V = I - eps * L with eps < 1/d_max (Xiao & Boyd 2004)."""
    deg = adj.sum(1)
    L = np.diag(deg) - adj.astype(float)
    if eps is None:
        eps = 1.0 / (deg.max() + 1.0)
    return np.eye(adj.shape[0]) - eps * L


def spectral_radius(v: np.ndarray) -> float:
    """rho(V - 11^T/s): the consensus contraction factor lambda_c."""
    s = v.shape[0]
    m = v - np.ones((s, s)) / s
    return float(np.max(np.abs(np.linalg.eigvalsh((m + m.T) / 2))))


def check_assumption2(v: np.ndarray, adj: np.ndarray,
                      atol: float = 1e-9) -> None:
    s = v.shape[0]
    offdiag = ~np.eye(s, dtype=bool)
    assert np.all(np.abs(v[offdiag & ~adj]) < atol), "sparsity violated"
    assert np.allclose(v.sum(1), 1.0, atol=atol), "rows must sum to 1"
    assert np.allclose(v, v.T, atol=atol), "V must be symmetric"
    assert spectral_radius(v) < 1.0 - 1e-12, "rho(V - 11^T/s) must be < 1"


# ---------------------------------------------------------------------------
# network assembly
# ---------------------------------------------------------------------------

@dataclass
class Network:
    """The full edge network: N equal clusters of s devices.

    V: (N, s, s) stacked consensus matrices
    adj: (N, s, s) adjacencies
    lambdas: (N,) spectral radii rho(V_c - 11^T/s)
    """
    V: np.ndarray
    adj: np.ndarray
    lambdas: np.ndarray
    num_clusters: int
    cluster_size: int
    # how many clusters of the CHOSEN adjacency set came from the
    # ring fallback of geometric_adjacency (0 for non-geometric graphs
    # and healthy geometric draws) — experiments can detect a corrupted
    # spectral-radius tuning instead of silently trusting it
    geometric_fallbacks: int = 0

    @property
    def num_devices(self) -> int:
        return self.num_clusters * self.cluster_size

    @property
    def varrho(self) -> np.ndarray:
        """Cluster weights varrho_c = s_c / I (uniform: equal clusters)."""
        return np.full((self.num_clusters,),
                       self.cluster_size / self.num_devices)

    def num_d2d_edges(self) -> np.ndarray:
        return self.adj.sum((1, 2)) // 2


def _weights_for(adj: np.ndarray, scheme: str) -> np.ndarray:
    if scheme == "metropolis":
        return metropolis_weights(adj)
    if scheme == "laplacian":
        return laplacian_weights(adj)
    raise ValueError(f"unknown weight scheme {scheme!r}")


def build_network(cfg: TopologyConfig) -> Network:
    """Build N clusters; for geometric graphs, tune the radius so the
    average rho(V_c - 11^T/s) approaches ``cfg.target_spectral_radius``."""
    rng = np.random.default_rng(cfg.seed)
    N, s = cfg.num_clusters, cfg.cluster_size

    fallbacks = 0
    if cfg.graph == "ring":
        adjs = np.stack([ring_adjacency(s) for _ in range(N)])
    elif cfg.graph == "complete":
        adjs = np.stack([complete_adjacency(s) for _ in range(N)])
    elif cfg.graph == "geometric":
        adjs, fallbacks = _tuned_geometric(N, s, cfg.target_spectral_radius,
                                           cfg.weights, rng)
    else:
        raise ValueError(f"unknown graph {cfg.graph!r}")

    V = np.stack([_weights_for(a, cfg.weights) for a in adjs])
    for v, a in zip(V, adjs):
        check_assumption2(v, a)
    lambdas = np.array([spectral_radius(v) for v in V])
    return Network(V=V.astype(np.float32), adj=adjs, lambdas=lambdas,
                   num_clusters=N, cluster_size=s,
                   geometric_fallbacks=fallbacks)


def _tuned_geometric(N: int, s: int, target: float, scheme: str,
                     rng: np.random.Generator) -> tuple[np.ndarray, int]:
    """Bisection on the connection radius to match the average spectral
    radius (paper: 'tuned such that clusters have an average spectral
    radius of rho = 0.7'). Returns (adjacencies, ring-fallback count
    among the CHOSEN adjacencies)."""
    lo, hi = 0.3, 1.5   # radius range: sparse ... complete

    def avg_rho(radius: float, trial_rng
                ) -> tuple[float, np.ndarray, int]:
        counter: list = []
        adjs = np.stack([geometric_adjacency(s, radius, trial_rng,
                                             fallback_counter=counter)
                         for _ in range(N)])
        rhos = [spectral_radius(_weights_for(a, scheme)) for a in adjs]
        return float(np.mean(rhos)), adjs, len(counter)

    best_adjs, best_err, best_fb = None, np.inf, 0
    for _ in range(12):
        mid = 0.5 * (lo + hi)
        rho, adjs, fb = avg_rho(mid,
                                np.random.default_rng(rng.integers(2**31)))
        err = abs(rho - target)
        if err < best_err:
            best_err, best_adjs, best_fb = err, adjs, fb
        # denser graph (larger radius) -> faster mixing -> smaller rho
        if rho > target:
            lo = mid
        else:
            hi = mid
    return best_adjs, best_fb
