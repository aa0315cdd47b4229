"""Time-varying consensus topology (DESIGN.md §8).

:class:`TimeVaryingNetwork` sits between ``core/topology.py`` (the base
graphs tuned at build time) and the trainers. At each iteration it
masks the base adjacency with the live edge/device set from the
:class:`~repro_torch.netsim.events.EventStream` and rebuilds every cluster's
consensus matrix *on the active subgraph* so the Assumption-2 contract
holds per event:

* a dropped device is isolated — its row of ``V`` is the identity row
  ``e_i``, so a consensus step leaves its parameters untouched;
* active devices get fresh Metropolis (or Laplacian) weights over the
  *active* edges only — they mix exclusively among themselves;
* ``lambdas`` are recomputed per event as the max contraction factor
  over the connected components of the active subgraph, so the
  Remark-1 adaptive-gamma rule sees degraded connectivity and responds.
  A disconnected active subgraph degrades gracefully: consensus reaches
  agreement *within* each component (singleton components — including
  every dropped device — contribute a factor of 0).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.configs.base import DynamicsConfig
from repro_torch.core.topology import (
    Network, laplacian_weights, metropolis_weights, spectral_radius)
from repro_torch.netsim.events import EventStream, NetworkEvent
from repro_torch.netsim.faults import renormalized_varrho


# ---------------------------------------------------------------------------
# active-subgraph helpers
# ---------------------------------------------------------------------------

def connected_components(adj: np.ndarray) -> list[np.ndarray]:
    """Index arrays of the components of one (s, s) adjacency."""
    s = adj.shape[0]
    unseen = set(range(s))
    comps = []
    while unseen:
        start = unseen.pop()
        comp, frontier = {start}, [start]
        while frontier:
            i = frontier.pop()
            for j in np.flatnonzero(adj[i]):
                if j in unseen:
                    unseen.discard(j)
                    comp.add(j)
                    frontier.append(j)
        comps.append(np.array(sorted(comp)))
    return comps


def component_spectral_radius(v: np.ndarray, adj: np.ndarray) -> float:
    """Max over components of rho(V|_comp - 11^T/|comp|).

    This is the per-event contraction factor: each consensus round
    contracts the disagreement *within* every component by at least
    this much (singletons contribute 0 — nothing to contract). Always
    < 1, unlike the global rho which pins at 1 when disconnected.
    """
    worst = 0.0
    for comp in connected_components(adj):
        if len(comp) < 2:
            continue
        sub = v[np.ix_(comp, comp)]
        worst = max(worst, spectral_radius(sub))
    return worst


def power_iteration_radius(v: np.ndarray, adj: np.ndarray,
                           iters: int = 40, seed: int = 0) -> float:
    """Power-iteration *estimate* of :func:`component_spectral_radius`.

    Same quantity — max over the active subgraph's connected components
    of rho(V|_comp - 11^T/|comp|) — but measured the way a deployed
    controller could measure it: repeated local averaging rounds
    (multiplying by V is exactly one gossip exchange) on a seeded
    random vector, with the consensus direction deflated by mean
    subtraction. No eigendecomposition oracle; the estimate is a lower
    bound that converges geometrically in ``iters``, so decisions made
    on it under-mix by a vanishing margin (the Γ laws clamp upward).

    Deterministic in ``(v, adj, iters, seed)``. Singleton components
    contribute 0, matching the exact calculator.
    """
    rng = np.random.default_rng(seed)
    worst = 0.0
    for comp in connected_components(adj):
        n = len(comp)
        if n < 2:
            continue
        sub = np.asarray(v[np.ix_(comp, comp)], np.float64)
        x = rng.standard_normal(n)
        x -= x.mean()
        nrm = np.linalg.norm(x)
        if nrm < 1e-30:
            continue
        x /= nrm
        est = 0.0
        for _ in range(iters):
            y = sub @ x
            y -= y.mean()          # deflate the consensus eigenvector
            nrm = np.linalg.norm(y)
            if nrm < 1e-30:        # contraction annihilated x: rho ~ 0
                est = 0.0
                break
            est = nrm              # ||B x|| / ||x|| Rayleigh-style step
            x = y / nrm
        worst = max(worst, float(est))
    return worst


def measured_lambdas(V: np.ndarray, adj: np.ndarray,
                     iters: int = 40, seed: int = 0) -> np.ndarray:
    """Per-cluster power-iteration contraction estimates.

    V: (N, s, s) consensus matrices, adj: (N, s, s) active adjacency
    -> (N,) float64. Cluster c's estimate is seeded with ``seed + c``
    so estimates are independent but the whole vector is deterministic.
    """
    V = np.asarray(V)
    adj = np.asarray(adj)
    return np.array([
        power_iteration_radius(V[c], adj[c], iters=iters, seed=seed + c)
        for c in range(V.shape[0])])


def masked_cluster_weights(adj_active: np.ndarray, device_up: np.ndarray,
                           scheme: str = "metropolis") -> np.ndarray:
    """Consensus weights for one cluster's ACTIVE subgraph.

    ``adj_active`` must already exclude edges incident to a down
    device. Down devices have degree 0, so both schemes naturally give
    them the identity row (hold-your-parameters semantics).
    """
    a = adj_active & device_up[:, None] & device_up[None, :]
    if scheme == "metropolis":
        return metropolis_weights(a)
    if scheme == "laplacian":
        return laplacian_weights(a)
    raise ValueError(f"unknown weight scheme {scheme!r}")


def check_masked_assumption2(v: np.ndarray, adj_active: np.ndarray,
                             device_up: np.ndarray,
                             atol: float = 1e-9,
                             component_rho: float | None = None) -> None:
    """Assumption 2 relaxed to the active subgraph (DESIGN.md §8).

    (i) sparsity matches the active edges, (ii) rows sum to 1,
    (iii) symmetric, (iv) every *component's* contraction factor < 1,
    (v) down-device rows are exactly e_i.

    ``component_rho``: pass a precomputed
    :func:`component_spectral_radius` to avoid re-running the
    eigendecomposition (the per-event hot loop does).
    """
    s = v.shape[0]
    a = adj_active & device_up[:, None] & device_up[None, :]
    offdiag = ~np.eye(s, dtype=bool)
    assert np.all(np.abs(v[offdiag & ~a]) < atol), "sparsity violated"
    assert np.allclose(v.sum(1), 1.0, atol=atol), "rows must sum to 1"
    assert np.allclose(v, v.T, atol=atol), "V must be symmetric"
    if component_rho is None:
        component_rho = component_spectral_radius(v, a)
    assert component_rho < 1.0 - 1e-12, \
        "component contraction must be < 1"
    for i in np.flatnonzero(~device_up):
        want = np.zeros(s)
        want[i] = 1.0
        assert np.allclose(v[i], want, atol=atol), \
            f"down device {i} must hold its parameters"


# ---------------------------------------------------------------------------
# snapshots
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class NetworkSnapshot:
    """The consensus network at one iteration.

    V/adj/lambdas mirror :class:`~repro_torch.core.topology.Network` but are
    recomputed on the active subgraph; ``varrho`` is renormalized over
    the available devices (a fully-dark cluster gets weight 0).
    """
    t: int
    V: np.ndarray             # (N, s, s) float32
    adj: np.ndarray           # (N, s, s) bool — active edges
    device_up: np.ndarray     # (N, s) bool
    lambdas: np.ndarray       # (N,) component-wise contraction factors
    delay_mult: np.ndarray    # (N, s) straggler multipliers
    varrho: np.ndarray        # (N,) availability-renormalized weights

    @property
    def active_per_cluster(self) -> np.ndarray:
        return self.device_up.sum(axis=1)

    def num_active_edges(self) -> np.ndarray:
        return self.adj.sum((1, 2)) // 2

    def measured_lambdas(self, iters: int = 40,
                         seed: int = 0) -> np.ndarray:
        """Power-iteration connectivity estimates on THIS event's
        active subgraph — the measured counterpart of the exact
        ``lambdas`` field (``repro_torch.control`` decides on these; obs
        logs measured-vs-assumed side by side)."""
        return measured_lambdas(self.V, self.adj, iters=iters,
                                seed=seed + int(self.t))


class TimeVaryingNetwork:
    """A :class:`Network` animated by an :class:`EventStream`.

    ``snapshot(t)`` is deterministic in ``(base network, cfg, t)`` and
    cached per iteration; trainers typically query it only at consensus
    and aggregation steps (the stream still advances its chains through
    the skipped iterations, so the sample path does not depend on the
    event calendar).
    """

    def __init__(self, base: Network, cfg: DynamicsConfig,
                 weights: str = "metropolis"):
        self.base = base
        self.cfg = cfg
        self.weights = weights
        self.events = EventStream(cfg, base.adj)
        self._cache: dict[int, NetworkSnapshot] = {}

    def snapshot(self, t: int) -> NetworkSnapshot:
        snap = self._cache.get(t)
        if snap is None:
            snap = self._build(self.events.at(t))
            self._cache.clear()         # trainers walk forward; keep 1
            self._cache[t] = snap
        return snap

    def _build(self, ev: NetworkEvent) -> NetworkSnapshot:
        base = self.base
        up = ev.device_up
        adj = (base.adj & ev.link_up
               & up[:, :, None] & up[:, None, :])
        V = np.empty_like(base.V, np.float32)
        lambdas = np.empty((base.num_clusters,))
        for c in range(base.num_clusters):
            v = masked_cluster_weights(adj[c], up[c], self.weights)
            lam = component_spectral_radius(v, adj[c])
            check_masked_assumption2(v, adj[c], up[c], component_rho=lam)
            V[c] = v.astype(np.float32)
            lambdas[c] = lam
        varrho = renormalized_varrho(up, base.varrho)
        return NetworkSnapshot(
            t=ev.t, V=V, adj=adj, device_up=up, lambdas=lambdas,
            delay_mult=ev.delay_mult, varrho=varrho.astype(np.float32))


__all__ = [
    "NetworkSnapshot", "TimeVaryingNetwork", "check_masked_assumption2",
    "component_spectral_radius", "connected_components",
    "masked_cluster_weights", "measured_lambdas",
    "power_iteration_radius",
]
