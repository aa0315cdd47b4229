"""Online estimators feeding the control laws — a copy of ``repro/
control/estimator.py``.

:class:`OnlineGradStats` turns the two empirical constant estimators
of ``core/theory.py`` — :func:`~repro_torch.core.theory.
estimate_gradient_diversity` (δ) and :func:`~repro_torch.core.theory.
estimate_sgd_noise` (σ) — into *online* gauges: the trainer hands the
controller per-cluster mean gradients and repeated minibatch draws at
aggregation boundaries, and the estimators run over a sliding window
of those observations. They deliberately call the theory functions
(not re-derivations), so the closed-form Gaussian unit tests pin the
whole path.

Connectivity estimation lives in ``netsim/dynamics.py``
(:func:`~repro_torch.netsim.dynamics.measured_lambdas`); this module only
adds the static-topology convenience wrapper so the controller has
one call for either case.
"""
from __future__ import annotations

import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np

from repro_torch.core import theory
from repro_torch.netsim.dynamics import measured_lambdas


class OnlineGradStats:
    """Sliding-window δ̂ / σ̂ estimates from trainer observations.

    ``observe_clusters`` takes one round's (N, M) per-cluster mean
    gradients (all at the same global iterate) plus the aggregation
    weights ϱ; δ̂ is ``estimate_gradient_diversity`` over the stacked
    (T, N, M) window. ``observe_noise`` takes one device's (K, M)
    repeated minibatch gradients and its (M,) full-batch gradient;
    σ̂ is the RMS of the window of per-device
    ``estimate_sgd_noise`` values (σ bounds E‖ĝ−∇F_i‖² for EVERY
    device, so the estimates pool across devices and rounds).

    At the paper's width a round is 1.25 GB of float64 cluster means and
    12.5 GB of draws, so the port computes each round's share of δ̂ once,
    when it is observed (δ̂ is the largest over the window of each
    round's ``estimate_gradient_diversity``, the same value the stacked
    call gives), and the per-device σ values on threads (numpy releases
    the interpreter lock): the same arithmetic as the reference's, in
    the same order.
    """

    def __init__(self, window: int = 8):
        assert window >= 2, "diversity needs at least two iterates"
        self._clusters: deque = deque(maxlen=window)
        self._devs: deque = deque(maxlen=window)   # each round's δ
        self._noise: deque = deque(maxlen=window * 4)
        self._varrho: Optional[np.ndarray] = None
        self.rounds_observed = 0

    # -- gradient diversity δ ------------------------------------------
    def observe_clusters(self, cluster_grads: np.ndarray,
                         varrho: np.ndarray) -> None:
        g = np.asarray(cluster_grads, np.float64)
        varrho = np.asarray(varrho, np.float64)
        if self._varrho is not None and not np.array_equal(varrho,
                                                           self._varrho):
            # the whole window is weighed with the latest varrho
            self._devs = deque(
                (theory.estimate_gradient_diversity(c[None], varrho)
                 for c in self._clusters), maxlen=self._devs.maxlen)
        self._clusters.append(g)
        self._devs.append(theory.estimate_gradient_diversity(g[None],
                                                             varrho))
        self._varrho = varrho
        self.rounds_observed += 1

    @property
    def delta_hat(self) -> Optional[float]:
        if not self._devs:
            return None
        return max(self._devs)

    # -- SGD noise σ ---------------------------------------------------
    def observe_noise(self, sample_grads: np.ndarray,
                      full_grad: np.ndarray) -> None:
        self._noise.append(theory.estimate_sgd_noise(
            np.asarray(sample_grads), np.asarray(full_grad)))

    def observe_fleet_noise(self, sample_grads: np.ndarray,
                            full_grads: np.ndarray) -> None:
        """(I, K, M) draws + (I, M) full gradients: one
        ``estimate_sgd_noise`` per device, pooled into the window in
        device order."""
        workers = min(8, os.cpu_count() or 1)
        with ThreadPoolExecutor(max_workers=workers) as pool:
            self._noise.extend(pool.map(
                theory.estimate_sgd_noise, np.asarray(sample_grads),
                np.asarray(full_grads)))

    @property
    def sigma_hat(self) -> Optional[float]:
        if not self._noise:
            return None
        return float(np.sqrt(np.mean(np.square(self._noise))))

    # -- constants for the laws ----------------------------------------
    def constants(self, base: theory.ProblemConstants
                  ) -> theory.ProblemConstants:
        """``base`` with σ/δ replaced by the measured values when
        available — what the τ law scores with."""
        d, s = self.delta_hat, self.sigma_hat
        return theory.ProblemConstants(
            mu=base.mu, beta=base.beta,
            sigma=s if s is not None else base.sigma,
            delta=d if d is not None else base.delta,
            varrho_min=base.varrho_min)


def static_measured_lambdas(net, iters: int = 40,
                            seed: int = 0) -> np.ndarray:
    """Power-iteration contraction estimates on a static
    :class:`~repro_torch.core.topology.Network` — the no-churn counterpart
    of :meth:`~repro_torch.netsim.dynamics.NetworkSnapshot.measured_lambdas`.
    """
    return measured_lambdas(np.asarray(net.V), np.asarray(net.adj),
                            iters=iters, seed=seed)


__all__ = ["OnlineGradStats", "static_measured_lambdas"]
