"""Convergence-theory calculators (Sec. III).

Implements, symbol-for-symbol, the quantities of Proposition 1 and
Theorem 2 so experiments can (a) check the tunable-parameter conditions
and (b) overlay the analytic bound nu/(t+alpha) on measured loss gaps.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class ProblemConstants:
    """Loss-landscape and noise constants (Assumptions 1, 3, Def. 1)."""
    mu: float            # strong convexity of F
    beta: float          # smoothness of every F_i
    sigma: float         # SGD noise std bound
    delta: float         # gradient diversity bound
    varrho_min: float    # min_c varrho_c


def check_theorem2_conditions(k: ProblemConstants, gamma: float,
                              alpha: float) -> dict[str, bool]:
    """gamma > 1/mu and alpha >= gamma * beta^2 / mu (Thm 2)."""
    return {
        "gamma_gt_inv_mu": gamma > 1.0 / k.mu,
        "alpha_ge_gamma_beta2_over_mu": alpha >= gamma * k.beta ** 2 / k.mu,
        "eta0_le_mu_over_beta2": gamma / alpha <= k.mu / k.beta ** 2 + 1e-12,
    }


def sigma_t(k: ProblemConstants, gamma: float, alpha: float, tau: int,
            t: int, t_prev_agg: int) -> float:
    """Sigma_t = sum_{l=t_{k-1}}^{t-1} beta*eta_l prod_{j=l+1}^{t-1}
    (1 + 2 eta_j beta)   (Proposition 1)."""
    def eta(j):
        return gamma / (j + alpha)
    total = 0.0
    for ell in range(t_prev_agg, t):
        prod = 1.0
        for j in range(ell + 1, t):
            prod *= 1.0 + 2.0 * eta(j) * k.beta
        total += k.beta * eta(ell) * prod
    return total


def dispersion_bound(k: ProblemConstants, gamma: float, alpha: float,
                     tau: int, t: int, t_prev_agg: int,
                     eps0: float) -> float:
    """Proposition 1 RHS: bound on A^(t)."""
    s = sigma_t(k, gamma, alpha, tau, t, t_prev_agg)
    return (12.0 / k.varrho_min) * s ** 2 * (
        k.sigma ** 2 / k.beta ** 2 + k.delta ** 2 / k.beta ** 2 + eps0 ** 2)


def theorem2_Z(k: ProblemConstants, gamma: float, alpha: float, tau: int,
               phi: float) -> float:
    """Z from Theorem 2."""
    if tau <= 1:
        cluster_term = 0.0
    else:
        cluster_term = (
            24.0 / k.varrho_min * k.beta * gamma * (tau - 1)
            * (1.0 + (tau - 2) / alpha)
            * (1.0 + (tau - 1) / (alpha - 1.0)) ** (4.0 * k.beta * gamma)
            * (k.sigma ** 2 / k.beta + phi ** 2 / k.beta
               + k.delta ** 2 / k.beta))
    return 0.5 * (k.sigma ** 2 / k.beta + 2.0 * phi ** 2 / k.beta) \
        + cluster_term


def theorem2_nu(k: ProblemConstants, gamma: float, alpha: float, tau: int,
                phi: float, initial_gap: float) -> float:
    """nu = max{ beta^2 gamma^2 Z / (mu gamma - 1),
                 alpha * (F(w0) - F*) }   (Theorem 2)."""
    conds = check_theorem2_conditions(k, gamma, alpha)
    if not conds["gamma_gt_inv_mu"]:
        raise ValueError("Theorem 2 requires gamma > 1/mu")
    z = theorem2_Z(k, gamma, alpha, tau, phi)
    return max(k.beta ** 2 * gamma ** 2 * z / (k.mu * gamma - 1.0),
               alpha * initial_gap)


def bound_curve(nu: float, alpha: float, ts: np.ndarray) -> np.ndarray:
    """The O(1/t) envelope nu / (t + alpha)."""
    return nu / (np.asarray(ts, float) + alpha)


def lemma1_bound(lambda_c: float, gamma_rounds: int, s_c: int,
                 upsilon: float, model_dim: int) -> float:
    """Lemma 1: ||e_i|| <= lambda^Gamma * s_c * Upsilon * M."""
    return (lambda_c ** gamma_rounds) * s_c * upsilon * model_dim


# ---------------------------------------------------------------------------
# empirical estimators for the constants (used by experiments to
# instantiate the bound on real runs)
# ---------------------------------------------------------------------------

def estimate_gradient_diversity(cluster_grads: np.ndarray,
                                varrho: np.ndarray) -> float:
    """delta >= max_c || grad F_c - grad F ||, estimated at a set of
    iterates. cluster_grads: (T, N, M)."""
    g = np.asarray(cluster_grads)
    global_g = np.einsum("c,tcm->tm", varrho, g)
    dev = np.linalg.norm(g - global_g[:, None], axis=-1)
    return float(dev.max())


def estimate_sgd_noise(sample_grads: np.ndarray,
                       full_grad: np.ndarray) -> float:
    """sigma^2 >= E||ghat - gradF_i||^2 estimate from repeated draws."""
    d = sample_grads - full_grad[None]
    return float(np.sqrt((d * d).sum(-1).mean()))
