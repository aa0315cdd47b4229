"""Pure control laws — numpy in, numpy out; a copy of ``repro/control/
laws.py``.

Every retuning decision the online controller makes reduces to one of
three stateless laws, kept free of trainer/resolver plumbing so they
are unit-testable against the paper's closed forms:

* :func:`remark1_gamma` — the Remark-1 aperiodic D2D round rule,
  numerically identical to :func:`repro_torch.core.schedule.adaptive_gamma`
  but taking *any* per-cluster contraction factors (the controller
  feeds measured power-iteration estimates instead of the build-time
  eigendecomposition) and returning the saturation mask alongside.
* :func:`equal_contraction_gamma` — maintain the *designed* mixing
  contraction λ_ref^Γ_ref when measured connectivity degrades (the
  connectivity-aware rule of Parasnis et al. 2023): scale-mode runs
  have no per-event Υ measurement (the interval is one step call),
  but matching contraction needs none.
* :func:`tau_law` — pick the aggregation period by trading the
  Proposition-1 dispersion bound (grows with τ through Σ_t) against
  the per-iteration uplink cost (shrinks as 1/τ).
* :func:`sampling_law` / :func:`sample_with_probs` — availability- and
  straggler-aware cluster sampling weights, replacing the uniform
  draw of :func:`repro_torch.netsim.faults.availability_sample` with
  p ∝ up / delay while keeping its (picks, counts) contract.

The safety envelope (:func:`safety_envelope`) is
:func:`repro_torch.core.theory.check_theorem2_conditions` plus the
degenerate constant-step-size variant; the controller refuses to
deviate from the static schedule whenever it fails.
"""
from __future__ import annotations

from typing import Callable

import numpy as np

from repro_torch.core.theory import ProblemConstants, check_theorem2_conditions


# ---------------------------------------------------------------------------
# Γ laws
# ---------------------------------------------------------------------------

def remark1_gamma(eta_t: float, phi: float, upsilon: np.ndarray,
                  lambdas: np.ndarray, cluster_size,
                  model_dim: int, max_rounds: int = 64
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Remark-1 round counts from arbitrary contraction factors.

    The numpy twin of :func:`repro_torch.core.schedule.adaptive_gamma_info`
    (same clips, same guards — the unit tests assert element-wise
    equality), so the controller can run it host-side on *measured*
    λ̂ without touching the trainer's tensors. Returns
    ``(gamma (N,) int32, saturated (N,) bool)``.
    """
    target = float(eta_t) * float(phi)
    sizes = np.asarray(cluster_size)
    ups = np.asarray(upsilon, np.float64)
    lam = np.asarray(lambdas, np.float64)
    pref = sizes * ups * model_dim
    safe_pref = np.maximum(pref, 1e-30)
    ratio = np.clip(target / safe_pref, 1e-30, None)
    need = np.log(ratio) / np.log(np.clip(lam, 1e-6, 1 - 1e-9))
    gamma = np.ceil(need).astype(np.int64)
    gamma = np.where(pref <= target, 0, gamma)
    gamma = np.where(sizes <= 1, 0, gamma)
    saturated = gamma > max_rounds
    return np.clip(gamma, 0, max_rounds).astype(np.int32), saturated


def equal_contraction_gamma(lambdas_measured: np.ndarray,
                            lambda_ref: np.ndarray, gamma_ref: int,
                            max_rounds: int = 64
                            ) -> tuple[np.ndarray, np.ndarray]:
    """Γ_c = ceil(Γ_ref · log λ_ref / log λ̂_c): per-cluster rounds that
    achieve at least the contraction λ_ref^Γ_ref the static schedule
    was designed for, on the *measured* connectivity. Degraded links
    (λ̂ > λ_ref) mix more; better-than-assumed links mix less; λ̂ ≈ 0
    (one round is exact) runs min(Γ_ref, 1) — disconnected clusters
    are masked to 0 upstream by the resolver's active-edge check.
    Returns ``(gamma (N,) int32, saturated (N,) bool)``.
    """
    lam_m = np.asarray(lambdas_measured, np.float64)
    lam_r = np.asarray(lambda_ref, np.float64)
    target = np.log(np.clip(lam_r, 1e-12, 1 - 1e-12)) * int(gamma_ref)
    need = target / np.log(np.clip(lam_m, 1e-12, 1 - 1e-12))
    gamma = np.ceil(need - 1e-9).astype(np.int64)
    # λ̂ ≈ 0 means ONE round reaches exact agreement (e.g. a pair
    # cluster averaging, or a complete graph at the uniform weights) —
    # run exactly that one round, never zero (Γ = 0 would not mix at
    # all) and never the reference surplus
    gamma = np.where(lam_m <= 1e-12, min(int(gamma_ref), 1), gamma)
    gamma = np.maximum(gamma, 0)
    saturated = gamma > max_rounds
    return np.clip(gamma, 0, max_rounds).astype(np.int32), saturated


# ---------------------------------------------------------------------------
# τ law
# ---------------------------------------------------------------------------

def sigma_span(beta: float, eta_fn: Callable[[int], float], t: int,
               tau: int) -> float:
    """Σ_t of Proposition 1 for the span (t - τ, t] under ``eta_fn``
    (the general-schedule form of :func:`repro_torch.core.theory.sigma_t`)."""
    total = 0.0
    for ell in range(t - tau, t):
        prod = 1.0
        for j in range(ell + 1, t):
            prod *= 1.0 + 2.0 * float(eta_fn(j)) * beta
        total += beta * float(eta_fn(ell)) * prod
    return total


def dispersion_gap(k: ProblemConstants, eta_fn: Callable[[int], float],
                   t: int, tau: int, eps0: float = 0.0) -> float:
    """Proposition-1 dispersion bound for a τ-long local span ending at
    ``t`` — the convergence price of aggregating less often."""
    s = sigma_span(k.beta, eta_fn, t, tau)
    return (12.0 / k.varrho_min) * s ** 2 * (
        k.sigma ** 2 / k.beta ** 2 + k.delta ** 2 / k.beta ** 2
        + eps0 ** 2)


def tau_law(k: ProblemConstants, eta_fn: Callable[[int], float], t: int,
            *, tau_min: int, tau_max: int, quantum: int = 1,
            energy_weight: float = 2.0) -> int:
    """Aggregation period minimizing dispersion bound + uplink cost.

    Scores every multiple of ``quantum`` (the consensus period — so
    the scale/sim event calendars stay consistent) in
    [tau_min, tau_max] by ``J(τ) = A_bound(τ) + energy_weight / τ``:
    the Proposition-1 dispersion the span accumulates plus the
    per-iteration uplink price. Larger measured σ/δ (through ``k``)
    pushes τ down; a larger ``energy_weight`` pushes it up; ties go to
    the larger (cheaper) τ. Deterministic and monotone in both — the
    unit tests assert the monotonicities.
    """
    quantum = max(1, int(quantum))
    lo = max(quantum, -(-int(tau_min) // quantum) * quantum)
    hi = max(lo, (int(tau_max) // quantum) * quantum)
    best_tau, best_score = None, None
    for tau in range(hi, lo - 1, -quantum):     # descending: ties → cheap
        score = dispersion_gap(k, eta_fn, t, tau) \
            + float(energy_weight) / tau
        if best_score is None or score < best_score - 1e-12:
            best_tau, best_score = tau, score
    return int(best_tau)


# ---------------------------------------------------------------------------
# sampling law
# ---------------------------------------------------------------------------

def sampling_law(device_up: np.ndarray,
                 delay_mult: np.ndarray) -> np.ndarray:
    """(N, s) availability/straggler-aware sampling probabilities.

    p_{c,i} ∝ up_{c,i} / max(delay_{c,i}, 1): offline devices get 0,
    stragglers are down-weighted in proportion to their tail delay (the
    uplink the ledger prices by ``uplink_tail_mults``). Rows of dark
    clusters are all-zero; live rows sum to 1.
    """
    up = np.asarray(device_up, bool)
    w = up / np.clip(np.asarray(delay_mult, np.float64), 1.0, None)
    tot = w.sum(axis=1, keepdims=True)
    return np.divide(w, tot, out=np.zeros_like(w), where=tot > 0)


def sample_with_probs(rng: np.random.Generator, probs: np.ndarray,
                      k: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-cluster draw of k representatives without replacement under
    :func:`sampling_law` probabilities. Same ``(picks, counts)``
    contract as :func:`repro_torch.netsim.faults.availability_sample` (picks
    (N, k) int32 padded with -1, counts (N,)), so the weight builders
    downstream are unchanged.
    """
    p = np.asarray(probs, np.float64)
    N, s = p.shape
    picks = np.full((N, k), -1, np.int32)
    counts = np.zeros(N, np.int64)
    for c in range(N):
        avail = np.flatnonzero(p[c] > 0)
        kc = min(k, len(avail))
        if kc:
            pc = p[c, avail] / p[c, avail].sum()
            picks[c, :kc] = rng.choice(avail, size=kc, replace=False,
                                       p=pc)
        counts[c] = kc
    return picks, counts


# ---------------------------------------------------------------------------
# safety envelope
# ---------------------------------------------------------------------------

def safety_envelope(k: ProblemConstants, gamma_lr: float, alpha: float,
                    constant_lr: float = 0.0) -> dict[str, bool]:
    """Theorem-2 tunable-parameter conditions for either schedule form.

    Decaying η_t = γ/(t+α) checks the full
    :func:`~repro_torch.core.theory.check_theorem2_conditions` triple; a
    constant step size only admits the η₀ ≤ μ/β² condition (the other
    two constrain the decay law itself). The controller applies a
    decision only when every condition holds.
    """
    if constant_lr > 0:
        ok = constant_lr <= k.mu / k.beta ** 2 + 1e-12
        return {"eta0_le_mu_over_beta2": bool(ok)}
    return check_theorem2_conditions(k, gamma_lr, alpha)


__all__ = [
    "dispersion_gap", "equal_contraction_gamma", "remark1_gamma",
    "safety_envelope", "sample_with_probs", "sampling_law",
    "sigma_span", "tau_law",
]
