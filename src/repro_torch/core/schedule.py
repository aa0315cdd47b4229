"""TT-HF schedules: the decaying step size and the aperiodic D2D-round
rule of Remark 1 — the port of ``repro/core/schedule.py``.

Remark 1:  Gamma_c^(t) = max{ ceil( log(eta_t*phi / (s_c*Upsilon_c^(t)*M))
                                    / log(lambda_c) ), 0 }
so that Lemma 1 gives ||e_i^(t)|| <= lambda^Gamma * s_c * Upsilon_c * M
                              <= eta_t * phi.

The rule is computed in float32, as in the reference: the ``ceil`` can
sit on a boundary, and the precision decides Γ there.
"""
from __future__ import annotations

import torch

from repro_torch.optim.schedules import constant, paper_schedule


def make_lr_schedule(cfg) -> callable:
    """cfg: TTHFConfig."""
    if cfg.constant_lr > 0:
        return constant(cfg.constant_lr)
    return paper_schedule(cfg.gamma, cfg.alpha)


def adaptive_gamma_info(eta_t, phi: float, upsilon: torch.Tensor,
                        lambdas: torch.Tensor, cluster_size,
                        model_dim: int, max_rounds: int = 64
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Remark-1 D2D round counts *with saturation flags*.

    upsilon, lambdas: (N,) float32; eta_t: a float32 scalar;
    cluster_size: the static s_c or an (N,) vector of active counts.
    Returns ``(gamma, saturated)``: the clamped (N,) int32 round counts
    plus an (N,) bool marking every cluster whose *needed* Γ exceeded
    ``max_rounds``.
    """
    dev = upsilon.device
    target = torch.as_tensor(eta_t, dtype=torch.float32, device=dev) * phi
    sizes = torch.as_tensor(cluster_size, device=dev)
    # Lemma-1 prefactor s_c * Upsilon_c * M
    pref = sizes * upsilon * model_dim
    safe_pref = torch.clamp(pref, min=1e-30)
    ratio = torch.clamp(target / safe_pref, min=1e-30)
    # lambda^Gamma <= ratio  =>  Gamma >= log(ratio)/log(lambda)
    need = torch.log(ratio) / torch.log(torch.clamp(lambdas, 1e-6, 1 - 1e-9))
    gamma = torch.ceil(need).to(torch.int32)
    zero = torch.zeros_like(gamma)
    gamma = torch.where(pref <= target, zero, gamma)  # already within target
    gamma = torch.where(sizes <= 1, zero, gamma)      # isolated: nobody to mix
    saturated = gamma > max_rounds
    return torch.clamp(gamma, 0, max_rounds), saturated


def adaptive_gamma(eta_t, phi: float, upsilon: torch.Tensor,
                   lambdas: torch.Tensor, cluster_size, model_dim: int,
                   max_rounds: int = 64) -> torch.Tensor:
    """Remark-1 D2D round counts. upsilon, lambdas: (N,) -> (N,) int32.
    Saturation at ``max_rounds`` is silent here; use
    :func:`adaptive_gamma_info` when the clamp must be observable."""
    gamma, _ = adaptive_gamma_info(eta_t, phi, upsilon, lambdas,
                                   cluster_size, model_dim,
                                   max_rounds=max_rounds)
    return gamma


def fixed_gamma(num_clusters: int, rounds: int,
                device: torch.device | str = "cpu") -> torch.Tensor:
    return torch.full((num_clusters,), rounds, dtype=torch.int32,
                      device=device)


__all__ = ["adaptive_gamma", "adaptive_gamma_info", "fixed_gamma",
           "make_lr_schedule"]
