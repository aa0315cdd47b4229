"""The online controller — a numpy copy of ``repro/control/
controller.py``.

One :class:`Controller` per run, owned by the
:class:`~repro_torch.rounds.resolver.RoundResolver` when the
:class:`~repro_torch.rounds.program.RoundProgram` declares a non-static
:class:`~repro_torch.configs.base.ControlConfig`. Each round it consumes

* measured network state — per-event power-iteration contraction
  estimates (:func:`~repro_torch.netsim.dynamics.measured_lambdas`) on the
  active subgraph, next to the build-time *assumed* eigenvalues;
* online gradient statistics — the :class:`~repro_torch.control.estimator.
  OnlineGradStats` window wiring ``core/theory.py``'s δ/σ estimators;
* trainer measurements — the Definition-2 divergence Υ at the event
  (sim mode) or the previous interval's probe (scale mode),

and emits a :class:`ControlDecision`: per-cluster Γ, the next
aggregation period τ (sim mode only — scale mode bakes τ into the
interval's batch shape), and availability/straggler-aware sampling
weights. Every decision passes the safety envelope first
(:func:`~repro_torch.control.laws.safety_envelope`, i.e. the Theorem-2
tunable-parameter conditions); when it fails the controller *refuses*
— the decision carries ``safe=False`` plus a fallback reason and the
static schedule is applied unchanged.

The controller is strictly host-side and strictly out-of-band: it
never touches the trainers' draw sources (its estimators are
seeded from ``ControlConfig.estimator_seed``), so a ``static`` policy
— where no controller is even constructed — is bitwise the historical
trajectory (asserted in ``tests/test_torch_control.py``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

from repro_torch.configs.base import ControlConfig
from repro_torch.control import laws
from repro_torch.control.estimator import OnlineGradStats, static_measured_lambdas
from repro_torch.core.theory import ProblemConstants


@dataclass
class ControlDecision:
    """One round's controller output, threaded by the resolver into the
    :class:`~repro_torch.rounds.program.ConsensusSpec` /
    :class:`~repro_torch.rounds.program.RoundEvent` so both trainers apply
    and log it without forking their loops. ``gammas`` is filled by
    :meth:`Controller.gamma_for` — at event time in sim mode (fresh
    Υ), at resolve time in scale mode (previous interval's Υ-free
    equal-contraction law)."""
    t: int
    policy: str
    safe: bool
    fallback: str = ""
    lambdas_measured: Optional[np.ndarray] = None   # (N,) power-iter λ̂
    lambdas_assumed: Optional[np.ndarray] = None    # (N,) eigen oracle
    gammas: Optional[np.ndarray] = None             # (N,) int32
    gamma_saturated: int = 0                        # clusters clamped
    tau_next: Optional[int] = None                  # sim τ retune
    sampling: bool = False                          # biased draw used
    delta_hat: Optional[float] = None
    sigma_hat: Optional[float] = None

    def round_fields(self) -> dict:
        """The obs payload: joined into the same ``metrics.jsonl`` round
        rows as the Lemma-1 / Proposition-1 gauges."""
        out = {"control_policy": self.policy,
               "control_safe": int(self.safe),
               "control_gamma_saturated": self.gamma_saturated}
        if self.fallback:
            out["control_fallback"] = self.fallback
        if self.lambdas_measured is not None:
            out["lambda_measured"] = np.asarray(self.lambdas_measured)
        if self.lambdas_assumed is not None:
            out["lambda_assumed"] = np.asarray(self.lambdas_assumed)
        if self.tau_next is not None:
            out["control_tau_next"] = int(self.tau_next)
        if self.sampling:
            out["control_sampling"] = 1
        if self.delta_hat is not None:
            out["control_delta_hat"] = float(self.delta_hat)
        if self.sigma_hat is not None:
            out["control_sigma_hat"] = float(self.sigma_hat)
        return out


class Controller:
    """Per-run Γ/τ/sampling retuning under the Theorem-2 envelope."""

    def __init__(self, cfg: ControlConfig, *, mode: str, net,
                 constants: ProblemConstants, phi: float,
                 gamma_static: int, tau_static: int, quantum: int,
                 lr_gamma: float = 0.0, lr_alpha: float = 0.0,
                 constant_lr: float = 0.0,
                 eta_fn: Optional[Callable[[int], float]] = None,
                 model_dim: Optional[int] = None):
        assert mode in ("sim", "scale")
        assert not cfg.is_static, \
            "a static policy means NO controller (the resolver never " \
            "constructs one, so the historical path stays bitwise)"
        self.cfg = cfg
        self.mode = mode
        self.net = net
        self.base_constants = constants
        self.phi = float(phi)
        self.gamma_static = int(gamma_static)
        self.tau_static = int(tau_static)
        self.tau_current = int(tau_static)
        self.quantum = max(1, int(quantum))
        self.eta_fn = eta_fn
        self.model_dim = model_dim
        self.stats = OnlineGradStats(window=cfg.stats_window)
        # the Theorem-2 envelope is a property of the (fixed) schedule:
        # evaluated once, re-checked per decision only for estimator
        # sanity (λ̂ must stay a contraction)
        self.envelope = laws.safety_envelope(
            constants, lr_gamma, lr_alpha, constant_lr)
        self.envelope_ok = all(self.envelope.values())
        # counters surfaced through obs + History
        self.decisions = 0
        self.fallbacks = 0
        self.saturated_total = 0
        self.upsilon_last: Optional[np.ndarray] = None
        self._static_lambdas: Optional[np.ndarray] = None

    # ------------------------------------------------------------------
    @classmethod
    def for_sim(cls, cfg: ControlConfig, net, algo) -> "Controller":
        """Build against a sim :class:`~repro_torch.configs.base.TTHFConfig`
        (``RoundResolver.for_sim`` guards ``algo.mode == 'tthf'``)."""
        from repro_torch.core.schedule import make_lr_schedule
        eta = make_lr_schedule(algo)
        return cls(
            cfg, mode="sim", net=net,
            constants=cls._constants(net),
            phi=algo.phi, gamma_static=max(algo.gamma_d2d, 0),
            tau_static=algo.tau,
            quantum=algo.consensus_every or algo.tau,
            lr_gamma=algo.gamma, lr_alpha=algo.alpha,
            constant_lr=algo.constant_lr,
            eta_fn=lambda t: float(eta(t)))

    @classmethod
    def for_scale(cls, cfg: ControlConfig, net, scale) -> "Controller":
        """Build against a :class:`~repro_torch.core.distributed.
        TTHFScaleConfig`: constant lr, τ frozen into the interval's
        batch shape (the controller never retunes it here), Γ by the
        equal-contraction law."""
        return cls(
            cfg, mode="scale", net=net,
            constants=cls._constants(net),
            phi=1.0, gamma_static=scale.gamma_d2d,
            tau_static=scale.tau,
            quantum=scale.consensus_every or scale.tau,
            constant_lr=scale.lr,
            eta_fn=lambda t: float(scale.lr))

    @staticmethod
    def _constants(net) -> ProblemConstants:
        # unit-scale placeholders, same convention as
        # obs.telemetry.default_constants; σ/δ are replaced by the
        # online estimates as the stats window fills
        return ProblemConstants(
            mu=1.0, beta=1.0, sigma=1.0, delta=1.0,
            varrho_min=float(np.min(np.asarray(net.varrho))))

    def bind(self, model_dim: Optional[int] = None,
             eta_fn: Optional[Callable[[int], float]] = None) -> None:
        """Late-bound trainer facts (the resolver builds the controller
        before the model is initialized)."""
        if model_dim is not None:
            self.model_dim = int(model_dim)
        if eta_fn is not None:
            self.eta_fn = eta_fn

    # ------------------------------------------------------------------
    # capabilities
    # ------------------------------------------------------------------
    @property
    def adapts_tau(self) -> bool:
        """τ retuning is sim-only: the scale-mode interval bakes τ into
        the (τ, R, b, T) batch shape of the once-compiled step."""
        return (self.mode == "sim"
                and self.cfg.policy == "connectivity"
                and self.cfg.adapt_tau)

    @property
    def adapts_sampling(self) -> bool:
        return (self.cfg.policy == "connectivity"
                and self.cfg.adapt_sampling)

    @property
    def wants_grad_stats(self) -> bool:
        """The τ law scores the Proposition-1 bound with measured σ/δ;
        remark1 runs fine on the defaults."""
        return self.mode == "sim" and self.cfg.policy == "connectivity"

    # ------------------------------------------------------------------
    # observations (trainer-side measurements, out-of-band)
    # ------------------------------------------------------------------
    def observe_upsilon(self, upsilon: np.ndarray) -> None:
        self.upsilon_last = np.asarray(upsilon, np.float64)

    def observe_cluster_grads(self, cluster_grads: np.ndarray,
                              varrho: np.ndarray) -> None:
        self.stats.observe_clusters(cluster_grads, varrho)

    def observe_fleet_noise(self, sample_grads: np.ndarray,
                            full_grads: np.ndarray) -> None:
        self.stats.observe_fleet_noise(sample_grads, full_grads)

    # ------------------------------------------------------------------
    # decisions
    # ------------------------------------------------------------------
    def _measure(self, t: int, snap) -> tuple[np.ndarray, np.ndarray]:
        """(λ̂ measured, λ assumed) for this round's topology."""
        cfg = self.cfg
        if snap is not None:
            measured = snap.measured_lambdas(
                iters=cfg.power_iters, seed=cfg.estimator_seed)
            return measured, np.asarray(snap.lambdas, np.float64)
        if self._static_lambdas is None:
            self._static_lambdas = static_measured_lambdas(
                self.net, iters=cfg.power_iters,
                seed=cfg.estimator_seed)
        return self._static_lambdas, np.asarray(self.net.lambdas,
                                                np.float64)

    def _ref_lambdas(self) -> np.ndarray:
        """The contraction the static Γ was provisioned for: a scalar
        worst-case design assumption (``cfg.lambda_ref``) or the exact
        build-time spectrum."""
        if self.cfg.lambda_ref is not None:
            return np.full(self.net.num_clusters, self.cfg.lambda_ref)
        return np.asarray(self.net.lambdas, np.float64)

    def consensus_decision(self, t: int, snap) -> ControlDecision:
        """Measure connectivity and open this round's decision; Γ is
        filled by :meth:`gamma_for` (sim: the trainer supplies the
        event's fresh Υ) or :meth:`scale_gammas`."""
        measured, assumed = self._measure(t, snap)
        dec = ControlDecision(
            t=t, policy=self.cfg.policy, safe=True,
            lambdas_measured=measured, lambdas_assumed=assumed,
            delta_hat=self.stats.delta_hat,
            sigma_hat=self.stats.sigma_hat)
        if self.cfg.safety and not self.envelope_ok:
            failed = sorted(k for k, v in self.envelope.items() if not v)
            dec.safe = False
            dec.fallback = "theorem2:" + ",".join(failed)
            self.fallbacks += 1
        elif not np.all(np.isfinite(measured)) \
                or np.any(measured >= 1.0 - 1e-9):
            # a broken estimate is not a license to under-mix: fall
            # back to the assumed spectrum for this round
            dec.safe = False
            dec.fallback = "lambda_estimate"
            self.fallbacks += 1
        self.decisions += 1
        return dec

    def gamma_for(self, dec: ControlDecision, eta_t: float,
                  upsilon: np.ndarray, sizes) -> np.ndarray:
        """Per-cluster Γ for one consensus event (sim mode).

        ``remark1`` runs the paper's Υ-driven law on the assumed
        (oracle) contraction factors. ``connectivity`` preserves the
        *designed* mixing instead: with a fixed reference schedule
        (``gamma_d2d >= 0``) it spends exactly the rounds the measured
        spectrum needs to match λ_ref^Γ_ref — the same law as scale
        mode, so churn-shrunken (faster-mixing) components cost less
        energy at the design-point contraction; an adaptive design has
        a target ε instead of a Γ_ref, so there Remark 1 runs on the
        measured λ̂. The static schedule applies when the decision is
        unsafe. Records saturation on the decision and the run
        totals."""
        n = self.net.num_clusters
        if not dec.safe:
            dec.gammas = np.full((n,), self.gamma_static, np.int32)
            return dec.gammas
        if self.cfg.policy == "connectivity" and self.gamma_static > 0:
            gamma, sat = laws.equal_contraction_gamma(
                dec.lambdas_measured, self._ref_lambdas(),
                self.gamma_static, max_rounds=self.cfg.gamma_max)
        else:
            assert self.model_dim is not None, \
                "bind(model_dim=...) before the first consensus decision"
            lam = (dec.lambdas_measured
                   if self.cfg.policy == "connectivity"
                   else dec.lambdas_assumed)
            gamma, sat = laws.remark1_gamma(
                eta_t, self.phi, upsilon, lam, sizes, self.model_dim,
                max_rounds=self.cfg.gamma_max)
        dec.gammas = gamma
        dec.gamma_saturated = int(sat.sum())
        self.saturated_total += dec.gamma_saturated
        return gamma

    def scale_gammas(self, dec: ControlDecision) -> np.ndarray:
        """Per-cluster Γ for one scale interval: match the designed
        contraction λ_ref^Γ_ref on the measured spectrum (no Υ needed
        — the interval is a single step call, so there is no
        per-event divergence measurement to feed Remark 1)."""
        n = self.net.num_clusters
        if not dec.safe:
            dec.gammas = np.full((n,), self.gamma_static, np.int32)
            return dec.gammas
        lam = (dec.lambdas_measured if self.cfg.policy == "connectivity"
               else dec.lambdas_assumed)
        gamma, sat = laws.equal_contraction_gamma(
            lam, self._ref_lambdas(), self.gamma_static,
            max_rounds=self.cfg.gamma_max)
        dec.gammas = gamma
        dec.gamma_saturated = int(sat.sum())
        self.saturated_total += dec.gamma_saturated
        return gamma

    def tau_decision(self, t: int, dec: ControlDecision) -> int:
        """The next aggregation period (sim mode): the τ law scored
        with the measured σ̂/δ̂, quantized to the consensus period.
        Unsafe decisions keep the static τ."""
        if not self.adapts_tau or not dec.safe:
            dec.tau_next = None if not self.adapts_tau else \
                self.tau_static
            self.tau_current = self.tau_static
            return self.tau_static
        k = self.stats.constants(self.base_constants)
        tau = laws.tau_law(
            k, self.eta_fn, t, tau_min=self.cfg.tau_min,
            tau_max=self.cfg.tau_max, quantum=self.quantum,
            energy_weight=self.cfg.energy_weight)
        dec.tau_next = tau
        self.tau_current = tau
        return tau

    def sampling_probs(self, dec: Optional[ControlDecision],
                       snap) -> Optional[np.ndarray]:
        """(N, s) biased sampling probabilities, or None to keep the
        historical uniform draw (static policy off, no churn/straggler
        state to react to, or an unsafe round)."""
        if not self.adapts_sampling or snap is None:
            return None
        if dec is not None and not dec.safe:
            return None
        if dec is not None:
            dec.sampling = True
        return laws.sampling_law(snap.device_up, snap.delay_mult)

    # ------------------------------------------------------------------
    def counters(self) -> dict:
        """Run-level totals for the obs counter stream."""
        return {
            "decisions": self.decisions,
            "fallbacks": self.fallbacks,
            "gamma_saturated_total": self.saturated_total,
            "tau_current": self.tau_current,
        }


__all__ = ["ControlDecision", "Controller"]
