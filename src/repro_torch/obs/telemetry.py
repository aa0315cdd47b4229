"""Theory-bound telemetry: read-only probes + bound gauges — the port of
``repro/obs/telemetry.py``.

Two halves:

* **Probes** — read-only functions over the (stacked) device parameters
  that compute the measured quantities the paper's analysis talks
  about: per-cluster consensus divergence Υ_c (Definition 2),
  per-cluster mean-squared consensus error (Definition 3), the
  post-mixing residual max_i‖w_i − w̄_c‖ that Lemma 1 bounds, the
  cluster dispersion A^(t), and parameter/gradient norms. Probes never
  feed back into training: they run under ``torch.no_grad`` (the
  gradient probes build their own graph over detached leaves, so no
  ``.grad`` lands on the trainer's parameters), and an instrumented run
  is bitwise-identical to an uninstrumented one.

* **Gauges** — host-side evaluations of ``core/theory.py`` (``sigma_t``,
  Proposition-1 ``dispersion_bound``, Lemma 1) for the same round, so
  bound-vs-actual lands in ONE JSONL record per round.

The reference jits each probe; here the divergence probe walks each
leaf in column blocks of at most ``_BLOCK`` elements, so that its
temporaries stay small beside a fleet leaf of gigabytes (the sim NN's
``w1`` is 3.1 GB over 125 devices).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import consensus as cns
from repro_torch.core.theory import (
    ProblemConstants, dispersion_bound, lemma1_bound, sigma_t)
from repro_torch.models.common import tree_leaves, tree_map

_BLOCK = 1 << 26        # elements of a leaf's column block (256 MB f32)


# ---------------------------------------------------------------------------
# probes
# ---------------------------------------------------------------------------

def _leaves(params) -> list:
    return [params] if isinstance(params, torch.Tensor) else \
        tree_leaves(params)


def make_divergence_probe(num_clusters: int, cluster_size: int,
                          varrho) -> Callable:
    """Probe over a params tree whose leaves carry a leading device axis
    I = N*s (the simulation fleet, the scale-mode replica stack, or the
    flat (R, P) carrier — a tensor is a one-leaf tree; pass the carrier
    without its pad columns).

    Returns ``{upsilon (N,), consensus_err (N,), mix_residual (N,),
    dispersion (), param_norm ()}`` as float32 tensors on the params'
    device; the caller drains them once per round.
    """
    N, s = num_clusters, cluster_size
    v_host = torch.as_tensor(np.asarray(varrho), dtype=torch.float32)

    @torch.no_grad()
    def probe(params):
        leaves = _leaves(params)
        dev = leaves[0].device
        v = v_host.to(dev)
        ups, errs = [], []
        sq = torch.zeros((N, s), dtype=torch.float32, device=dev)
        disp = torch.zeros((), dtype=torch.float32, device=dev)
        pn = torch.zeros((), dtype=torch.float32, device=dev)
        for leaf in leaves:
            z = leaf.reshape(N, s, -1)
            M = z.shape[-1]
            cols = max(1, _BLOCK // (N * s))
            up = None
            sq_leaf = torch.zeros((N, s), dtype=torch.float32, device=dev)
            for a in range(0, M, cols):
                zb = z[..., a:a + cols].float()
                u = cns.divergence_upsilon(zb)
                up = u if up is None else torch.maximum(up, u)
                means = cns.cluster_means(zb)
                # one pass each over the block: no squared temporaries
                e = zb - means[:, None, :]
                sq_leaf += torch.linalg.vector_norm(e, dim=-1).square()
                del e
                gmean = torch.einsum("c,cm->m", v, means)
                disp += (v * ((means - gmean) ** 2).sum(dim=-1)).sum()
                pn += torch.linalg.vector_norm(zb).square()
            ups.append(up)
            # Definition 3, cns.consensus_error, from the same residuals
            errs.append(sq_leaf.mean(dim=1))
            sq += sq_leaf
        return {
            "upsilon": torch.stack(ups).amax(dim=0),
            "consensus_err": torch.stack(errs).sum(dim=0),
            "mix_residual": torch.sqrt(sq.amax(dim=1)),
            "dispersion": disp,
            "param_norm": torch.sqrt(pn),
        }

    return probe


def _grad_norm(loss_fn: Callable, params: dict) -> torch.Tensor:
    """‖∇loss(params)‖ over detached leaves (the trainer's own tensors
    get no graph and no ``.grad``)."""
    leaves = tree_map(lambda l: l.detach().requires_grad_(True), params)
    flat = tree_leaves(leaves)
    with torch.enable_grad():
        g = torch.autograd.grad(loss_fn(leaves), flat)
    with torch.no_grad():
        return torch.sqrt(sum((l.float() ** 2).sum() for l in g))


def make_sim_grad_probe(model, x: torch.Tensor, y: torch.Tensor) -> Callable:
    """‖∇F(ŵ)‖ over the full federated dataset (sim mode): ``x (I, D,
    m)``, ``y (I, D)`` as one device holding every point."""
    fx = x.reshape(1, -1, x.shape[-1])
    fy = y.reshape(1, -1)

    def probe(global_params: dict) -> torch.Tensor:
        one = {k: v[None] for k, v in global_params.items()}
        return _grad_norm(lambda p: model.loss(p, fx, fy)[0], one)

    return probe


def make_scale_grad_probe(model, dtype) -> Callable:
    """‖∇loss(ŵ; batch)‖ for scale mode — fed a dedicated probe batch
    stream so train/eval data draws are untouched."""
    def probe(global_params: dict, batch: dict) -> torch.Tensor:
        return _grad_norm(lambda p: model.loss(p, batch, dtype=dtype),
                          global_params)

    return probe


# ---------------------------------------------------------------------------
# theory gauges
# ---------------------------------------------------------------------------

def default_constants(varrho_min: float) -> ProblemConstants:
    """Unit-scale placeholder constants — the gauges are *relative*
    instruments unless the caller estimates (μ, β, σ, δ) for the task
    (``core/theory.py`` has the estimators)."""
    return ProblemConstants(mu=1.0, beta=1.0, sigma=1.0, delta=1.0,
                            varrho_min=float(varrho_min))


def sigma_t_general(beta: float, eta_fn: Callable[[int], float],
                    t: int, t_prev_agg: int) -> float:
    """Proposition-1 Σ_t for an arbitrary step-size sequence —
    identical recurrence to :func:`repro_torch.core.theory.sigma_t`,
    which covers only η_j = γ/(j+α)."""
    total = 0.0
    for ell in range(t_prev_agg, t):
        prod = 1.0
        for j in range(ell + 1, t):
            prod *= 1.0 + 2.0 * eta_fn(j) * beta
        total += beta * eta_fn(ell) * prod
    return total


@dataclass
class TheoryGauges:
    """Per-round bound evaluations for the telemetry stream.

    Exactly one of (``gamma``, ``alpha``) — the paper's decaying
    schedule η_t = γ/(t+α) — or ``lr`` (constant step size, scale mode)
    drives the η sequence. ``phi`` sets the Remark-1 consensus target
    ε^(t) = η_t·φ used as Proposition 1's ε₀.
    """
    constants: ProblemConstants
    tau: int
    model_dim: int
    phi: float = 1.0
    gamma: Optional[float] = None
    alpha: Optional[float] = None
    lr: Optional[float] = None

    def __post_init__(self):
        decaying = self.gamma is not None and self.alpha is not None
        if decaying == (self.lr is not None):
            raise ValueError("pass gamma+alpha (decaying schedule) XOR lr "
                             "(constant)")

    def eta(self, t: int) -> float:
        if self.lr is not None:
            return float(self.lr)
        return self.gamma / (t + self.alpha)

    def sigma(self, t: int, t_prev_agg: int) -> float:
        if self.lr is not None:
            return sigma_t_general(self.constants.beta,
                                   lambda j: self.lr, t, t_prev_agg)
        return sigma_t(self.constants, self.gamma, self.alpha, self.tau,
                       t, t_prev_agg)

    def round_gauges(self, t: int, t_prev_agg: int) -> dict:
        """``{sigma_t, dispersion_bound, eps0}`` for round ``t`` whose
        last aggregation was at ``t_prev_agg``."""
        k = self.constants
        eps0 = self.eta(t) * self.phi
        if self.lr is not None:
            s = self.sigma(t, t_prev_agg)
            disp = (12.0 / k.varrho_min) * s ** 2 * (
                k.sigma ** 2 / k.beta ** 2 + k.delta ** 2 / k.beta ** 2
                + eps0 ** 2)
        else:
            s = self.sigma(t, t_prev_agg)
            disp = dispersion_bound(k, self.gamma, self.alpha, self.tau,
                                    t, t_prev_agg, eps0)
        return {"sigma_t": float(s), "dispersion_bound": float(disp),
                "eps0": float(eps0)}

    def lemma1(self, lambdas, gammas, cluster_size,
               upsilons) -> np.ndarray:
        """Per-cluster Lemma-1 bounds λ_c^Γ_c · s_c · Υ_c · M on the
        post-mixing residual, from the *measured* pre-mixing Υ_c."""
        lam = np.asarray(lambdas, float)
        gam = np.asarray(gammas, int)
        ups = np.asarray(upsilons, float)
        sizes = np.broadcast_to(np.asarray(cluster_size), lam.shape)
        return np.array([
            lemma1_bound(lam[c], int(gam[c]), int(sizes[c]), ups[c],
                         self.model_dim)
            for c in range(lam.shape[0])])


# ---------------------------------------------------------------------------
# comms attribution
# ---------------------------------------------------------------------------

def emit_comm(obs, ledger, mark: int, step: int) -> None:
    """The ``comm`` record of the ledger's rows since ``mark`` (uplinks
    by level, D2D messages and rounds by cluster) and the run-level
    ``ledger`` counter — shared by both trainers."""
    rows = ledger.attribution_since(mark)
    if rows:
        up_lv, d2d_cl = {}, {}
        ups = msgs = rounds = 0
        for r in rows:
            if r["kind"] == "uplink":
                ups += r["n"]
                up_lv[r["level"]] = up_lv.get(r["level"], 0) + r["n"]
            elif r["kind"] == "consensus":
                msgs += r["msgs"]
                rounds += r["rounds"]
                c = r["cluster"]
                d2d_cl[c] = d2d_cl.get(c, 0) + r["msgs"]
        obs.emit("comm", step, uplinks=ups, uplinks_by_level=up_lv,
                 d2d_msgs=msgs, d2d_rounds=rounds,
                 d2d_msgs_by_cluster=d2d_cl, event=ledger._event_idx)
    obs.counter("ledger", uplinks=ledger.uplinks, d2d_msgs=ledger.d2d_msgs,
                local_steps=ledger.local_steps)


__all__ = [
    "TheoryGauges", "default_constants", "emit_comm",
    "make_divergence_probe",
    "make_scale_grad_probe", "make_sim_grad_probe", "sigma_t_general",
]
