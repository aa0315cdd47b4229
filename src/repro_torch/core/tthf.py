"""Algorithm 1 — the TT-HF simulation engine; the port of ``repro/core/
tthf.py`` for the static topology.

The device fleet is stacked: every parameter leaf carries a leading
device axis ``I = N * s``. Local SGD runs all devices at once (batched
products, one autograd call, :meth:`SimModel.grads`); consensus
reshapes each leaf to ``(N, s, M)`` and applies the block-diagonal
mixing (:mod:`repro_torch.core.mixing`; ``use_kernel=True`` selects the
CUDA ``consensus_mix`` kernel); aggregations implement the
cluster-sampled global model of eq. (7).

The reference runs the local-SGD iterations between two events as one
jitted ``lax.scan``; here they are a Python loop over iterations, and
the SGD update runs in place under ``no_grad`` (the fleet's parameters
are 3.1 GB at the paper's NN width, so the port does not copy them each
step). Random draws come from a draw source (:mod:`repro_torch.core.
sampling`) instead of a JAX key.

Baselines (Sec. IV-B) are the same engine with ``mode``:
  * ``tthf``        — Algorithm 1 (sampled aggregation + D2D consensus)
  * ``fedavg``      — star FL, full participation, no D2D (tau as given)
  * ``centralized`` — star FL with tau = 1 (the paper's upper bound)
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.configs.base import TTHFConfig, TopologyConfig
from repro_torch.core import consensus as cns
from repro_torch.core import mixing
from repro_torch.core import sampling as smp
from repro_torch.core.energy import CommLedger
from repro_torch.core.schedule import (
    adaptive_gamma_info, fixed_gamma, make_lr_schedule)
from repro_torch.core.topology import Network, build_network
from repro_torch.data.synth import FederatedDataset
from repro_torch.kernels.runtime import DeviceLike, resolve_device
from repro_torch.models.simple import SimModel
from repro_torch.obs.sink import NULL_OBS
from repro_torch.rounds import RoundProgram, RoundResolver


@dataclass
class TTHFState:
    params: dict                 # leaves (I, ...)
    global_params: dict          # leaves (...)
    t: int
    draws: Any                   # the draw source (core/sampling.py)


@dataclass
class History:
    ts: list = field(default_factory=list)
    global_loss: list = field(default_factory=list)
    global_acc: list = field(default_factory=list)
    dispersion: list = field(default_factory=list)   # A^(t) estimate
    consensus_err: list = field(default_factory=list)
    gamma_used: list = field(default_factory=list)
    # cumulative count of Remark-1 clamp events (clusters whose needed
    # Γ exceeded max_rounds — the Lemma-1 target was NOT reached there)
    gamma_saturated: list = field(default_factory=list)
    uplinks: list = field(default_factory=list)
    d2d_msgs: list = field(default_factory=list)
    active_devices: list = field(default_factory=list)

    def as_arrays(self) -> dict[str, np.ndarray]:
        return {k: np.asarray(v) for k, v in dataclasses.asdict(self).items()}


class TTHFTrainer:
    """Drives Algorithm 1 over a :class:`FederatedDataset` on ``device``
    (default: the CUDA device; raises without one unless the caller
    passes ``device="cpu"``)."""

    def __init__(self, model: SimModel, data: FederatedDataset,
                 topo_cfg: TopologyConfig, algo: TTHFConfig,
                 batch_size: int = 16, eval_x: np.ndarray | None = None,
                 eval_y: np.ndarray | None = None,
                 use_kernel: bool = False, backend: str | None = None,
                 program: Optional[RoundProgram] = None,
                 device: DeviceLike = None):
        assert data.num_devices == topo_cfg.num_devices
        assert 1 <= algo.sample_per_cluster <= topo_cfg.cluster_size, \
            "sample_per_cluster must be within the cluster size"
        self.device = resolve_device(device)
        self.model = model
        self.data = data
        self.algo = algo
        self.net: Network = build_network(topo_cfg)
        self.batch_size = batch_size
        self.use_kernel = use_kernel
        self.program = program if program is not None else RoundProgram()
        self._resolver = RoundResolver.for_sim(self.net, algo, self.program)
        # consensus backend (core/mixing.py): the masked bounded loop by
        # default; use_kernel routes through the consensus_mix kernel
        if backend is None:
            backend = "pallas" if use_kernel else "masked_loop"
        self.backend = mixing.canonical_backend(backend)
        self.eta = make_lr_schedule(algo)
        self.ledger = CommLedger()
        dev = self.device
        self.x = torch.as_tensor(data.x, device=dev)
        self.y = torch.as_tensor(data.y, dtype=torch.long, device=dev)
        self.eval_x = (torch.as_tensor(eval_x, device=dev)
                       if eval_x is not None else None)
        self.eval_y = (torch.as_tensor(eval_y, dtype=torch.long, device=dev)
                       if eval_y is not None else None)
        self.V = torch.as_tensor(self.net.V, device=dev)
        # the network keeps varrho and lambdas in float64; the reference
        # trainer works with them in float32
        self.varrho = torch.as_tensor(self.net.varrho, dtype=torch.float32,
                                      device=dev)
        self.lambdas = torch.as_tensor(self.net.lambdas, dtype=torch.float32,
                                       device=dev)
        self.model_dim = None    # set at init()
        self._gamma_saturated_total = 0

    # ------------------------------------------------------------------
    def init(self, seed: int = 0, w0: Optional[dict] = None,
             draws: Any = None) -> TTHFState:
        """The starting state: ``w0`` (default: the model's init from a
        generator seeded with ``seed``) on every device, and the draw
        source (default: :class:`~repro_torch.core.sampling.TorchDraws`
        continuing that generator)."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        if w0 is None:
            w0 = self.model.init(gen, self.device)
        # sorted keys: the reference's leaf order, so per-leaf sums add
        # up in the same order
        w0 = {k: torch.as_tensor(w0[k], device=self.device)
              for k in sorted(w0)}
        self.model_dim = int(sum(v.numel() for v in w0.values()))
        params = smp.broadcast_pytree(w0, self.data.num_devices)
        draws = draws if draws is not None else smp.TorchDraws(gen)
        return TTHFState(params=params, global_params=w0, t=0, draws=draws)

    # ------------------------------------------------------------------
    # the pieces the reference jits
    # ------------------------------------------------------------------
    def _local_step(self, params: dict, idx: torch.Tensor,
                    eta_t: float) -> None:
        """One SGD iteration (eqs. 8-9) for every device, in place.
        idx: (I, B) minibatch indices into each device's points."""
        rows = torch.arange(idx.shape[0], device=self.device)[:, None]
        grads = self.model.grads(params, self.x[rows, idx],
                                 self.y[rows, idx])
        with torch.no_grad():
            for k, g in grads.items():
                params[k].sub_(g.mul_(eta_t))

    def _consensus(self, params: dict, gamma: torch.Tensor) -> dict:
        return mixing.mix_pytree(params, self.V, gamma,
                                 self.net.num_clusters, backend=self.backend)

    def _aggregate(self, params: dict, draws, full: bool):
        if full:
            g = smp.full_global_pytree(params, self.varrho,
                                       self.net.num_clusters)
        else:
            # one representative per cluster (eq. 7), or k without
            # replacement, averaged
            picks = draws.picks(self.net.num_clusters, self.net.cluster_size,
                                self.algo.sample_per_cluster)
            g = smp.sampled_global_pytree(params, picks, self.varrho,
                                          self.net.num_clusters)
        return g, smp.broadcast_pytree(g, self.data.num_devices)

    @torch.no_grad()
    def _eval(self, global_params: dict) -> tuple[float, float]:
        """Global loss F(w_hat) (eq. 3) + accuracy over all local data.

        The loss is taken over the padded per-device arrays, ignoring
        ``counts``, as the reference does. Every device holds the same
        D points, so the mean of the per-device means is the mean over
        all I*D points: one fleet of a single device holding them all.
        """
        one = {k: v[None] for k, v in global_params.items()}
        flat_x = self.x.reshape(1, -1, self.x.shape[-1])
        flat_y = self.y.reshape(1, -1)
        loss = self.model.loss(one, flat_x, flat_y)[0]
        if self.eval_x is not None:
            acc = self.model.accuracy(one, self.eval_x[None],
                                      self.eval_y[None])
        else:
            acc = self.model.accuracy(one, flat_x, flat_y)
        return float(loss), float(acc)

    def _leaves_by_cluster(self, params: dict):
        N, s = self.net.num_clusters, self.net.cluster_size
        return [leaf.reshape(N, s, -1) for leaf in params.values()]

    @torch.no_grad()
    def _upsilon(self, params: dict) -> torch.Tensor:
        """Definition-2 divergence per cluster, max over leaves."""
        ups = [cns.divergence_upsilon(z)
               for z in self._leaves_by_cluster(params)]
        return torch.stack(ups).amax(dim=0)

    @torch.no_grad()
    def _dispersion(self, params: dict) -> float:
        """A^(t) sample: sum_c varrho_c ||wbar_c - wbar||^2."""
        total = 0.0
        for z in self._leaves_by_cluster(params):
            means = cns.cluster_means(z)
            gmean = torch.einsum("c,cm->m", self.varrho.to(z.dtype), means)
            total += float((self.varrho
                            * ((means - gmean) ** 2).sum(dim=-1)).sum())
        return total

    @torch.no_grad()
    def _consensus_error(self, params: dict) -> float:
        total = 0.0
        for z in self._leaves_by_cluster(params):
            total += float((self.varrho * cns.consensus_error(z)).sum())
        return total

    # ------------------------------------------------------------------
    # round-program events
    # ------------------------------------------------------------------
    @torch.no_grad()
    def _consensus_event(self, st: TTHFState,
                         eta_t: torch.Tensor) -> tuple[np.ndarray, int]:
        """One consensus event on the base topology; replaces st.params
        and returns ``(per-cluster rounds used, clamp events)``."""
        algo = self.algo
        N = self.net.num_clusters
        sat = 0
        if algo.gamma_d2d >= 0:
            gamma = fixed_gamma(N, algo.gamma_d2d, self.device)
        else:
            gamma, sat_mask = adaptive_gamma_info(
                eta_t, algo.phi, self._upsilon(st.params), self.lambdas,
                self.net.cluster_size, self.model_dim)
            sat = int(sat_mask.sum())
        st.params = self._consensus(st.params, gamma)
        return gamma.cpu().numpy(), sat

    @torch.no_grad()
    def _apply_aggregation(self, st: TTHFState, spec) -> None:
        g, st.params = self._aggregate(st.params, st.draws, full=spec.full)
        st.global_params = g

    def _local_span(self, st: TTHFState, t_from: int, t_to: int) -> int:
        """Run the pure local-SGD iterations t_from..t_to (inclusive);
        updates st.params in place and returns the device-steps taken."""
        I, D = self.y.shape
        for u in range(t_from, t_to + 1):
            idx = st.draws.minibatch(I, self.batch_size, D)
            self._local_step(st.params, idx.to(self.device),
                             float(self.eta(u - 1)))
        return I * (t_to - t_from + 1)

    # ------------------------------------------------------------------
    def run(self, steps: int, seed: int = 0, eval_every: int = 5,
            state: TTHFState | None = None,
            record_dispersion: bool = True) -> tuple[TTHFState, History]:
        """Drive Algorithm 1: the resolver names each boundary
        iteration's events; the local-SGD iterations up to it run, then
        the consensus event (if any) before the aggregation (if any),
        then the round's bill and, on eval iterations, the history."""
        assert eval_every >= 1, "eval_every must be a positive period"
        obs = NULL_OBS
        st = state or self.init(seed)
        hist = History()
        res = self._resolver
        N = self.net.num_clusters
        t_last = st.t + steps
        t = st.t + 1
        with obs.span("run", mode="sim", steps=steps, t0=st.t):
            while t <= t_last:
                b = res.span_end(t, t_last, eval_every)
                with obs.span("round", t=b):
                    with obs.span("interval", t_from=t, t_to=b):
                        live = self._local_span(st, t, b)
                    self.ledger.record_local_step(live)

                    eta_b = self.eta(b - 1)
                    ev = res.resolve(b)
                    gamma_used = np.zeros((N,), np.int32)
                    if ev.consensus is not None:
                        with obs.span("consensus_event", t=b):
                            gamma_used, gamma_sat = self._consensus_event(
                                st, eta_b)
                        self._gamma_saturated_total += gamma_sat
                    if ev.aggregation is not None:
                        with obs.span("aggregation", t=b,
                                      kind=ev.aggregation.kind):
                            self._apply_aggregation(st, ev.aggregation)
                    ev.billing.charge(self.ledger, gamma_used)

                    if b % eval_every == 0 or b == t_last:
                        loss, acc = self._eval(st.global_params)
                        hist.ts.append(b)
                        hist.global_loss.append(loss)
                        hist.global_acc.append(acc)
                        if record_dispersion:
                            hist.dispersion.append(
                                self._dispersion(st.params))
                            hist.consensus_err.append(
                                self._consensus_error(st.params))
                        hist.gamma_used.append(gamma_used.copy())
                        hist.gamma_saturated.append(
                            self._gamma_saturated_total)
                        hist.uplinks.append(self.ledger.uplinks)
                        hist.d2d_msgs.append(self.ledger.d2d_msgs)
                        hist.active_devices.append(ev.active_devices)
                t = b + 1

        st.t += steps
        return st, hist


def make_baseline_config(mode: str, tau: int) -> TTHFConfig:
    """Paper baselines: FL with full participation (tau=1 'centralized'
    upper bound, or tau=20 per [6])."""
    if mode == "centralized":
        return TTHFConfig(mode="centralized", tau=1, full_participation=True,
                          consensus_every=0, gamma_d2d=0)
    if mode == "fedavg":
        return TTHFConfig(mode="fedavg", tau=tau, full_participation=True,
                          consensus_every=0, gamma_d2d=0)
    raise ValueError(mode)


__all__ = ["History", "TTHFState", "TTHFTrainer", "make_baseline_config"]
