"""Algorithm 1 — the TT-HF simulation engine; the port of ``repro/core/
tthf.py``: the static topology, netsim dynamics, the fog hierarchy and the
control plane.

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

Under netsim dynamics (``dynamics=``, :mod:`repro_torch.netsim`) a dark
device takes no step and holds its parameters, each consensus event
mixes with the event's V on the active subgraph, and an aggregation
weighs the available devices and broadcasts only to them. Under a fog
hierarchy (``hierarchy=``, :mod:`repro_torch.hierarchy`) an aggregation
is one composed ``(I, I)`` device matrix applied to every leaf (the
``matrix`` form), and the served global model changes only when the root
fires. Under the control plane (``program=RoundProgram(control=...)``,
:mod:`repro_torch.control`) Γ comes from the controller's law on each
event's fresh Υ, and the ``connectivity`` policy's gradient probe feeds
its δ̂/σ̂ estimators at every aggregation, from minibatches of a stream
of its own (``draws.probe_minibatch``).

``run(obs=...)`` takes an observability sink (:mod:`repro_torch.obs`):
spans of the two timescales, and per round the measured divergence
beside the theory's bounds (the ``round`` record), the comms
attribution (``comm``) and, at evaluations, ‖∇F(ŵ)‖ (``eval``). The
probes only read the fleet, so an instrumented run equals a bare one.

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

from repro_torch.configs.base import (
    DynamicsConfig, HierarchyConfig, TTHFConfig, TopologyConfig)
from repro_torch.core import consensus as cns
from repro_torch.core import mixing
from repro_torch.core import sampling as smp
from repro_torch.core.energy import CommLedger
from repro_torch.core.schedule import (
    adaptive_gamma_info, fixed_gamma, make_lr_schedule)
from repro_torch.core.topology import Network, build_network
from repro_torch.data.synth import FederatedDataset
from repro_torch.hierarchy.aggregate import (
    apply_device_matrix_pytree, global_from_weights)
from repro_torch.kernels.runtime import DeviceLike, resolve_device
from repro_torch.models.simple import SimModel
from repro_torch.netsim.faults import weighted_global_pytree
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
                 dynamics: Optional[DynamicsConfig] = None,
                 hierarchy: Optional[HierarchyConfig] = None,
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
        # ``dynamics``/``hierarchy`` are sugar for a round program; a
        # static (or absent) dynamics config resolves to the static path
        if program is None:
            program = RoundProgram(dynamics=dynamics, hierarchy=hierarchy)
        elif dynamics is not None or hierarchy is not None:
            raise ValueError("pass either program= or the dynamics=/"
                             "hierarchy= kwargs, not both")
        self.program = program
        self._resolver = RoundResolver.for_sim(
            self.net, algo, program, topo_weights=topo_cfg.weights)
        self.dynamics = program.dynamics
        self.hierarchy = self._resolver.hierarchy
        self.tvnet = self._resolver.tvnet
        self.tree = self._resolver.tree
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
        # observability (built at the first instrumented run)
        self._obs_probe = None
        self._obs_grad_probe = None
        self._obs_gauges = None

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
    def _local_step(self, params: dict, idx: torch.Tensor, eta_t: float,
                    dark: Optional[torch.Tensor] = None) -> None:
        """One SGD iteration (eqs. 8-9) for every device, in place.
        idx: (I, B) minibatch indices into each device's points; dark:
        (I,) bool, the devices that are offline (netsim churn). A dark
        device takes no step: its rows of the update are zeroed (a fill,
        so a non-finite gradient there cannot leak), leaving its
        parameters bitwise as they were, without a second copy of the
        fleet."""
        rows = torch.arange(idx.shape[0], device=self.device)[:, None]
        grads = self.model.grads(params, self.x[rows, idx],
                                 self.y[rows, idx])
        with torch.no_grad():
            for k, g in grads.items():
                g.mul_(eta_t)
                if dark is not None:
                    g.masked_fill_(dark.view((-1,) + (1,) * (g.ndim - 1)), 0)
                params[k].sub_(g)

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
    def _upsilon_dyn(self, params: dict,
                     device_up: torch.Tensor) -> torch.Tensor:
        """Definition-2 divergence over ACTIVE devices, max over leaves."""
        ups = [cns.masked_divergence_upsilon(z, device_up)
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
    def _consensus_event(self, st: TTHFState, spec,
                         eta_t: torch.Tensor) -> tuple[np.ndarray, int]:
        """One consensus event from a resolved :class:`~repro_torch.
        rounds.program.ConsensusSpec`; replaces st.params and returns
        ``(per-cluster rounds used, clamp events)``. A static spec mixes
        on the base topology; a dynamic one mixes with the event's V on
        the active subgraph, and a cluster with no live edge neither
        runs nor bills rounds. A spec carrying a controller's decision
        gets Γ from the controller's law on the event's fresh Υ instead
        of the built-in schedule."""
        algo = self.algo
        N = self.net.num_clusters
        dev = self.device
        dec = spec.control
        sat = 0
        if dec is not None:
            if spec.dynamic:
                ups = self._upsilon_dyn(
                    st.params, torch.as_tensor(spec.device_up, device=dev))
                sizes = np.asarray(spec.active_sizes)
            else:
                ups = self._upsilon(st.params)
                sizes = self.net.cluster_size
            gamma = torch.as_tensor(self._resolver.controller.gamma_for(
                dec, float(eta_t), ups.cpu().numpy(), sizes), device=dev)
            sat = dec.gamma_saturated
        elif algo.gamma_d2d >= 0:
            gamma = fixed_gamma(N, algo.gamma_d2d, dev)
        else:
            if spec.dynamic:
                ups = self._upsilon_dyn(
                    st.params, torch.as_tensor(spec.device_up, device=dev))
                lambdas = torch.as_tensor(spec.lambdas, dtype=torch.float32,
                                          device=dev)
                sizes = torch.as_tensor(spec.active_sizes, dtype=torch.int32,
                                        device=dev)
            else:
                ups = self._upsilon(st.params)
                lambdas, sizes = self.lambdas, self.net.cluster_size
            gamma, sat_mask = adaptive_gamma_info(
                eta_t, algo.phi, ups, lambdas, sizes, self.model_dim)
            sat = int(sat_mask.sum())
        V = self.V
        if spec.dynamic:
            edges = torch.as_tensor(spec.edges, device=dev)
            gamma = torch.where(edges == 0, 0, gamma)
            V = torch.as_tensor(spec.V, dtype=torch.float32, device=dev)
        st.params = mixing.mix_pytree(st.params, V, gamma, N,
                                      backend=self.backend)
        return gamma.cpu().numpy(), sat

    @torch.no_grad()
    def _apply_aggregation(self, st: TTHFState, spec) -> None:
        """Apply a resolved aggregation, in one of three forms: the
        sampled (or full) eq. (7) on the static topology; the
        availability-aware weights under dynamics, broadcast only to the
        devices that are up (offline devices cannot hear the server); or
        a fog hierarchy's composed (I, I) device matrix on every leaf,
        where the served global model changes only when the root fired
        (``global_weights`` set)."""
        dev = self.device
        if spec.kind == "static":
            g, st.params = self._aggregate(st.params, st.draws,
                                           full=spec.full)
        elif spec.kind == "weights":
            w = torch.as_tensor(spec.weights, dtype=torch.float32,
                                device=dev)
            g = weighted_global_pytree(st.params, w, self.net.num_clusters)
            up = torch.as_tensor(spec.device_up.reshape(-1), device=dev)
            for k, leaf in st.params.items():
                leaf[up] = g[k]
        else:                       # "matrix": the fog hierarchy
            g = st.global_params
            if spec.global_weights is not None:
                g = global_from_weights(
                    st.params, torch.as_tensor(spec.global_weights,
                                               device=dev))
            st.params = apply_device_matrix_pytree(
                st.params, torch.as_tensor(spec.device_matrix, device=dev))
        st.global_params = g

    def _local_span(self, st: TTHFState, t_from: int, t_to: int) -> int:
        """Run the pure local-SGD iterations t_from..t_to (inclusive);
        updates st.params in place and returns the device-steps taken.
        Under dynamics each iteration's snapshot says who is up."""
        I, D = self.y.shape
        live = 0
        for u in range(t_from, t_to + 1):
            idx = st.draws.minibatch(I, self.batch_size, D)
            dark = None
            if self.tvnet is None:
                live += I
            else:
                up = self.tvnet.snapshot(u).device_up.reshape(-1)
                live += int(up.sum())
                if not up.all():
                    dark = torch.as_tensor(~up, device=self.device)
            self._local_step(st.params, idx.to(self.device),
                             float(self.eta(u - 1)), dark)
        return live

    # ------------------------------------------------------------------
    # observability — read-only probes + theory gauges
    # ------------------------------------------------------------------
    def _ensure_obs(self):
        from repro_torch.obs.telemetry import (
            TheoryGauges, default_constants, make_divergence_probe,
            make_sim_grad_probe)

        if self._obs_probe is None:
            self._obs_probe = make_divergence_probe(
                self.net.num_clusters, self.net.cluster_size,
                self.net.varrho)
            self._obs_grad_probe = make_sim_grad_probe(
                self.model, self.x, self.y)
        if self._obs_gauges is None:
            algo = self.algo
            k = default_constants(float(np.min(self.net.varrho)))
            if algo.constant_lr > 0:
                self._obs_gauges = TheoryGauges(
                    constants=k, tau=algo.tau, model_dim=self.model_dim,
                    phi=algo.phi, lr=algo.constant_lr)
            else:
                self._obs_gauges = TheoryGauges(
                    constants=k, tau=algo.tau, model_dim=self.model_dim,
                    phi=algo.phi, gamma=algo.gamma, alpha=algo.alpha)

    def _upsilon_for(self, st: TTHFState, spec) -> np.ndarray:
        """Pre-mixing Definition-2 divergence for a consensus event —
        the measured Υ_c that Lemma 1's bound takes as input."""
        if spec.dynamic:
            ups = self._upsilon_dyn(
                st.params, torch.as_tensor(spec.device_up,
                                           device=self.device))
        else:
            ups = self._upsilon(st.params)
        return ups.cpu().numpy()

    def _emit_round_telemetry(self, obs, st: TTHFState, b: int, ev,
                              gamma_used, ups_pre, eta_b, t_prev_agg: int,
                              ledger_mark: int, gamma_sat: int = 0) -> None:
        """One drain per round: the probe over the round's fleet, then
        the measured quantities, the theory-bound gauges and the round's
        comms attribution into the shared JSONL stream (same ``step``
        for all three)."""
        from repro_torch.obs.telemetry import emit_comm

        aux = {k: v.cpu().numpy()
               for k, v in self._obs_probe(st.params).items()}
        rec = {"active_devices": ev.active_devices, "eta": float(eta_b),
               **aux}
        rec.update(self._obs_gauges.round_gauges(b, t_prev_agg))
        if ev.consensus is not None:
            spec = ev.consensus
            lambdas = spec.lambdas if spec.dynamic else self.net.lambdas
            sizes = (spec.active_sizes if spec.dynamic
                     else self.net.cluster_size)
            rec["gamma_used"] = gamma_used
            rec["upsilon_pre"] = ups_pre
            rec["lemma1_bound"] = self._obs_gauges.lemma1(
                lambdas, gamma_used, sizes, ups_pre)
            rec["gamma_saturated"] = gamma_sat
            rec["gamma_saturated_total"] = self._gamma_saturated_total
        if ev.control is not None:
            # controller decisions + measured-vs-assumed spectral gap,
            # joined into the SAME row as the Lemma-1/Prop-1 gauges
            rec.update(ev.control.round_fields())
        obs.emit("round", b, **rec)
        emit_comm(obs, self.ledger, ledger_mark, b)

    # ------------------------------------------------------------------
    # control-plane measurements: the gradient statistics of the online
    # δ̂/σ̂ estimators, from the draw source's probe stream (the training
    # draws are untouched)
    # ------------------------------------------------------------------
    @torch.no_grad()
    def _probe_grads(self, global_params: dict, x: torch.Tensor,
                     y: torch.Tensor, out: np.ndarray) -> None:
        """Every device's gradient at the global iterate on its own
        points ``x (I, B, m)``, written into ``out (I, M)`` on the host
        leaf by leaf in the reference's flat order (sorted keys)."""
        I = x.shape[0]
        fleet = {k: v.expand((I,) + tuple(v.shape))
                 for k, v in global_params.items()}
        with torch.enable_grad():
            g = self.model.grads(fleet, x, y)
        dst = torch.from_numpy(out)
        off = 0
        for k in sorted(g):
            n = g[k][0].numel()
            dst[:, off:off + n].copy_(g[k].reshape(I, n))
            off += n
        del g

    def _observe_control_grads(self, st: TTHFState) -> None:
        """Feed the controller's window: per-cluster mean gradients (δ̂)
        and ``sgd_probe_draws`` minibatch gradients per device (σ̂), all
        at the fresh global iterate. The reference's probe returns
        ``G (I, M)`` and ``Gmb (I, K, M)`` and copies both to the host;
        here they are built there one ``(I, M)`` block at a time, so the
        card holds one block of gradients, not K + 1."""
        ctl = self._resolver.controller
        K = ctl.cfg.sgd_probe_draws
        I, D = self.y.shape
        idx = st.draws.probe_minibatch(
            I, K, self.batch_size, D, ctl.cfg.estimator_seed + 0x51F0
        ).to(self.device)
        M = self.model_dim
        G = np.empty((I, M), np.float32)
        self._probe_grads(st.global_params, self.x, self.y, G)
        Gmb = np.empty((I, K, M), np.float32)
        rows = torch.arange(I, device=self.device)[:, None]
        for k in range(K):
            sel = idx[:, k]
            self._probe_grads(st.global_params, self.x[rows, sel],
                              self.y[rows, sel], Gmb[:, k])
        N, s = self.net.num_clusters, self.net.cluster_size
        ctl.observe_cluster_grads(G.reshape(N, s, -1).mean(axis=1),
                                  np.asarray(self.net.varrho))
        ctl.observe_fleet_noise(Gmb, G)

    # ------------------------------------------------------------------
    def run(self, steps: int, seed: int = 0, eval_every: int = 5,
            state: TTHFState | None = None,
            record_dispersion: bool = True,
            obs=None) -> tuple[TTHFState, History]:
        """Drive Algorithm 1: the resolver names each boundary
        iteration's events; the local-SGD iterations up to it run, then
        the consensus event (if any) before the aggregation (if any),
        the controller's gradient probe after an aggregation (the
        ``connectivity`` policy), then the round's bill, the round's
        telemetry when ``obs`` is a live sink (default: ``NULL_OBS``)
        and, on eval iterations, the history."""
        assert eval_every >= 1, "eval_every must be a positive period"
        obs = obs if obs is not None else NULL_OBS
        st = state or self.init(seed)
        if obs.enabled:
            self._ensure_obs()      # model_dim is set by init()
        self._resolver.obs = obs
        hist = History()
        res = self._resolver
        ctl = res.controller
        if ctl is not None:
            ctl.bind(model_dim=self.model_dim,
                     eta_fn=lambda u: float(self.eta(u)))
        N = self.net.num_clusters
        t_last = st.t + steps
        t_prev_agg = st.t           # Σ_t spans since the last aggregation
        t = st.t + 1
        with obs.span("run", mode="sim", steps=steps, t0=st.t):
            while t <= t_last:
                b = res.span_end(t, t_last, eval_every)
                with obs.span("round", t=b):
                    with obs.span("interval", t_from=t, t_to=b):
                        live = self._local_span(st, t, b)
                    self.ledger.record_local_step(live)

                    eta_b = self.eta(b - 1)
                    ev = res.resolve(b, st.draws)
                    ups_pre = None
                    if ev.consensus is not None and obs.enabled:
                        ups_pre = self._upsilon_for(st, ev.consensus)
                    gamma_used = np.zeros((N,), np.int32)
                    gamma_sat = 0
                    if ev.consensus is not None:
                        with obs.span("consensus_event", t=b):
                            gamma_used, gamma_sat = self._consensus_event(
                                st, ev.consensus, eta_b)
                        self._gamma_saturated_total += gamma_sat
                    if ev.aggregation is not None:
                        with obs.span("aggregation", t=b,
                                      kind=ev.aggregation.kind):
                            self._apply_aggregation(st, ev.aggregation)
                        if ctl is not None and ctl.wants_grad_stats:
                            self._observe_control_grads(st)
                    ledger_mark = len(self.ledger.events)
                    ev.billing.charge(self.ledger, gamma_used)
                    if obs.enabled:
                        self._emit_round_telemetry(
                            obs, st, b, ev, gamma_used, ups_pre, eta_b,
                            t_prev_agg, ledger_mark, gamma_sat)
                    if ev.aggregation is not None:
                        t_prev_agg = b

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
                        if obs.enabled:
                            obs.emit("eval", b, loss=loss, acc=acc,
                                     grad_norm=float(self._obs_grad_probe(
                                         st.global_params)))
                t = b + 1

        st.t += steps
        obs.flush()
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
