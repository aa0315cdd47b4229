"""The round-program resolver — the port of ``repro/rounds/resolver.py``,
for every program the reference resolves: the static topology, netsim
dynamics, a fog hierarchy and the control plane, in both modes.

:class:`RoundResolver` turns a :class:`~repro_torch.rounds.program.
RoundProgram` and a :class:`~repro_torch.core.topology.Network` into
events with one :class:`~repro_torch.rounds.program.Billing` each: per
iteration in simulation mode (:meth:`resolve`; it also knows the event
calendar ahead of time, :meth:`span_end`), per aggregation interval in
scale mode (:meth:`resolve_interval`).

It composes the static topology with an optional :class:`~repro_torch.
netsim.dynamics.TimeVaryingNetwork` (each iteration's snapshot: who is
up, the consensus matrices of the active subgraph, the straggler
multipliers), an optional :class:`~repro_torch.hierarchy.tree.
AggregationTree` (an aggregation is one composed ``(I, I)`` device
matrix, the ``matrix`` form) and an optional :class:`~repro_torch.
control.Controller` (per-cluster Γ from measured connectivity, a τ
retuned per aggregation in simulation mode, a straggler-biased draw).
Under the controller's τ law the aggregation calendar is the
controller's (``_agg_at``), and :meth:`span_end` stops there.

Sampling on the host (among available devices, down the fog tree, or
biased by the controller) draws from a numpy generator seeded by the
trainer's draw source (``draws.host_seed()``, where the reference seeds
it from the round's JAX key); the static draws come from
``draws.picks``. Everything here is host-side numpy; the scale
aggregation argument is a small tensor the step moves to its device, and
the refreshed mixing matrices live on the plan's device.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.netsim import faults
from repro_torch.obs.sink import NULL_OBS
from repro_torch.rounds.program import (
    AggregationSpec, Billing, ConsensusSpec, RoundEvent, RoundProgram,
    ScaleRoundEvent)


def host_rng(draws) -> np.random.Generator:
    """The host generator of one aggregation, seeded by the draw source
    (the reference seeds it from the round's JAX key)."""
    return np.random.default_rng(draws.host_seed())


class RoundResolver:
    """Per-round event resolution for both execution modes: built with
    :meth:`for_sim` (a ``TTHFConfig`` drives the calendar) or
    :meth:`for_scale` (a ``TTHFScaleConfig``, plus the step's
    :class:`~repro_torch.core.mixing.MixingPlan` for per-interval matrix
    refreshes)."""

    def __init__(self, net, program: RoundProgram, *, algo=None,
                 scale=None, plan=None, topo_weights: str = "metropolis"):
        if (algo is None) == (scale is None):
            raise ValueError("exactly one of algo (sim) / scale (scale "
                             "mode) drives the calendar")
        self.net = net
        self.program = program
        self.algo = algo
        self.scale = scale
        self.plan = plan
        self.dynamics = program.dynamics
        self.hierarchy = program.hierarchy if program.is_hierarchical else None
        self.tvnet = None
        if program.is_dynamic:
            from repro_torch.netsim.dynamics import TimeVaryingNetwork
            self.tvnet = TimeVaryingNetwork(net, program.dynamics,
                                            weights=topo_weights)
        self.tree = None
        if self.hierarchy is not None:
            from repro_torch.hierarchy import build_tree
            self.tree = build_tree(self.hierarchy, net.num_clusters,
                                   net.cluster_size)
        # a static or absent ControlConfig constructs NO controller: every
        # round resolves through the path without one
        self.controller = None
        if program.is_adaptive:
            from repro_torch.control import Controller
            self.controller = (
                Controller.for_sim(program.control, net, algo)
                if algo is not None
                else Controller.for_scale(program.control, net, scale))
        # the adaptive aggregation calendar: the next aggregation
        # iteration when the controller retunes τ (the static algo.tau
        # calendar otherwise)
        self._agg_at = algo.tau if algo is not None else None
        self._edges = net.num_d2d_edges()
        # observability sink (repro_torch.obs): trainers hand in the
        # run's sink; until then resolution spans/counters are no-ops
        self.obs = NULL_OBS

    # ------------------------------------------------------------------
    @classmethod
    def for_sim(cls, net, algo, program: RoundProgram,
                topo_weights: str = "metropolis") -> "RoundResolver":
        if program.is_adaptive:
            if algo.mode != "tthf":
                raise ValueError(
                    "the control plane retunes D2D consensus — star "
                    "baselines have no Γ/λ to control")
            if program.is_hierarchical:
                raise ValueError(
                    "control + fog hierarchy is not composed yet: the "
                    "multi-tier calendar would fight the τ law")
        if program.is_hierarchical:
            h = program.hierarchy
            if algo.mode != "tthf" or algo.full_participation:
                raise ValueError("hierarchical aggregation implies sampled "
                                 "tthf mode")
            if h.taus[0] != algo.tau:
                raise ValueError(f"tier-1 period {h.taus[0]} must equal "
                                 f"tau={algo.tau}")
            if h.sample[0] != algo.sample_per_cluster:
                raise ValueError(
                    "tier-1 fan-in must equal sample_per_cluster")
        return cls(net, program, algo=algo, topo_weights=topo_weights)

    @classmethod
    def for_scale(cls, net, scale, program: RoundProgram,
                  plan=None) -> "RoundResolver":
        # tau / fan-in cross-validation already ran in
        # make_tthf_train_step (the step and the resolver must agree)
        if program.is_adaptive:
            if program.is_hierarchical:
                raise ValueError(
                    "control + fog hierarchy is not composed yet")
            if plan is None:
                raise ValueError(
                    "adaptive control retunes Γ through per-interval W "
                    "refreshes — build the step refreshable (sync='tthf') "
                    "and pass its MixingPlan")
        return cls(net, program, scale=scale, plan=plan)

    # ------------------------------------------------------------------
    # the simulation calendar: event boundaries are known ahead of time
    # ------------------------------------------------------------------

    def is_aggregation_step(self, t: int) -> bool:
        """Aggregation calendar: the controller's retuned ``_agg_at`` when
        the τ law is active, the static ``algo.tau`` period otherwise."""
        if self.controller is not None and self.controller.adapts_tau:
            return t > 0 and t == self._agg_at
        return self.algo.is_aggregation_step(t)

    def is_event(self, t: int, eval_every: int) -> bool:
        """Does iteration t carry a consensus, aggregation or eval?"""
        return (self.algo.is_consensus_step(t)
                or self.is_aggregation_step(t)
                or (eval_every > 0 and t % eval_every == 0))

    def span_end(self, t: int, t_last: int, eval_every: int) -> int:
        """The first boundary iteration in [t, t_last]: the next
        consensus/aggregation/eval event, or t_last itself. Every
        iteration strictly before it is pure local SGD."""
        u = t
        while u < t_last and not self.is_event(u, eval_every):
            u += 1
        return u

    # ------------------------------------------------------------------
    # simulation mode: one event per boundary iteration
    # ------------------------------------------------------------------

    def resolve(self, t: int, draws=None) -> RoundEvent:
        """Resolve iteration ``t``'s events. A static aggregation's picks
        are drawn by the trainer (``draws.picks``), not here; an
        aggregation that samples on the host seeds its generator with
        ``draws.host_seed()``, called only where the reference seeds one
        from the round's key."""
        algo = self.algo
        net = self.net
        with self.obs.span("resolve", t=t):
            snap = (self.tvnet.snapshot(t)
                    if self.tvnet is not None else None)
            device_up = snap.device_up if snap is not None else None
            active = (int(snap.device_up.sum()) if snap is not None
                      else net.num_devices)
            billing = Billing()
            ctl = self.controller
            dec = None
            consensus = None
            if algo.is_consensus_step(t):
                consensus = self._consensus_spec(snap)
                if ctl is not None:
                    # the controller measures THIS event's connectivity;
                    # Γ is filled at event time by Controller.gamma_for
                    # with the trainer's fresh Υ measurement
                    dec = ctl.consensus_decision(t, snap)
                    consensus.control = dec
                billing.consensus_edges = consensus.edges
                if snap is not None:
                    billing.consensus_tail = faults.consensus_tail_mult(
                        snap.delay_mult, snap.device_up, snap.adj)
            aggregation = None
            if self.is_aggregation_step(t):
                if ctl is not None and dec is None:
                    dec = ctl.consensus_decision(t, snap)
                aggregation = self._sim_aggregation(t, snap, billing, draws,
                                                    dec=dec)
                if ctl is not None and ctl.adapts_tau:
                    self._agg_at = t + ctl.tau_decision(t, dec)
        self.obs.counter("resolver", active_devices=active,
                         consensus=int(consensus is not None),
                         aggregation=int(aggregation is not None))
        if dec is not None:
            self.obs.counter("control", **self.controller.counters())
        return RoundEvent(t=t, active_devices=active, device_up=device_up,
                          consensus=consensus, aggregation=aggregation,
                          billing=billing, control=dec)

    def _consensus_spec(self, snap) -> ConsensusSpec:
        if snap is None:
            return ConsensusSpec(edges=self._edges)
        return ConsensusSpec(edges=snap.num_active_edges(), V=snap.V,
                             lambdas=snap.lambdas,
                             active_sizes=snap.active_per_cluster,
                             device_up=snap.device_up)

    def _sim_aggregation(self, t, snap, billing: Billing, draws,
                         dec=None) -> Optional[AggregationSpec]:
        algo = self.algo
        net = self.net
        N, s = net.num_clusters, net.cluster_size

        if self.tree is not None:
            from repro_torch.hierarchy import build_event
            rng = host_rng(draws)
            up = (snap.device_up if snap is not None
                  else np.ones((N, s), bool))
            ev = build_event(rng, self.tree, self.hierarchy, t, up,
                             receive_offline=False)
            if ev is None or ev.total_uplinks == 0:
                # an all-dark fleet skips the event: no uplinks, no
                # broadcast, every model (and the global one) stays put
                return None
            billing.uplinks_by_level = dict(ev.uplinks_by_level)
            if snap is not None:
                billing.uplink_delay_mults = faults.uplink_tail_mults(
                    snap.delay_mult, ev.picks, ev.counts)
            return AggregationSpec(kind="matrix",
                                   device_matrix=ev.device_matrix,
                                   global_weights=ev.global_weights)

        full = algo.full_participation or algo.mode != "tthf"
        if snap is None:
            n_up = (net.num_devices if full
                    else N * algo.sample_per_cluster)
            billing.uplinks_by_level = {1: n_up}
            return AggregationSpec(kind="static", full=full)

        if full:
            weights = faults.full_participation_weights(
                snap.device_up, np.asarray(net.varrho))
            n_up = int(snap.device_up.sum())
            mults = snap.delay_mult[snap.device_up]
        else:
            # availability-aware cluster sampling on the host; an attached
            # connectivity controller biases the draw away from
            # stragglers (p ∝ up / delay), otherwise it is uniform among
            # the available devices
            rng = host_rng(draws)
            probs = (self.controller.sampling_probs(dec, snap)
                     if self.controller is not None else None)
            if probs is not None:
                from repro_torch.control.laws import sample_with_probs
                picks, counts = sample_with_probs(
                    rng, probs, k=algo.sample_per_cluster)
            else:
                picks, counts = faults.availability_sample(
                    rng, snap.device_up, k=algo.sample_per_cluster)
            weights = faults.aggregation_weights(
                picks, counts, snap.varrho, s)
            n_up = int(counts.sum())
            mults = faults.uplink_tail_mults(
                snap.delay_mult, picks, counts)
        if n_up == 0:
            # an all-dark fleet skips the event: no uplinks, no
            # broadcast, every model (and the global one) stays put
            return None
        billing.uplinks_by_level = {1: n_up}
        billing.uplink_delay_mults = mults
        return AggregationSpec(kind="weights", weights=weights,
                               device_up=snap.device_up)

    # ------------------------------------------------------------------
    # scale mode: one event per aggregation interval
    # ------------------------------------------------------------------

    def resolve_interval(self, interval: int, draws) -> ScaleRoundEvent:
        """Resolve interval ``interval`` (0-based): the step's aggregation
        argument (the step moves it to its device), the optional consensus-matrix
        refresh, and the interval's bill (local steps × τ, the interval's
        ``τ // consensus_every`` consensus events, the uplinks). It calls
        ``draws.host_seed()`` where the reference seeds a host generator
        from the interval's key, ``draws.picks`` otherwise: one draw an
        interval, whatever the sync."""
        with self.obs.span("resolve", interval=interval):
            ev = self._resolve_interval(interval, draws)
        self.obs.counter(
            "resolver",
            active_devices=ev.billing.local_devices // max(
                self.scale.tau, 1),
            refresh=int(ev.refresh is not None),
            root_served=int(ev.root_served))
        if ev.control is not None:
            self.obs.counter("control", **self.controller.counters())
        return ev

    def _resolve_interval(self, interval: int, draws) -> ScaleRoundEvent:
        scale = self.scale
        net = self.net
        N, s = scale.num_clusters, scale.cluster_size
        tau, k = scale.tau, scale.sample_per_cluster
        events = (tau // scale.consensus_every
                  if scale.consensus_every else 0)
        snap = (self.tvnet.snapshot(interval + 1)
                if self.tvnet is not None else None)
        ctl = self.controller
        dec = None
        gammas_ctl = None
        if ctl is not None:
            # measure this interval's connectivity and retune Γ by the
            # equal-contraction law; a cluster with no live D2D edge
            # runs (and bills) 0 rounds, as in the static schedule
            dec = ctl.consensus_decision(interval + 1, snap)
            gammas_ctl = ctl.scale_gammas(dec)
            if snap is not None:
                gammas_ctl = np.where(snap.num_active_edges() > 0,
                                      gammas_ctl, 0)
        refresh = None
        if self.plan is not None and (snap is not None
                                      or gammas_ctl is not None):
            from repro_torch.core.mixing import refresh_matrices
            refresh = refresh_matrices(
                self.plan, snap.V if snap is not None else self.net.V,
                gamma=gammas_ctl)

        def weights(picks, counts, varrho):
            return torch.as_tensor(faults.aggregation_weights(
                picks, counts, varrho, s), dtype=torch.float32)

        root_served = False
        mults = None
        up_level: Optional[dict] = None
        if self.tree is not None:
            from repro_torch.hierarchy import build_event
            rng = host_rng(draws)
            up = (snap.device_up if snap is not None
                  else np.ones((N, s), bool))
            # tier-1 period == tau, so every interval fires depth >= 1;
            # scale mode broadcasts into live subtrees regardless of
            # churn (replicas are physical shards)
            ev = build_event(rng, self.tree, self.hierarchy,
                             (interval + 1) * tau, up,
                             receive_offline=True)
            agg = torch.as_tensor(ev.device_matrix)
            root_served = (ev.global_weights is not None
                           and bool(ev.total_uplinks))
            if ev.total_uplinks:
                up_level = dict(ev.uplinks_by_level)
                if snap is not None:
                    mults = faults.uplink_tail_mults(
                        snap.delay_mult, ev.picks, ev.counts)
        elif snap is not None:
            rng = host_rng(draws)
            probs = (ctl.sampling_probs(dec, snap)
                     if ctl is not None else None)
            if probs is not None:
                from repro_torch.control.laws import sample_with_probs
                picks_np, counts = sample_with_probs(rng, probs, k=k)
            else:
                picks_np, counts = faults.availability_sample(
                    rng, snap.device_up, k=k)
            if refresh is not None:
                # the refreshable step aggregates with the full (N, s)
                # weight matrix, so EVERY sampled replica the ledger
                # bills actually enters the aggregate
                agg = weights(picks_np, counts, snap.varrho)
            else:
                # star/local sync: the picks argument is unused inside
                agg = torch.as_tensor(
                    np.where(counts > 0, picks_np[:, 0], 0))
            up_level = {1: int(counts.sum())}
            mults = faults.uplink_tail_mults(
                snap.delay_mult, picks_np, counts)
        elif ctl is not None:
            # static topology under control: the refreshable step takes
            # the (N, s) weight form, so the uniform draw goes through
            # the host generator and the weight builders
            rng = host_rng(draws)
            picks_np, counts = faults.availability_sample(
                rng, np.ones((N, s), bool), k=k)
            agg = weights(picks_np, counts, np.asarray(net.varrho))
            up_level = {1: N * k}
        elif k > 1:
            # static multi-sampling through the (N, s) weight form: all k
            # picks enter the aggregate, and the ledger bills N * k
            picks_np = draws.picks(N, s, k).cpu().numpy()
            counts = np.full((N,), k, np.int64)
            agg = weights(picks_np, counts, np.asarray(net.varrho))
            up_level = {1: N * k}
        else:
            agg = draws.picks(N, s, 1)
            up_level = {1: N}

        if snap is not None:
            gammas = (gammas_ctl if gammas_ctl is not None
                      else np.where(snap.num_active_edges() > 0,
                                    scale.gamma_d2d, 0))
            edges = snap.num_active_edges()
            tail = faults.consensus_tail_mult(
                snap.delay_mult, snap.device_up, snap.adj)
            local = int(snap.device_up.sum()) * tau
        else:
            gammas = (gammas_ctl if gammas_ctl is not None
                      else np.full((N,), scale.gamma_d2d))
            edges = self._edges
            tail = None
            local = scale.replicas * tau

        billing = Billing(local_devices=local, consensus_gammas=gammas,
                          consensus_edges=edges, consensus_tail=tail,
                          consensus_repeats=events,
                          uplinks_by_level=up_level,
                          uplink_delay_mults=mults)
        return ScaleRoundEvent(interval=interval, agg=agg, refresh=refresh,
                               root_served=root_served, billing=billing,
                               control=dec)


__all__ = ["RoundResolver", "host_rng"]
