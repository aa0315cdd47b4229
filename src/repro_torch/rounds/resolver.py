"""The round-program resolver — the port of ``repro/rounds/resolver.py``
for the static program in both modes and netsim dynamics in simulation
mode.

:class:`RoundResolver` turns a :class:`~repro_torch.rounds.program.
RoundProgram` and a :class:`~repro_torch.core.topology.Network` into
events with one :class:`~repro_torch.rounds.program.Billing` each: per
iteration in simulation mode (:meth:`resolve`; it also knows the event
calendar ahead of time, :meth:`span_end`), per aggregation interval in
scale mode (:meth:`resolve_interval`).

Under netsim dynamics a :class:`~repro_torch.netsim.dynamics.
TimeVaryingNetwork` supplies each iteration's snapshot: who is up, the
consensus matrices of the active subgraph, the straggler multipliers.
Availability-aware sampling draws on the host, from a numpy generator
seeded by the trainer's draw source (``draws.host_seed()``, where the
reference seeds it from the round's JAX key).

Not ported yet, and refused with ``NotImplementedError`` (ROADMAP.md
Queue 1 item 4): fog hierarchies, the control plane, dynamics in scale
mode, and more than one sampled replica per cluster in scale mode.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.netsim import faults
from repro_torch.obs.sink import NULL_OBS
from repro_torch.rounds.program import (
    AggregationSpec, Billing, ConsensusSpec, RoundEvent, RoundProgram,
    ScaleRoundEvent)


class RoundResolver:
    """Event resolution: per iteration in simulation mode (built with
    :meth:`for_sim`), for the static program or under netsim dynamics;
    per interval in scale mode (:meth:`for_scale`), for the static
    program."""

    def __init__(self, net, program: RoundProgram, *, algo=None,
                 scale=None, topo_weights: str = "metropolis"):
        if (algo is None) == (scale is None):
            raise ValueError("exactly one of algo (sim) / scale (scale "
                             "mode) drives the calendar")
        if program.is_hierarchical or program.is_adaptive:
            raise NotImplementedError(
                "the port resolves the static round program and netsim "
                "dynamics in simulation mode; fog hierarchies and the "
                "control plane are ROADMAP.md Queue 1 item 4")
        self.net = net
        self.program = program
        self.algo = algo
        self.scale = scale
        self.tvnet = None
        if program.is_dynamic:
            from repro_torch.netsim.dynamics import TimeVaryingNetwork
            self.tvnet = TimeVaryingNetwork(net, program.dynamics,
                                            weights=topo_weights)
        self._edges = net.num_d2d_edges()
        # observability sink: resolution spans/counters are no-ops
        self.obs = NULL_OBS

    @classmethod
    def for_sim(cls, net, algo, program: RoundProgram,
                topo_weights: str = "metropolis") -> "RoundResolver":
        return cls(net, program, algo=algo, topo_weights=topo_weights)

    @classmethod
    def for_scale(cls, net, scale, program: RoundProgram) -> "RoundResolver":
        if program.is_dynamic:
            raise NotImplementedError(
                "the port's scale mode runs the static program; netsim "
                "dynamics in scale mode (the weights aggregation form with "
                "per-interval refreshes) are ROADMAP.md Queue 1 item 4")
        if scale.sample_per_cluster != 1:
            raise NotImplementedError(
                "the port's scale mode samples one replica per cluster; "
                "sample_per_cluster > 1 (the weights aggregation form) is "
                "ROADMAP.md Queue 1 item 4")
        return cls(net, program, scale=scale)

    # ------------------------------------------------------------------
    # the simulation calendar: event boundaries are known ahead of time
    # ------------------------------------------------------------------

    def is_aggregation_step(self, t: int) -> bool:
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
        are drawn by the trainer (``draws.picks``), not here; a sampled
        aggregation under dynamics seeds its host generator with
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
            consensus = None
            if algo.is_consensus_step(t):
                consensus = self._consensus_spec(snap)
                billing.consensus_edges = consensus.edges
                if snap is not None:
                    billing.consensus_tail = faults.consensus_tail_mult(
                        snap.delay_mult, snap.device_up, snap.adj)
            aggregation = None
            if self.is_aggregation_step(t):
                aggregation = self._sim_aggregation(snap, billing, draws)
        self.obs.counter("resolver", active_devices=active,
                         consensus=int(consensus is not None),
                         aggregation=int(aggregation is not None))
        return RoundEvent(t=t, active_devices=active, device_up=device_up,
                          consensus=consensus, aggregation=aggregation,
                          billing=billing)

    def _consensus_spec(self, snap) -> ConsensusSpec:
        if snap is None:
            return ConsensusSpec(edges=self._edges)
        return ConsensusSpec(edges=snap.num_active_edges(), V=snap.V,
                             lambdas=snap.lambdas,
                             active_sizes=snap.active_per_cluster,
                             device_up=snap.device_up)

    def _sim_aggregation(self, snap, billing: Billing,
                         draws) -> Optional[AggregationSpec]:
        algo = self.algo
        net = self.net
        N, s = net.num_clusters, net.cluster_size
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
            # availability-aware cluster sampling: a uniform draw among
            # the available devices, on the host, from a generator the
            # draw source seeds (the reference seeds it from the round's
            # JAX key)
            rng = np.random.default_rng(draws.host_seed())
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
        """Resolve interval ``interval`` (0-based): the step's picks, one
        per cluster from the trainer's draw source (drawn for every
        sync, as the reference draws them), and the interval's bill:
        tau local steps on every replica, the interval's ``tau //
        consensus_every`` consensus events and N uplinks."""
        scale = self.scale
        N, s = scale.num_clusters, scale.cluster_size
        with self.obs.span("resolve", interval=interval):
            picks = draws.picks(N, s, 1)
            billing = Billing(
                local_devices=scale.replicas * scale.tau,
                consensus_gammas=np.full((N,), scale.gamma_d2d),
                consensus_edges=self._edges,
                consensus_repeats=(scale.tau // scale.consensus_every
                                   if scale.consensus_every else 0),
                uplinks_by_level={1: N})
        self.obs.counter("resolver", active_devices=scale.replicas,
                         refresh=0, root_served=0)
        return ScaleRoundEvent(interval=interval, agg=picks, refresh=None,
                               root_served=False, billing=billing)


__all__ = ["RoundResolver"]
