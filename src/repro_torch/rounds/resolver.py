"""The round-program resolver — the port of ``repro/rounds/resolver.py``
for the static program, in both modes.

:class:`RoundResolver` turns a :class:`~repro_torch.rounds.program.
RoundProgram` and a :class:`~repro_torch.core.topology.Network` into
events with one :class:`~repro_torch.rounds.program.Billing` each: per
iteration in simulation mode (:meth:`resolve`; it also knows the event
calendar ahead of time, :meth:`span_end`), per aggregation interval in
scale mode (:meth:`resolve_interval`).

Only the static program is ported: no netsim dynamics, no fog
hierarchy, no control plane, and one sampled replica per cluster in
scale mode. Anything else raises ``NotImplementedError`` (ROADMAP.md,
Queue 1 item 4).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.obs.sink import NULL_OBS
from repro_torch.rounds.program import (
    AggregationSpec, Billing, ConsensusSpec, RoundEvent, RoundProgram,
    ScaleRoundEvent)


class RoundResolver:
    """Event resolution for the static program: per iteration in
    simulation mode (built with :meth:`for_sim`), per interval in scale
    mode (:meth:`for_scale`)."""

    def __init__(self, net, program: RoundProgram, *, algo=None,
                 scale=None):
        if (algo is None) == (scale is None):
            raise ValueError("exactly one of algo (sim) / scale (scale "
                             "mode) drives the calendar")
        if program.is_dynamic or program.is_hierarchical \
                or program.is_adaptive:
            raise NotImplementedError(
                "the port resolves the static round program only; netsim "
                "dynamics, fog hierarchies and the control plane are "
                "ROADMAP.md Queue 1 item 4")
        self.net = net
        self.program = program
        self.algo = algo
        self.scale = scale
        self._edges = net.num_d2d_edges()
        # observability sink: resolution spans/counters are no-ops
        self.obs = NULL_OBS

    @classmethod
    def for_sim(cls, net, algo, program: RoundProgram) -> "RoundResolver":
        return cls(net, program, algo=algo)

    @classmethod
    def for_scale(cls, net, scale, program: RoundProgram) -> "RoundResolver":
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

    def resolve(self, t: int) -> RoundEvent:
        """Resolve iteration ``t``'s events. The static aggregation's
        picks are drawn by the trainer (its draw source), not here."""
        with self.obs.span("resolve", t=t):
            billing = Billing()
            consensus = None
            if self.algo.is_consensus_step(t):
                consensus = ConsensusSpec(edges=self._edges)
                billing.consensus_edges = consensus.edges
            aggregation = None
            if self.is_aggregation_step(t):
                aggregation = self._sim_aggregation(billing)
        self.obs.counter("resolver", active_devices=self.net.num_devices,
                         consensus=int(consensus is not None),
                         aggregation=int(aggregation is not None))
        return RoundEvent(t=t, active_devices=self.net.num_devices,
                          device_up=None, consensus=consensus,
                          aggregation=aggregation, billing=billing)

    def _sim_aggregation(self, billing: Billing
                         ) -> Optional[AggregationSpec]:
        algo = self.algo
        net = self.net
        full = algo.full_participation or algo.mode != "tthf"
        n_up = (net.num_devices if full
                else net.num_clusters * algo.sample_per_cluster)
        billing.uplinks_by_level = {1: n_up}
        return AggregationSpec(kind="static", full=full)

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
