"""repro_torch.netsim — time-varying network dynamics (DESIGN.md §8).

Event-driven churn / link-failure / straggler simulation layered
between ``core/topology.py`` and the trainers: seeded event streams
(:mod:`events`), per-event consensus-matrix rebuilds
(:mod:`dynamics`), availability-aware sampling and straggler pricing
(:mod:`faults`), and a named-scenario registry (:mod:`scenarios`).
"""
from repro_torch.netsim.dynamics import (
    NetworkSnapshot, TimeVaryingNetwork, check_masked_assumption2,
    component_spectral_radius, connected_components,
    masked_cluster_weights, measured_lambdas, power_iteration_radius,
)
from repro_torch.netsim.events import EventStream, NetworkEvent
from repro_torch.netsim.faults import (
    aggregation_weights, availability_sample, consensus_tail_mult,
    full_participation_weights, renormalized_varrho, uplink_tail_mults,
    weighted_global_pytree,
)
from repro_torch.netsim import scenarios

__all__ = [
    "EventStream", "NetworkEvent", "NetworkSnapshot",
    "TimeVaryingNetwork", "aggregation_weights", "availability_sample",
    "check_masked_assumption2", "component_spectral_radius",
    "connected_components", "consensus_tail_mult",
    "full_participation_weights", "masked_cluster_weights",
    "measured_lambdas", "power_iteration_radius",
    "renormalized_varrho", "scenarios", "uplink_tail_mults",
    "weighted_global_pytree",
]
