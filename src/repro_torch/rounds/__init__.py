"""repro_torch.rounds — the round-program engine (static sim programs).

A frozen :class:`RoundProgram` declares the scenario and a
:class:`RoundResolver` compiles it against a network into per-round
events with one :class:`Billing` record each.
"""
from repro_torch.rounds.program import (
    AggregationSpec, Billing, ConsensusSpec, RoundEvent, RoundProgram,
    ScaleRoundEvent)
from repro_torch.rounds.resolver import RoundResolver

__all__ = [
    "AggregationSpec", "Billing", "ConsensusSpec", "RoundEvent",
    "RoundProgram", "RoundResolver", "ScaleRoundEvent",
]
