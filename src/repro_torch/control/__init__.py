"""repro_torch.control — the online connectivity-aware control plane, a
numpy copy of ``repro/control/``.

Each round the :class:`~repro_torch.control.controller.Controller`
consumes measured network state (power-iteration spectral-gap estimates
on the event's active subgraph), online gradient statistics (the
``core/theory.py`` δ/σ estimators over a sliding window), and trainer
divergence measurements, and retunes per-cluster Γ, the aggregation
period τ, and the sampling weights — all under a safety envelope that
checks the Theorem-2 tunable-parameter conditions and falls back to the
static schedule when they fail. The :class:`~repro_torch.rounds.
resolver.RoundResolver` threads decisions into each round's specs, so
both trainers pick them up through the one round-program loop.
"""
from repro_torch.control.controller import ControlDecision, Controller
from repro_torch.control.estimator import (
    OnlineGradStats, static_measured_lambdas)
from repro_torch.control.policies import POLICIES, get_policy
from repro_torch.control import laws

__all__ = [
    "ControlDecision", "Controller", "OnlineGradStats", "POLICIES",
    "get_policy", "laws", "static_measured_lambdas",
]
