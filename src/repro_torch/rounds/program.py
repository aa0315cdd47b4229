"""Declarative round programs (DESIGN.md §10).

The paper's Algorithm 1 — and its generalizations in Hosseinalipour et
al. 2020 (multi-stage fog) and Parasnis et al. 2023 (time-varying D2D)
— is one *schedule*: per iteration t, resolve who takes an SGD step,
which consensus matrices mix, which aggregation operator fires, and
what to bill. This module states that schedule as data:

* :class:`RoundProgram` — the frozen scenario declaration (which
  dynamics, which hierarchy). Trainers and ``launch/train.py`` build
  ONE program and hand it to a
  :class:`~repro.rounds.resolver.RoundResolver`, instead of threading
  per-scenario knobs through per-scenario loops.
* :class:`RoundEvent` / :class:`ScaleRoundEvent` — one resolved round:
  the device-up mask, the consensus spec (V/λ/active sizes), the
  aggregation operator in the existing weight/device-matrix forms, and
  a :class:`Billing` record.
* :class:`Billing` — the single ledger adapter. Every path that used
  to call :class:`~repro.core.energy.CommLedger` directly (six call
  sites across the two trainers) now assembles one ``Billing`` and
  ``charge()``s it, so sim and scale mode cannot diverge on pricing.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np

from repro_torch.configs.base import (
    ControlConfig, DynamicsConfig, HierarchyConfig)


@dataclass(frozen=True)
class RoundProgram:
    """What should happen each round, declaratively.

    ``dynamics``: an optional :class:`DynamicsConfig` — a static (or
    absent) config declares the idealized paper setting and resolves to
    the exact historical code path. ``hierarchy``: an optional
    :class:`HierarchyConfig` — a flat (L = 2) config IS two-timescale
    TT-HF and is likewise ignored. ``control``: an optional
    :class:`ControlConfig` — absent or ``static`` means NO controller
    is constructed and every round resolves through the historical
    path bit-for-bit; ``remark1``/``connectivity`` attach the online
    control plane (DESIGN.md §16). The program is frozen/hashable so
    it can ride in configs and jit static args.
    """
    dynamics: Optional[DynamicsConfig] = None
    hierarchy: Optional[HierarchyConfig] = None
    control: Optional[ControlConfig] = None

    @property
    def is_dynamic(self) -> bool:
        return self.dynamics is not None and not self.dynamics.is_static

    @property
    def is_hierarchical(self) -> bool:
        return self.hierarchy is not None and not self.hierarchy.is_flat

    @property
    def is_adaptive(self) -> bool:
        return self.control is not None and not self.control.is_static


@dataclass
class Billing:
    """One round's communication bill — the single
    :class:`~repro.core.energy.CommLedger` adapter.

    ``consensus_gammas`` may be None: simulation mode computes the
    Remark-1 adaptive round counts at event time, so the trainer passes
    the realized ``gamma_used`` to :meth:`charge`. ``consensus_repeats``
    covers scale mode, where one interval carries ``tau //
    consensus_every`` identical events. ``uplinks_by_level`` is None
    when nothing was transmitted (e.g. an all-dark simulation fleet
    skips the aggregation — no uplinks, no broadcast); a flat
    aggregation is simply ``{1: n}``.
    """
    local_devices: int = 0
    consensus_gammas: Optional[np.ndarray] = None
    consensus_edges: Optional[np.ndarray] = None
    consensus_tail: Optional[np.ndarray] = None
    consensus_repeats: int = 1
    uplinks_by_level: Optional[dict] = None
    uplink_delay_mults: Optional[np.ndarray] = None

    def charge(self, ledger, gamma_used: Optional[np.ndarray] = None):
        """Apply this bill to a ledger (the one home for pricing).

        One ``charge`` = one attribution event (``ledger.next_event``);
        consensus repeats replay ``record_consensus`` per repeat so the
        per-cluster attribution rows keep their cluster index (totals
        are identical to the concatenated form they replace).
        """
        ledger.next_event()
        if self.local_devices:
            ledger.record_local_step(self.local_devices)
        if self.consensus_edges is not None and self.consensus_repeats:
            g = (self.consensus_gammas if self.consensus_gammas is not None
                 else gamma_used)
            assert g is not None, \
                "adaptive consensus billing needs the realized gamma_used"
            for _ in range(self.consensus_repeats):
                ledger.record_consensus(
                    list(g), list(self.consensus_edges),
                    tail_mult_per_cluster=(
                        list(self.consensus_tail)
                        if self.consensus_tail is not None else None))
        if self.uplinks_by_level is not None:
            ledger.record_hierarchy_event(
                self.uplinks_by_level,
                uplink_delay_mults=self.uplink_delay_mults)


@dataclass
class ConsensusSpec:
    """One consensus event's inputs. ``V is None`` declares the static
    base topology (the trainer mixes with its build-time matrices);
    otherwise V/λ/active sizes come from the event's rebuilt active
    subgraph and clusters with no live edge are forced to Γ = 0."""
    edges: np.ndarray                        # (N,) live-edge counts
    V: Optional[np.ndarray] = None           # (N, s, s) event matrices
    lambdas: Optional[np.ndarray] = None     # (N,) component contractions
    active_sizes: Optional[np.ndarray] = None  # (N,) active device counts
    device_up: Optional[np.ndarray] = None   # (N, s) bool
    # the round's ControlDecision (repro.control) when a controller is
    # attached: the trainer fills Γ through Controller.gamma_for with
    # the event's fresh Υ instead of its built-in schedule
    control: Optional[Any] = None

    @property
    def dynamic(self) -> bool:
        return self.V is not None


@dataclass
class AggregationSpec:
    """One aggregation event as the existing operator forms.

    kind:
      * ``static`` — the historical jit-sampled eq. (7) (``full``
        selects full participation); the trainer draws inside the
        jitted aggregate with the round's ``k_agg`` key;
      * ``weights`` — one (N, s) per-device weight matrix
        (from ``netsim.faults``), broadcast masked by
        ``device_up``;
      * ``matrix`` — the composed (I, I) hierarchy device matrix,
        with the root's (I,) source weights when the root fired.
    """
    kind: str
    full: bool = False
    weights: Optional[np.ndarray] = None
    device_up: Optional[np.ndarray] = None
    device_matrix: Optional[np.ndarray] = None
    global_weights: Optional[np.ndarray] = None


@dataclass
class RoundEvent:
    """One resolved simulation round (iteration ``t``).

    ``billing.local_devices`` is 0 here: the trainer bills the local
    SGD steps of the whole scanned span (which ends at ``t``) itself.
    """
    t: int
    active_devices: int
    device_up: Optional[np.ndarray]          # (N, s) bool; None = all up
    consensus: Optional[ConsensusSpec]
    aggregation: Optional[AggregationSpec]
    billing: Billing = field(default_factory=Billing)
    # the round's ControlDecision when a controller is attached (the
    # same object as consensus.control when both events fire) — obs
    # joins its fields into the round's metrics row
    control: Optional[Any] = None


@dataclass
class ScaleRoundEvent:
    """One resolved scale-mode interval: the jitted step's aggregation
    argument (picks / weight matrix / device matrix — whatever form the
    step was built for), the optional per-interval consensus-matrix
    refresh, whether the served global model should snapshot after the
    step (a live hierarchy root event), and the interval's full bill."""
    interval: int
    agg: Any
    refresh: Optional[Any]
    root_served: bool
    billing: Billing
    control: Optional[Any] = None            # interval's ControlDecision


__all__ = [
    "AggregationSpec", "Billing", "ConsensusSpec", "RoundEvent",
    "RoundProgram", "ScaleRoundEvent",
]
