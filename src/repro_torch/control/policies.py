"""The control-policy registry — a copy of ``repro/control/policies.py``.

Three named policies, resolvable from ``launch/train.py --control``:

* ``static`` — the controller is OFF. The resolver never constructs
  one; every code path is the exact historical (pre-control) one, and
  ``tests/test_torch_control.py`` asserts the trajectories are bitwise
  identical in both trainers.
* ``remark1`` — the paper's Remark-1 adaptive Γ run *through* the
  control plane: assumed (eigendecomposition) contraction factors,
  measured Υ, the Theorem-2 safety envelope, and saturation counting.
* ``connectivity`` — the full connectivity-aware plane: Γ from
  power-iteration estimates on each event's active subgraph, online
  δ̂/σ̂-driven τ retuning (sim mode), and availability/straggler-aware
  sampling weights.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import CONTROL_POLICIES, ControlConfig

POLICIES: dict[str, str] = {
    "static": "controller off — exact historical trajectories",
    "remark1": "Remark-1 adaptive Γ with assumed λ, under the envelope",
    "connectivity": "measured-λ Γ + τ retuning + biased sampling",
}
assert tuple(POLICIES) == CONTROL_POLICIES


def get_policy(name: str, **overrides) -> ControlConfig:
    """Resolve a policy name (plus optional ControlConfig field
    overrides) into a frozen :class:`~repro_torch.configs.base.
    ControlConfig` ready to ride in a
    :class:`~repro_torch.rounds.program.RoundProgram`."""
    if name not in POLICIES:
        raise KeyError(
            f"unknown control policy {name!r}; choose from "
            f"{sorted(POLICIES)}")
    cfg = ControlConfig(policy=name)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


__all__ = ["POLICIES", "get_policy"]
