"""Named dynamics scenarios (DESIGN.md §8).

A tiny registry turning a scenario name into a frozen
:class:`~repro_torch.configs.base.DynamicsConfig`. Every existing experiment
becomes a family: same model, data, topology and schedules — different
network weather. ``static`` is the identity scenario and reproduces the
historical (pre-netsim) trajectories bit-for-bit.

    from repro_torch.netsim import scenarios
    dyn = scenarios.get("markov_links", seed=3)
    TTHFTrainer(model, data, topo, algo, dynamics=dyn)
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import DynamicsConfig

SCENARIOS: dict[str, DynamicsConfig] = {
    # the idealized paper setting — no events, byte-identical trajectories
    "static": DynamicsConfig(name="static"),
    # links flap on a 2-state Markov chain (arXiv:2303.08988 regime):
    # ~20% of edges down in steady state, mean outage ~3 iterations
    "markov_links": DynamicsConfig(
        name="markov_links", p_link_fail=0.08, p_link_recover=0.35),
    # devices churn in and out; ~14% dark in steady state, and their
    # parameters freeze until they return
    "device_churn": DynamicsConfig(
        name="device_churn", p_device_drop=0.05, p_device_return=0.30),
    # 20% of devices have a heavy lognormal delay tail (median ~3.7x)
    "stragglers": DynamicsConfig(
        name="stragglers", straggler_frac=0.20,
        straggler_mu=1.0, straggler_sigma=0.5),
    # half the fleet vanishes for iterations [30, 50) and returns at
    # once — the mass-departure / mass-arrival stress test
    "flash_crowd": DynamicsConfig(
        name="flash_crowd", flash_at=30, flash_duration=20,
        flash_drop_frac=0.5),
}


def names() -> tuple[str, ...]:
    return tuple(SCENARIOS)


def get(name: str, seed: int = 0, **overrides) -> DynamicsConfig:
    """Resolve a scenario name; ``seed``/field overrides go through
    ``dataclasses.replace`` so configs stay frozen."""
    if name not in SCENARIOS:
        raise KeyError(
            f"unknown scenario {name!r}; choose from {sorted(SCENARIOS)}")
    return dataclasses.replace(SCENARIOS[name], seed=seed, **overrides)


__all__ = ["SCENARIOS", "get", "names"]
