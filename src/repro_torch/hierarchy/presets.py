"""Named hierarchy presets (``--hierarchy`` registry) — a copy of
``repro/hierarchy/presets.py``.

Mirrors :mod:`repro_torch.netsim.scenarios`: a name resolves to a frozen
:class:`~repro_torch.configs.base.HierarchyConfig`, parameterized by the base
aggregation period tau (tier periods are fixed multiples of it, so the
same preset serves any trainer cadence). ``flat`` is the identity
preset — plain two-timescale TT-HF, routed through the historical code
path bit-for-bit.

    from repro_torch.hierarchy import presets
    hier = presets.get("fog3", tau=20)
    TTHFTrainer(model, data, topo, algo, hierarchy=hier)
"""
from __future__ import annotations

from repro_torch.configs.base import HierarchyConfig

# name -> (levels, per-tier period multiples of tau, per-tier fan-in)
_SPECS: dict[str, tuple[int, tuple[int, ...], tuple[int, ...]]] = {
    # today's TT-HF: one aggregation tier = the global server
    "flat": (2, (1,), (1,)),
    # one fog tier: edge nodes aggregate every tau, the root every 2tau
    "fog3": (3, (1, 2), (1, 0)),
    # two fog tiers: tau / 2tau / 4tau
    "fog4": (4, (1, 2, 4), (1, 0, 0)),
    # fog tier + cluster-sampling at the root: the root samples 2 edge
    # nodes per event instead of hearing all of them
    "fog3_sampled": (3, (1, 2), (1, 2)),
}


def names() -> tuple[str, ...]:
    return tuple(_SPECS)


def get(name: str, tau: int = 20, **overrides) -> HierarchyConfig:
    """Resolve a preset name at a concrete base period ``tau``."""
    if name not in _SPECS:
        raise KeyError(
            f"unknown hierarchy preset {name!r}; choose from "
            f"{sorted(_SPECS)}")
    levels, mults, sample = _SPECS[name]
    cfg = dict(levels=levels, taus=tuple(m * tau for m in mults),
               sample=sample)
    cfg.update(overrides)
    return HierarchyConfig(**cfg)


__all__ = ["get", "names"]
