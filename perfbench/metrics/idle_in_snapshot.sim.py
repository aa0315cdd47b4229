"""The share of the traced window, in %, in which the card ran nothing
while the host was inside a ``netsim.snapshot`` span (a build of the
churned network's snapshot, ``repro_torch.netsim.dynamics``)."""
from perfbench import spans


def read(facts: dict, trace, cell) -> float | None:
    if facts.get("kind") != "sim" or "spans" not in facts or trace is None:
        return None
    return spans.idle_share_in(facts["spans"], "netsim.snapshot",
                               trace.idle, trace.lo, trace.hi)
