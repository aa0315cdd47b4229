"""The share of the traced interval, in %, in which the card ran nothing
while the host was inside a ``gc`` span (a garbage collection, recorded
by the sink while it is open); 0 where none fell in the window."""
from perfbench import spans


def read(facts: dict, trace, cell) -> float | None:
    if facts.get("kind") != "scale" or "spans" not in facts \
            or trace is None:
        return None
    return spans.idle_share_in(facts["spans"], "gc", trace.idle, trace.lo,
                               trace.hi)
