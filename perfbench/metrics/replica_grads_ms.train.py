"""The median device time, in ms, of the traced interval's
``replica_grads`` spans (``repro_torch.core.distributed``: one a
replica's loss and gradients, two CUDA events on the profiler's
clock)."""
from perfbench import spans


def read(facts: dict, trace, cell) -> float | None:
    if facts.get("kind") != "scale" or "spans" not in facts \
            or trace is None:
        return None
    return spans.median_device_ms(facts["spans"], "replica_grads",
                                  trace.lo, trace.hi)
