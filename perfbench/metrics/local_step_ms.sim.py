"""The median device time, in ms, of the traced window's ``local_step``
spans (``repro_torch.core.tthf``: one a local SGD iteration of the whole
fleet, two CUDA events on the profiler's clock)."""
from perfbench import spans


def read(facts: dict, trace, cell) -> float | None:
    if facts.get("kind") != "sim" or "spans" not in facts or trace is None:
        return None
    return spans.median_device_ms(facts["spans"], "local_step", trace.lo,
                                  trace.hi)
