"""Model operations of the traced training intervals (the model
plug-in's ``window_flops``; for Mamba-2 ``counts.mamba2_train``: 6 N per
token plus the scan's and the convolution's, no recompute) over the
traced window's time at the card's float32 peak."""
from perfbench import harness
from perfbench.counts import peaks


def read(facts: dict, trace, cell) -> float | None:
    if facts.get("kind") != "scale" or trace is None \
            or not facts["intervals"]:
        return None
    flops = harness.model_plugin(cell.config).window_flops(
        cell.config, cell.traffic, facts["intervals"], facts)
    return 100.0 * flops / (trace.window_s * peaks.F32_FLOPS_PER_S)
