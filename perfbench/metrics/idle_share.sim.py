"""Share of the traced window of the simulation in which the card ran no
kernel and no copy (torch.profiler, CUDA activity)."""


def read(facts: dict, trace, cell) -> float | None:
    if facts.get("kind") != "sim" or trace is None or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
