"""The least time the card could take for the traced simulation steps
(the larger of their operations at the float32 peak and their bytes at
the HBM peak, ``counts.sim_step``) over the traced window's time."""
from perfbench.counts import peaks, sim_step


def read(facts: dict, trace, cell) -> float | None:
    if facts.get("kind") != "sim" or trace is None or not facts["steps"]:
        return None
    flops, nbytes = sim_step.window_work(
        cell.config, facts["steps"], facts["consensus_events"],
        facts["aggregations"], facts["evals"])
    least = max(flops / peaks.F32_FLOPS_PER_S,
                nbytes / peaks.HBM_BYTES_PER_S)
    return 100.0 * least / trace.window_s
