"""``consensus_mix``'s bytes bound (``counts.consensus_mix``, every call
of the traced window: one per parameter leaf and consensus event) over
its device time by kernel name in the trace."""
from perfbench.counts import consensus_mix, peaks, sim_step


def read(facts: dict, trace, cell) -> float | None:
    launches = facts.get("consensus_mix_launches", 0)
    t = trace.kernel_s("consensus_mix_kernel") if trace else 0.0
    if facts.get("kind") != "sim" or not launches or t <= 0:
        return None
    d = sim_step.dims(cell.config)
    if launches % len(d["sizes"]):
        return None
    events = launches // len(d["sizes"])
    nbytes = events * consensus_mix.event_bytes(d["sizes"], d["I"], d["N"])
    return 100.0 * nbytes / peaks.HBM_BYTES_PER_S / t
