"""``fused_consensus_sgd``'s bytes bound (``counts.fused_consensus_sgd``
at the flat (N, s, P) replica buffer, one call per consensus block of
the traced window) over its device time by kernel name in the trace."""
from perfbench.counts import fused_consensus_sgd, peaks


def read(facts: dict, trace, cell) -> float | None:
    launches = facts.get("fused_consensus_sgd_launches", 0)
    t = trace.kernel_s("fused_consensus_sgd_kernel") if trace else 0.0
    if facts.get("kind") != "scale" or not launches or t <= 0:
        return None
    tr = cell.traffic
    s = tr["cluster_size"]
    nbytes = launches * fused_consensus_sgd.call_bytes(
        tr["replicas"] // s, s, cell.config["parameters"])
    return 100.0 * nbytes / peaks.HBM_BYTES_PER_S / t
