"""The TT-HF simulation's work (Algorithm 1 over the one-hidden-layer
network, I devices, minibatch B), event by event.

* A local step: forward and backward of every device's minibatch,
  6 B (m h + h C) operations a device (two for the forward products,
  four for the backward's); it reads each device's parameters and
  minibatch once and writes the parameters once.
* A consensus event: ``consensus_mix`` on every leaf (its bytes).
* An aggregation: reads the N sampled devices' parameters, writes every
  device's.
* An evaluation: two forwards over all I D points (loss, accuracy),
  reading the global model and the points, and the dispersion and
  consensus error of the history, each a read of the fleet.
"""
from perfbench.counts import consensus_mix


def dims(cfg: dict) -> dict:
    m, topo = cfg["model"], cfg["topology"]
    mm = m["dim"] * m["hidden"] + m["hidden"] * m["classes"]
    sizes = [m["hidden"], m["classes"], m["dim"] * m["hidden"],
             m["hidden"] * m["classes"]]
    return {"I": topo["devices"], "N": topo["clusters"], "B": cfg["batch"],
            "dim": m["dim"], "mm": mm, "P": sum(sizes), "sizes": sizes,
            "points": cfg["data"]["points"]}


def window_work(cfg: dict, steps: int, consensus_events: int,
                aggregations: int, evals: int) -> tuple[float, float]:
    """-> (operations, bytes) of a stretch of the run."""
    d = dims(cfg)
    I, P = d["I"], d["P"]
    flops = steps * 6 * I * d["B"] * d["mm"] \
        + evals * 2 * 2 * d["points"] * d["mm"]
    nbytes = steps * (2 * I * P * 4 + I * d["B"] * (d["dim"] + 1) * 4) \
        + consensus_events * consensus_mix.event_bytes(d["sizes"], I,
                                                       d["N"]) \
        + aggregations * (d["N"] + I) * P * 4 \
        + evals * (P * 4 + d["points"] * (d["dim"] + 1) * 4
                   + 2 * I * P * 4)
    return float(flops), float(nbytes)
