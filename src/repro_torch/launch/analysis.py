"""Roofline terms of a dry-run program — the port of
``repro/launch/analysis.py`` for the H100.

The reference reads a compiled artifact (XLA's cost and memory analyses,
the partitioned HLO). The port's dry run has no compiled artifact: it
reads the per-rank cost record of :mod:`repro_torch.launch.cost` (the
local ops a rank runs, its collectives, the storages live at the peak).
Every number is per rank, so

  compute term    = flops_dev / PEAK_FLOPS
  memory term     = bytes_dev / HBM_BW
  collective term = coll_bytes_dev / COLL_BW

Hardware model: one NVIDIA H100 SXM5.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass

# NVIDIA H100 Tensor Core GPU data sheet, SXM5 column: dense BF16 tensor
# core peak (the sheet's 1,979 TFLOP/s is with sparsity)
PEAK_FLOPS = 989e12
# the same data sheet: 3.35 TB/s of HBM3 on the SXM5 part
HBM_BW = 3.35e12
# the link a collective over a 256-rank mesh is bound by: a (16, 16)
# mesh spans 32 nodes of 8 cards, so every mesh axis crosses nodes, and
# a card's traffic out of its node goes through its one ConnectX-7 NIC
# at 400 Gb/s (NVIDIA DGX H100 data sheet: eight 400 Gb/s ConnectX-7
# ports a node, one a card) = 50 GB/s a direction. Inside a node NVLink
# moves 450 GB/s a direction (the H100 data sheet's 900 GB/s, both
# directions), which bounds only the collectives that stay in a node.
COLL_BW = 50e9

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter",
                  "all-to-all", "collective-permute")


def collective_bytes(record) -> dict:
    """Collective bytes per kind of a cost record (per rank), with their
    counts under ``"_counts"``: the reference's record shape."""
    out = {op: float(record.coll_bytes.get(op, 0.0))
           for op in COLLECTIVE_OPS}
    out["_counts"] = {op: int(record.coll_counts.get(op, 0))
                      for op in COLLECTIVE_OPS}
    return out


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_dev: float
    bytes_dev: float
    coll_bytes_dev: float
    coll_breakdown: dict
    peak_memory_dev: float
    model_flops: float          # 6 * N_active * tokens (per rank share)
    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def roofline_fraction(self) -> float:
        """Compute term / the largest term: 1.0 = compute-bound; below,
        the gap is the memory or collective overhang."""
        bound = max(self.compute_s, self.memory_s, self.collective_s)
        return self.compute_s / bound if bound else 0.0

    def to_dict(self) -> dict:
        d = asdict(self)
        d["dominant"] = self.dominant
        d["roofline_fraction"] = self.roofline_fraction
        d["useful_flops_frac"] = (
            self.model_flops / self.flops_dev if self.flops_dev else 0.0)
        return d


def analyze(record, *, arch: str, shape, mesh_name: str, chips: int,
            model_flops_total: float) -> Roofline:
    """Roofline terms from a per-rank cost record
    (:class:`repro_torch.launch.cost.CostRecord`); ``shape`` is an
    ``InputShape`` or its name."""
    coll = collective_bytes(record)
    counts = coll.pop("_counts")
    return Roofline(
        arch=arch, shape=getattr(shape, "name", shape), mesh=mesh_name,
        chips=chips, flops_dev=float(record.flops),
        bytes_dev=float(record.bytes), coll_bytes_dev=record.coll_total,
        coll_breakdown={
            **{k: v for k, v in coll.items() if v},
            "counts": {k: v for k, v in counts.items() if v},
            "kernels": dict(record.kernels),
            "local_ops": record.ops,
        },
        peak_memory_dev=float(record.peak_bytes),
        model_flops=model_flops_total / chips,
        compute_s=record.flops / PEAK_FLOPS,
        memory_s=record.bytes / HBM_BW,
        collective_s=record.coll_total / COLL_BW,
    )


def model_flops_for(cfg, shape) -> float:
    """MODEL_FLOPS = 6 N D for train (forward + backward), 2 N D for
    inference; N = active params, D = tokens."""
    n = cfg.active_param_count()
    if shape.phase == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.phase == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch


__all__ = ["COLL_BW", "COLLECTIVE_OPS", "HBM_BW", "PEAK_FLOPS", "Roofline",
           "analyze", "collective_bytes", "model_flops_for"]
