"""The shape of a driver's run and what drivers share."""
from __future__ import annotations

import math
import time
from dataclasses import dataclass


@dataclass
class Run:
    """What ``run.py`` asks of a driver."""
    cell: object                # harness.Cell
    seed: int
    seconds: float
    trace: bool
    device: object              # torch.device
    t_start: float              # process start, perf_counter

    def setup_s(self) -> float:
        return time.perf_counter() - self.t_start


@dataclass
class Outcome:
    """What a driver hands back to ``run.py``."""
    end_to_end: dict            # name -> value (trace 0)
    facts: dict                 # what the per-layer readers read (trace 1)
    checks: dict                # name -> {"value", "limit"}
    attempted: int
    failed: int
    peak_bytes: int
    trace: object = None        # harness.Trace


def intervals_for(seconds: float, per_call: float) -> int:
    """The fewest calls that cover ``seconds`` at ``per_call`` each."""
    return max(1, math.ceil(seconds / max(per_call, 1e-9)))


def peak_bytes(device) -> int:
    if getattr(device, "type", device) != "cuda":
        return 0
    import torch
    return int(torch.cuda.max_memory_allocated(device))


def free(device) -> None:
    import gc
    gc.collect()
    if getattr(device, "type", device) == "cuda":
        import torch
        torch.cuda.empty_cache()


@dataclass
class Followed:
    """What the program or the reference produced over the steps the
    reference follows: each step's (or evaluation's) loss, every leaf's
    change after the first step and after the last, and the
    communication counts."""
    losses: list
    first: dict
    last: dict
    ledger: dict


def compare(got: Followed, ref: Followed, limits: dict) -> dict:
    """The numbers ``correct`` is decided by, each beside its limit: the
    cell's limits name the numbers it compares. ``*_gap`` is the worst
    leaf's gap of the change norms, ``*_gap_median`` the median leaf's
    (:func:`perfbench.harness.leaf_gaps`)."""
    import statistics

    from perfbench import harness
    grad = harness.leaf_gaps(got.first, ref.first, ref.first)
    change = harness.leaf_gaps(got.last, ref.last, ref.first)
    values = {
        "loss_gap": max(harness.rel_gap(a, b)
                        for a, b in zip(got.losses, ref.losses))
        if len(got.losses) == len(ref.losses) else math.inf,
        "grad_gap": max(grad.values()),
        "change_gap": max(change.values()),
        "grad_gap_median": statistics.median(grad.values()),
        "change_gap_median": statistics.median(change.values()),
        "ledger_mismatch": sum(abs(got.ledger[k] - ref.ledger[k])
                               for k in ref.ledger),
    }
    return harness.checks({k: values[k] for k in limits}, limits)


def log(msg: str) -> None:
    import sys
    print(f"perfbench: {msg}", file=sys.stderr, flush=True)
