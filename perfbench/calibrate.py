"""Readings that the limits of a cell's correctness check are set from.

    python3 perfbench/calibrate.py --workload <name> --seeds 1,2,3 \
        [--control-seeds 1,2,3] [--fault-seeds 1,2,3] [--out FILE]

For each seed, in one process: the program's set-up (the steps the
reference follows) against the reference (the lower readings); on the
control seeds the reference in the next precision below the
configuration's (TF32 products for float32 with TF32 off) against the
reference; on the fault seeds the reference with a fault planted (half
of each minibatch left out and the mean taken over the rest; the D2D
consensus left out) against the reference. A state left unchanged reads
1 on the change numbers and needs no run. Prints one JSON line per
reading, and appends them to ``--out``.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]

FAULTS = ("half_batch", "no_consensus")


def seeds(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=seeds, default=[])
    ap.add_argument("--control-seeds", type=seeds, default=[])
    ap.add_argument("--fault-seeds", type=seeds, default=[])
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    import torch
    from perfbench import harness
    from perfbench.drivers.common import Followed, compare, free
    cell = harness.Cell.load(args.workload)
    if not torch.cuda.is_available():
        print("perfbench: calibrate needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    driver = harness.load_module(
        harness.HERE / "drivers" / f"{cell.config['kind']}.py",
        f"perfbench_driver_{cell.config['kind']}")
    limits = {k: float("inf") for k in (
        "loss_gap", "grad_gap", "change_gap", "grad_gap_median",
        "change_gap_median", "ledger_mismatch")}

    def emit(seed, what, got, ref, t0):
        rec = {"workload": cell.name, "seed": seed, "reading": what,
               "seconds": round(time.perf_counter() - t0, 3),
               **{k: v["value"] for k, v in
                  compare(got, ref, limits).items()},
               "losses": got.losses, "ref_losses": ref.losses,
               "grad_leaves": harness.leaf_gaps(got.first, ref.first,
                                                ref.first),
               "change_leaves": harness.leaf_gaps(got.last, ref.last,
                                                  ref.first),
               "ref_first": ref.first}
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    every = sorted(set(args.seeds) | set(args.control_seeds)
                   | set(args.fault_seeds))
    for seed in every:
        t0 = time.perf_counter()
        ref = driver.follow(cell, seed, dev)
        if seed in args.seeds:
            t1 = time.perf_counter()
            res = driver.setup(cell, seed, dev)
            got = next(x for x in res if isinstance(x, Followed))
            del res
            free(dev)
            emit(seed, "program", got, ref, t1)
        if seed in args.control_seeds:
            t1 = time.perf_counter()
            emit(seed, "control_tf32",
                 driver.follow(cell, seed, dev, prec="tf32"), ref, t1)
        if seed in args.fault_seeds:
            for fault in FAULTS:
                t1 = time.perf_counter()
                emit(seed, f"fault_{fault}",
                     driver.follow(cell, seed, dev, fault=fault), ref, t1)
        free(dev)
        print(f"perfbench: seed {seed} in {time.perf_counter() - t0:.1f} s",
              file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
