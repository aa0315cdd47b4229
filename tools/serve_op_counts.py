#!/usr/bin/env python3
"""The ATen operations of the bare (unsharded) serve paths of two source
trees, counted on the CPU.

Run from the root of a checkout, with a second tree unpacked beside it
(e.g. ``git archive <commit> | tar -x -C build/parent``):

    python3 tools/serve_op_counts.py --roots build/parent .

For each root, a process of its own imports ``repro_torch`` from
``<root>/src`` and drives four small traces through the serve CLI's
``run_scheduler_trace`` on the CPU, with no mesh, under a
``TorchDispatchMode`` that counts every ATen operation: reduced
qwen1.5-0.5b (paged), mamba2-370m (continuous), recurrentgemma-9b
(paged) and llama4-scout (paged), 6 requests of up to 32 prompt tokens
and 16 new tokens, 4 slots. Prints, a trace, both roots' decode steps
and operation counts and every operation whose count differs. A count
follows from the code and the trace, not from the machine, so it shows
what a change adds to the host's work on the card's paths without a
card.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
from pathlib import Path

TRACES = (("qwen1.5-0.5b", "paged"), ("mamba2-370m", "continuous"),
          ("recurrentgemma-9b", "paged"), ("llama4-scout-17b-a16e", "paged"))


def worker() -> None:
    """Count the operations of every trace with the package on the
    path; print one JSON object."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.configs import get_arch
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models import build_model

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops[str(func)] += 1
            return func(*args, **(kwargs or {}))

    torch.set_num_threads(1)
    device = torch.device("cpu")
    out = {}
    for arch, sched in TRACES:
        args = serve_cli.parse_args(
            ["--arch", arch, "--reduced", "--scheduler", sched, "--batch",
             "4", "--prompt-len", "32", "--gen", "16", "--requests", "6",
             "--temperature", "0", "--device", "cpu", "--page-size", "8"])
        cfg = get_arch(arch).reduced()
        model = build_model(cfg)
        params = serve_cli.init_params(model, args, device)
        count = Count()
        with count:
            _, stats, _, _ = serve_cli.run_scheduler_trace(
                args, cfg, model, device, params)
        out[arch] = {"decode_steps": stats.decode_steps,
                     "ops": dict(count.ops)}
    print(json.dumps(out))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--roots", nargs=2, metavar=("A", "B"),
                    default=["build/parent", "."])
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker()
        return 0
    counts = []
    for root in args.roots:
        env = {**os.environ, "OMP_NUM_THREADS": "1",
               "PYTHONPATH": str(Path(root).resolve() / "src")}
        proc = subprocess.run([sys.executable, __file__, "--worker"],
                              env=env, capture_output=True, text=True)
        if proc.returncode:
            print(proc.stderr[-4000:], file=sys.stderr)
            return 1
        counts.append(json.loads(proc.stdout.splitlines()[-1]))
    a, b = counts
    for arch, _ in TRACES:
        ka, kb = a[arch]["ops"], b[arch]["ops"]
        print(f"{arch}: A {a[arch]['decode_steps']} decode steps, "
              f"{sum(ka.values())} ops; B {b[arch]['decode_steps']} decode "
              f"steps, {sum(kb.values())} ops")
        for op in sorted(set(ka) | set(kb)):
            if ka.get(op, 0) != kb.get(op, 0):
                print(f"    {op}: A {ka.get(op, 0)}, B {kb.get(op, 0)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
