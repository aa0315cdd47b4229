#!/usr/bin/env python3
"""The bare (unsharded) serve paths of two source trees on one card, in
turns.

Run from the root of a checkout on a machine with an NVIDIA H100, with a
second tree unpacked beside it (e.g. ``git archive <commit> | tar -x -C
build/parent``):

    python3 tools/serve_turns.py --roots build/parent . --order ABBA

Each turn is a process of its own that imports ``repro_torch`` from one
root (``<root>/src``), builds its kernels, and drives four traces of
``chip_smoke.py`` through the serve CLI's ``run_scheduler_trace`` after a
short warm-up of each, with no mesh:

- ``serve``: qwen1.5-0.5b, the paged scheduler with ``paged_decode``
  (32 requests, prompts of 512, 128 new tokens, chunks of 256);
- ``serve-ssm``: mamba2-370m, the continuous scheduler with
  ``ssd_scan`` (32 requests, 128 new tokens);
- ``serve-hybrid``: recurrentgemma-9b, the paged scheduler (8 requests,
  prompts up to 3,072, 64 new tokens);
- ``serve-moe``: llama4-scout at full width and depth 4, the paged
  scheduler (16 requests, prompts of 512, 64 new tokens).

Each turn prints one JSON line a trace (root, wall seconds, tokens,
decode steps, tokens/s); the script then prints every turn's tokens/s
a trace, the card's name and power limit, and checks that every turn of
a trace generated the same tokens.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

CELLS = {
    "serve": (["--arch", "qwen1.5-0.5b", "--scheduler", "paged", "--batch",
               "8", "--prompt-len", "512", "--gen", "128", "--requests",
               "32", "--prefill-chunk", "256", "--prefix-template", "128",
               "--temperature", "0"], None),
    "serve-ssm": (["--arch", "mamba2-370m", "--scheduler", "continuous",
                   "--batch", "8", "--prompt-len", "512", "--gen", "128",
                   "--requests", "32", "--prefix-template", "128",
                   "--temperature", "0"], None),
    "serve-hybrid": (["--arch", "recurrentgemma-9b", "--scheduler",
                      "paged", "--batch", "8", "--prompt-len", "3072",
                      "--gen", "64", "--requests", "8", "--prefill-chunk",
                      "256", "--temperature", "0"], None),
    "serve-moe": (["--arch", "llama4-scout-17b-a16e", "--scheduler",
                   "paged", "--batch", "8", "--prompt-len", "512", "--gen",
                   "64", "--requests", "16", "--prefill-chunk", "256",
                   "--prefix-template", "128", "--temperature", "0"], 4),
}
WARM = ["--requests", "2", "--gen", "4"]


def worker(root: str, cells: list) -> None:
    """One turn: every trace of ``cells`` with ``root``'s package."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels.build import build
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models import build_model

    build()
    device = torch.device("cuda")
    for cell in cells:
        argv, layers = CELLS[cell]
        args = serve_cli.parse_args(argv)
        cfg = get_arch(args.arch)
        if layers:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        model = build_model(cfg)
        params = serve_cli.init_params(model, args, device)
        serve_cli.run_scheduler_trace(serve_cli.parse_args(argv + WARM),
                                      cfg, model, device, params)
        _, stats, arrivals, wall = serve_cli.run_scheduler_trace(
            args, cfg, model, device, params)
        print(json.dumps({
            "root": root, "cell": cell, "wall": wall,
            "tokens": stats.tokens_generated,
            "decode_steps": stats.decode_steps,
            "tokens_per_s": stats.tokens_generated / wall,
            "out": {r.rid: list(r.out_tokens) for _, r in arrivals}}),
            flush=True)
        del params, model
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--roots", nargs=2, metavar=("A", "B"),
                    default=["build/parent", "."])
    ap.add_argument("--order", default="ABBA",
                    help="the turns, a letter each (A, B)")
    ap.add_argument("--cells", default=",".join(CELLS))
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    cells = args.cells.split(",")
    if args.worker:
        worker(args.worker, cells)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("serve_turns: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    rows = []
    for turn, letter in enumerate(args.order):
        root = args.roots["AB".index(letter)]
        env = {**os.environ,
               "PYTHONPATH": str(Path(root).resolve() / "src")}
        t0 = time.time()
        proc = subprocess.run(
            [sys.executable, __file__, "--worker", root, "--cells",
             args.cells], env=env, capture_output=True, text=True)
        if proc.returncode:
            print(proc.stderr[-4000:], file=sys.stderr)
            return 1
        for line in proc.stdout.splitlines():
            if line.startswith("{"):
                rows.append({**json.loads(line), "turn": turn,
                             "letter": letter})
        print(f"turn {turn} ({letter}: {root}) {time.time() - t0:.1f} s",
              flush=True)
    print(card)
    ok = True
    for cell in cells:
        mine = [r for r in rows if r["cell"] == cell]
        same = all(r["out"] == mine[0]["out"] for r in mine)
        ok &= same
        print(f"{cell}: " + ", ".join(
            f"{r['letter']} {r['tokens_per_s']:.1f} tokens/s "
            f"({r['wall']:.3f} s, {r['decode_steps']} steps)"
            for r in mine) + f"; the same tokens in every turn: {same}")
    for r in rows:
        del r["out"]
    print(json.dumps({"card": card, "rows": rows}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
