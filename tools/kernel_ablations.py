#!/usr/bin/env python3
"""Where the time of the port's redesigned kernels goes, by ablation.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 tools/kernel_ablations.py

It builds variants of ``csrc/paged_decode.cu``,
``csrc/fused_consensus_sgd.cu`` and ``csrc/ssd_scan.cu``, each with one
part of the kernel taken
out, with the port's nvcc flags (into ``<build dir>/ablations``), and
times them in turns (A B C ... C B A, twice) beside the kernel as built,
at the shapes of ``chip_smoke.py``:

- ``paged_decode`` at the serve shape and at the balanced one (all 8
  slots at position 639), pools rotated past the L2: *as built*; *no
  merge* (each block leaves after writing its partial: no fence, atomic
  or merge); *no K/V load* (the ``cp.async`` copies not issued: the
  kernel computes on stale shared memory); *exit at once* (every block
  leaves after reading pos); and an empty launch
  (``torch.cuda._sleep(0)``), the floor of a launch in a queue. The
  variants' outputs are not checked: only the kernel as built computes
  the function.
- ``fused_sgd`` at ``(4, 464,118,784)`` f32: *as built* (a grid that
  covers the array, one tile a block, one vector of w and of g a
  thread); *two vectors a thread*; *few waves* (the grid capped at 8
  blocks an SM, each block striding over many tiles); and
  ``torch.add(w, g, alpha=-eta)``.
- ``ssd_scan`` at the main paths' grouped calls (B/C ``(1, 512, 128)``
  and ``(8, 1024, 128)``, 32 heads, x in the model's layout), inputs
  rotated past the L2: *as built*; *no first launch* (the scan reads
  whatever the scratch holds for G and the chunk states); *no chunk
  states* (the first launch forms G only); *whole-chunk states* (one
  block a chunk's state, not the wrapper's parts); *no carried-state
  term* (no C stages); *no cp.async overlap* (each stage waits for every
  copy issued); *no tensor-core products*
  (every ``mma.sync`` an empty asm statement, its operands still
  formed); *no early launch* (the scan launched after the first grid
  ends, not beside it); *exit at once* (both kernels leave at their
  start); and an empty launch.

Each patch names the line it replaces and fails if the line is gone, so
an edited source breaks this script loudly rather than quietly. It
prints the card's name and power limit, one line a measurement and a
JSON object of the means (µs for ``paged_decode`` and ``ssd_scan``, ms
for ``fused_sgd``) as its last line.
"""
from __future__ import annotations

import ctypes
import itertools
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

# variant -> [(line in the source, its replacement)]
PAGED = {
    "as built": [],
    "no merge": [("  // 5. arrive;", "  return;  //")],
    "no K/V load": [("      cp_async16(",
                     "      if (n_split < 0) cp_async16(")],
    "exit at once": [("  if (rows <= 0) return;",
                      "  if (rows != -2147483647) return;")],
}
SGD = {
    "as built": [],
    "two vectors a thread": [("constexpr int kSgdUnroll = 1;",
                              "constexpr int kSgdUnroll = 2;")],
    "few waves": [("      static_cast<unsigned>(need < kSgdMaxBlocks ? need : "
                   "kSgdMaxBlocks);",
                   "      static_cast<unsigned>(need < 132 * 8 ? need : "
                   "132 * 8);")],
}

SSD = {
    "as built": [],
    "no first launch": [("  ssd_prep_kernel<T><<<",
                         "  if (Tn < 0) ssd_prep_kernel<T><<<")],
    "no chunk states": [
        ("  const int64_t n_state = rows * (P / kPT) * nc * nsplit;",
         "  const int64_t n_state = 0;")],
    "whole-chunk states": [
        ("           int hpg, int Tn, int P, int S, int Q, int nsplit,\n"
         "           const Strides& st, void* stream) {",
         "           int hpg, int Tn, int P, int S, int Q, int nsplit_in,\n"
         "           const Strides& st, void* stream) {\n"
         "  const int nsplit = nsplit_in > 0 ? 1 : 0;")],
    "no carried-state term": [
        ("  const int nC = c > 0 ? Sp / kKS : 0;",
         "  const int nC = c < 0 ? Sp / kKS : 0;")],
    "no cp.async overlap": [("    cp_wait<kSlots - 1>();",
                             "    cp_wait<0>();")],
    "no tensor-core products": [
        ('  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "',
         '  asm("// "')],
    "no early launch": [
        ("  attr[0].val.programmaticStreamSerializationAllowed = 1;",
         "  attr[0].val.programmaticStreamSerializationAllowed = 0;")],
    "exit at once": [
        ("  // the Gram grid's G and the chunk states are read from here on",
         "  if (Tn > 0) return;"),
        ("  const int nc = (Tn + Q - 1) / Q;\n  if (static_cast<int>(blockIdx.x)"
         " < n_gram) {",
         "  const int nc = (Tn + Q - 1) / Q;\n  if (Tn > 0) return;\n"
         "  if (static_cast<int>(blockIdx.x) < n_gram) {")],
}


def patched(source: Path, patches) -> str:
    text = source.read_text()
    for old, new in patches:
        if old not in text:
            raise RuntimeError(f"{source.name} no longer has {old!r}")
        text = text.replace(old, new)
    return text


def build_variants() -> dict:
    """(source name, variant) -> the loaded library, built in parallel."""
    from repro_torch.kernels import build
    out_dir = build.BUILD_DIR / "ablations"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, variants in (("paged_decode", PAGED),
                           ("fused_consensus_sgd", SGD), ("ssd_scan", SSD)):
        for i, (variant, patches) in enumerate(variants.items()):
            src = out_dir / f"{name}_{i}.cu"
            src.write_text(patched(build.CSRC / f"{name}.cu", patches))
            lib = out_dir / f"lib{name}_{i}.so"
            jobs[name, variant] = (lib, subprocess.Popen(
                [build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (lib, proc) in jobs.items():
        report, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{report}")
        libs[key] = ctypes.CDLL(str(lib))
    return libs


def in_turns(calls: dict, timer) -> dict:
    """Each call timed in the order A B ... B A, twice; the list of times
    by name."""
    order = list(calls) + list(calls)[::-1]
    times = {name: [] for name in calls}
    for name in order + order:
        times[name].append(timer(calls[name]))
    return times


def main() -> int:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import fused_sgd as fs
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.kernels import ssd_scan as ss

    if not torch.cuda.is_available():
        print("kernel_ablations: no CUDA device", file=sys.stderr)
        return 1
    print(cs.card_line(), flush=True)
    libs = build_variants()
    load = build.load

    def with_lib(fn, lib):
        def call():
            build.load = lambda name: lib
            try:
                return fn()
            finally:
                build.load = load
        return call

    result = {"paged_decode_us": {}, "fused_sgd_ms": {}, "ssd_scan_us": {}}
    for label, spec in (("serve", cs.PAGED_CASES["qwen-serve"]),
                        ("balanced", cs.PAGED_BALANCED)):
        q, pools, pm, pos, window = cs.paged_inputs(spec, torch.float32,
                                                    seed=1, copies=4)
        turn = itertools.cycle(pools)
        calls = {v: with_lib(lambda: pd.paged_decode(q, *next(turn), pm, pos,
                                                     window=window),
                             libs["paged_decode", v]) for v in PAGED}
        calls["empty launch"] = lambda: torch.cuda._sleep(0)
        times = in_turns(calls, lambda fn: cs.device_ms(fn, iters=400) * 1e3)
        result["paged_decode_us"][label] = {}
        for name, ts in times.items():
            result["paged_decode_us"][label][name] = float(np.mean(ts))
            print(f"paged_decode {label} {name}: "
                  f"{' '.join(f'{t:.2f}' for t in ts)} us, mean "
                  f"{np.mean(ts):.2f} us", flush=True)
        del pools
        torch.cuda.empty_cache()

    for label, shape in cs.SSD_GROUP_SHAPES.items():
        sets = cs.ssd_group_inputs(shape, torch.float32, seed=50,
                                   copies=16 if label == "serve" else 2)
        turn = itertools.cycle(sets)
        calls = {v: with_lib(lambda: ss.ssd_scan_heads(*next(turn),
                                                       chunk=shape[-1]),
                             libs["ssd_scan", v]) for v in SSD}
        calls["empty launch"] = lambda: torch.cuda._sleep(0)
        iters = 200 if label == "serve" else 10
        times = in_turns(calls,
                         lambda fn: cs.device_ms(fn, iters=iters) * 1e3)
        result["ssd_scan_us"][label] = {}
        for name, ts in times.items():
            result["ssd_scan_us"][label][name] = float(np.mean(ts))
            print(f"ssd_scan {label} {shape} f32 {name}: "
                  f"{' '.join(f'{t:.2f}' for t in ts)} us, mean "
                  f"{np.mean(ts):.2f} us", flush=True)
        del sets
        torch.cuda.empty_cache()

    gen = torch.Generator(device="cuda").manual_seed(7)
    w = torch.randn((4, cs.QWEN_P), generator=gen, device="cuda")
    g = torch.randn((4, cs.QWEN_P), generator=gen, device="cuda")
    eta = torch.tensor(cs.SCALE_LR, device="cuda")
    calls = {v: with_lib(lambda: fs.fused_sgd(w, g, eta),
                         libs["fused_consensus_sgd", v]) for v in SGD}
    calls["torch.add"] = lambda: torch.add(w, g, alpha=-cs.SCALE_LR)
    for fn in calls.values():
        cs.cuda_ms(fn, iters=5)
    times = in_turns(calls, lambda fn: cs.cuda_ms(fn, iters=20, warmup=2))
    for name, ts in times.items():
        result["fused_sgd_ms"][name] = float(np.mean(ts))
        print(f"fused_sgd (4, {cs.QWEN_P}) f32 {name}: "
              f"{' '.join(f'{t:.4f}' for t in ts)} ms, mean "
              f"{np.mean(ts):.4f} ms", flush=True)
    print(cs.card_line(), flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
