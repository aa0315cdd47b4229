#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It drives the port's four main paths — the paper's Algorithm 1 in
simulation mode at the paper's Sec. IV size (125 devices in 25 clusters,
the 784-7840-10 NN), TT-HF as the scale-mode sync strategy on the
full-size qwen1.5-0.5b (24 layers, d 1024, vocabulary 151,936), paged
continuous-batching serving of the same model, and continuous-batching
serving of the full-size mamba2-370m (48 Mamba-2 layers, d 1024, 32 SSD
heads of 64, state 128) — and holds every kernel of those paths against
its plain PyTorch version.
Phases (any failure ends the run with a non-zero exit; nothing is
caught):

1. build   — compile every CUDA source of the port with nvcc (sm_90a),
             one nvcc per source, all started together; print ptxas's
             registers, shared memory and spills of every instance of
             ``fused_sgd_kernel``, ``paged_decode_kernel``,
             ``ssd_prep_kernel`` and ``ssd_scan_kernel``.
2. kernels — each kernel against its plain version on the card:
             ``consensus_mix`` at the shapes of tests/test_kernels.py and
             of the sim path, f32 (atol 1e-5) and bf16 (atol 2e-2);
             ``fused_consensus_sgd`` and ``fused_sgd`` at the shapes of
             tests/test_kernels.py with wd in {0, 0.1} (atol 1e-6 in f32,
             1e-2 in bf16; ``fused_sgd`` bitwise equal in f32, also at
             every size 1..33 at offsets 0 and 1 and with w and g at
             other offsets mod 16) and at the scale path's flat replica
             buffer, f32. At the main paths' shapes it times each kernel,
             its plain version and a library yardstick the port never
             calls (``torch.bmm`` with the precomputed ``V^Γ``;
             ``torch.add`` with ``alpha=-η``, in turns with the kernel;
             and the two calls ``torch.bmm(W, torch.add(w, g,
             alpha=-η))``). ``paged_decode`` at the shapes of
             tests/test_torch_kernels.py (the reference's test shape,
             all-dummy rows with pos past their pages, the serve path's
             shape, a gemma-2b-like MQA, a starcoder2-3b-like GQA past
             its 4096 window in 160 splits, and the split's boundaries),
             f32 and bf16 pools, atol 1e-5, a second launch bitwise equal
             to the first; timed at the serve path's shape and with all 8
             slots at position 639, its inputs rotated over copies larger
             than the L2, beside the page gather plus
             ``scaled_dot_product_attention`` (two calls). ``ssd_scan``
             at the shapes of tests/test_kernels.py (ragged T = 130
             included; f32 max |Δy| / max |y| < 1e-4 and the final state
             to 1e-4; bf16 y within 1e-2 of max |y|), one row of B and C
             per head, chunk 64 against chunk 256, and at the serve
             path's admission (32 heads x 512 tokens) and the forward's
             (256 x 1024) rows; the main paths' grouped calls (B and C
             ``(1, 512, 128)`` and ``(8, 1024, 128)`` shared by 32 heads)
             through ``ssd_scan_heads`` (x in the model's layout) and
             through rows with ``heads_per_group=32``, f32 and bf16, a
             second launch bitwise equal; timed at both grouped shapes
             (the median of three readings) in turns with the same kernel
             behind transposed copies of x, dt and loga, and behind those
             and per-head copies of B and C, and
             the plain version (no single PyTorch call computes the
             scan), inputs rotated past the L2; its share of two bounds:
             the operations as three TF32 products on the tensor cores
             (the kernel's, in the kernels line) and in f32 on the CUDA
             cores.
3. slice   — ``TTHFTrainer`` on the card, kernel on: 40 steps, with the
             launch counter reset just before; then the same run through
             the ``masked_loop`` backend (same loss history, same
             ledger), the SVM, and Remark-1 adaptive Γ (kernel and
             ``masked_loop``, held against each other); and a small run
             on the card against the same run on the CPU.
4. scale   — ``ScaleTrainer`` on qwen1.5-0.5b at full size with the
             scale CLI's defaults (4 replicas in clusters of 2, batch 16
             per replica, seq 128, τ 20, consensus every 5, Γ 2, f32)
             and ``fused_interval=True``: 2 intervals after a warm-up,
             with the launch counters reset just before (8
             ``fused_consensus_sgd`` launches, no other kernel); the
             same run with the per-leaf step (loss rtol 1e-4, same
             ledger, the whole global model within atol 1e-5); and a
             reduced qwen run on the card against the same run on the
             CPU (loss rtol 1e-4).
5. serve   — ``PagedContinuousScheduler`` on qwen1.5-0.5b at full size
             (random weights from seed 0, f32 weights and cache) through
             the serve CLI's trace (``launch/serve.py::make_arrivals``:
             32 requests, 8 slots, prompts up to 512 tokens with a
             128-token shared template, 128 new tokens, page size 16,
             chunks of 256, temperature 0), with the launch counter
             reset just before (``paged_decode`` once per layer per
             decode step) and no page leaked; the same trace through the
             plain gather (every stat equal), through a one-shot paged
             prefill and the ring ``ContinuousScheduler`` (every stat
             equal; chunking moves first tokens by a tick, so the
             chunked run is held to the ring on requests, prefills and
             tokens); teacher-forced logits of 16 decode steps of 8
             prefilled slots, kernel against plain gather (atol 1e-4);
             and a reduced-qwen trace on the card against the same trace
             on the CPU (the same tokens).
6. serve-ssm — the serve CLI's continuous scheduler on mamba2-370m at
             full size (``launch/serve.py --arch mamba2-370m --scheduler
             continuous --batch 8 --prompt-len 512 --gen 128 --requests
             32 --prefix-template 128 --temperature 0``, random f32
             weights from seed 0), with the launch counter reset just
             before: ``ssd_scan`` once per layer and admission, held to
             48 x the prefills of the same trace run on the CPU at
             reduced width; the same trace with ``ssd_kernel=False``
             (every stat equal) and through the paged scheduler with
             chunks of 256 (first chunks through the kernel, later ones
             through the plain scan from the carried state; the same
             requests, prefills and tokens). Greedy tokens must equal the
             plain run's, except at a request's first step where the
             plain run's top two logits are within 1e-4 of its max
             |logit| (the phase prints the margins).
7. forward-ssm — ``ModelApi.forward`` of the full-size mamba2-370m at
             batch 8 x 1024 tokens, f32, through the kernel against the
             plain ``ssd_chunked`` (logits within 1e-4 of max |logit|
             over 48 layers); and a reduced mamba2's serve trace on the
             card against the same trace on the CPU (the same tokens).

It prints the card's name and power limit first, one JSON line with the
kernels' numbers before the last line, and as the last line
``{"ok": true, "device": {...}}``. Float32 products run in full float32
(TF32 off for matmul and cuDNN). Without a CUDA device, or without the
rest of the repository beside it, it exits non-zero and prints no result.

``--profile`` adds one profiled 20-step run of the sim path, one
profiled interval of the scale path and one profiled trace of each serve
path, and prints the device time by kernel and the device's idle share.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet, at the 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12          # float32 outside the tensor cores
TF32_FLOPS_PER_S = 495e12        # TF32 on the tensor cores (3xTF32: 3 each)

MAIN_SHAPE = (25, 5, 784 * 7840)   # the NN's w1 leaf over the fleet
TEST_SHAPES = [(1, 2, 8), (3, 5, 100), (4, 8, 700), (2, 5, 513), (25, 5, 64)]
NN_LEAF_SHAPES = [(25, 5, 7840), (25, 5, 10), (25, 5, 7840 * 10)]
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# fused SGD kernels: tests/test_kernels.py's shapes and tolerances
SGD_TEST_SHAPES = [(8,), (127,), (129,), (1000, 37), (3, 5, 7, 11)]
FCS_TEST_SHAPES = [(2, 4, 64), (4, 2, 937), (1, 8, 128)]
SGD_TOL = {"float32": 1e-6, "bfloat16": 1e-2}
# the scale path: qwen1.5-0.5b's flat (R, P) buffer, R = 4 in clusters of 2
QWEN_P = 464_118_784
SCALE_LR = 2e-3                    # the scale CLI's --lr
SCALE_BATCH = 16                   # the scale CLI's --batch (per replica)
# paged_decode: name -> (B, K, G, hd, page_size, P, num_pages, window,
# pos), the cases of tests/test_torch_kernels.py; a pos of None is a
# retired slot: an all-dummy page-map row and a pos past its pages
PAGED_CASES = {
    "reference": (2, 2, 2, 8, 4, 3, 4, 0, [5, 9]),
    "reference-window": (2, 2, 2, 8, 4, 3, 4, 4, [5, 9]),
    "dummy-row": (3, 2, 2, 8, 4, 3, 7, 0, [5, None, 11]),
    "dummy-row-window": (3, 2, 2, 8, 4, 3, 7, 4, [5, None, 11]),
    "qwen-serve": (8, 16, 1, 64, 16, 40, 321, 0,
                   [80 * (b + 1) - 1 for b in range(8)]),
    "gemma-mqa": (4, 1, 8, 256, 16, 8, 33, 0, [3, 60, None, 127]),
    "starcoder-window": (2, 2, 12, 128, 16, 320, 641, 4096, [4500, 5119]),
    # the kernel's split at its boundaries (a chunk of 64 positions here):
    # live ranges of 1, 63, 64 and 65, windows from mid-chunk, a retired
    # slot, all-masked windowed rows, rows of no whole 16-byte pieces
    "split-edges": (4, 2, 2, 64, 16, 12, 49, 0, [0, 62, 63, 64]),
    "split-window": (4, 2, 2, 64, 16, 12, 49, 35, [69, 138, 191, 40]),
    "split-retired": (4, 2, 2, 64, 16, 12, 49, 0, [67, None, 128, 5]),
    "split-all-masked": (4, 2, 2, 64, 16, 12, 49, 16, [211, None, 100, 232]),
    "odd-head": (3, 2, 3, 6, 4, 5, 16, 0, [0, 11, 19]),
}
SPLIT_CHUNK = 64
# timed only: the serve shape with every slot at its last position, so no
# slot waits on a longer one
PAGED_BALANCED = (8, 16, 1, 64, 16, 40, 321, 0, [639] * 8)
PAGED_TOL = 1e-5
# the serve path: the serve CLI's paged trace at full width and depth
SERVE_TRACE = dict(requests=32, prompt_len=512, gen=128, seed=0,
                   prefix_template=128, arrival_gap=2.0)
SERVE_SCHED = dict(slots=8, max_prompt=512, max_total=512 + 128,
                   temperature=0.0, seed=0)
SERVE_PAGED = dict(page_size=16, prefill_chunk=256)
# ssd_scan: (BH, T, P, S, chunk), tests/test_kernels.py's shapes, and the
# main paths' shapes: one admission of the serve-ssm trace (32 heads, the
# prompt padded to 512) and the forward-ssm phase (8 x 32 heads, 1024)
SSD_TEST_SHAPES = [(1, 64, 16, 16, 16), (2, 256, 64, 128, 128),
                   (3, 512, 64, 128, 256), (2, 130, 32, 64, 64)]
SSD_MAIN_SHAPES = {"serve": (32, 512, 64, 128, 256),
                   "forward": (256, 1024, 64, 128, 256)}
SSD_TOL = {"float32": 1e-4, "bfloat16": 1e-2}     # of max |y|
# the main paths' grouped calls, (b, H, T, P, S, chunk): B and C (b, T, S)
# shared by the H heads, x (b, T, H, P) read through strides
SSD_GROUP_SHAPES = {"serve": (1, 32, 512, 64, 128, 256),
                    "forward": (8, 32, 1024, 64, 128, 256)}
# the serve-ssm path: the serve CLI's flags
SERVE_SSM_ARGV = ["--arch", "mamba2-370m", "--scheduler", "continuous",
                  "--batch", "8", "--prompt-len", "512", "--gen", "128",
                  "--requests", "32", "--prefix-template", "128",
                  "--temperature", "0"]
LOGIT_TOL = 1e-4                   # of max |logit|


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``iters`` calls (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def mixing_inputs(shape, dtype, seed, gamma=None):
    """z, V (metropolis weights of random geometric graphs), gamma on
    the card, from one numpy seed; gamma heterogeneous with a 0."""
    import torch
    from repro_torch.core.topology import (
        geometric_adjacency, metropolis_weights)
    N, s, M = shape
    rng = np.random.default_rng(seed)
    V = np.stack([metropolis_weights(geometric_adjacency(s, 0.9, rng))
                  for _ in range(N)]).astype(np.float32)
    if gamma is None:
        gamma = rng.integers(0, 6, size=(N,)).astype(np.int32)
        gamma[0] = 0
    gen = torch.Generator(device="cuda").manual_seed(seed)
    z = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    return (z, torch.from_numpy(V).cuda(),
            torch.as_tensor(gamma, dtype=torch.int32, device="cuda"))


def ptxas_entries(report: str, match: str) -> list:
    """(kernel, registers, static shared memory B, spill stores B) of each
    entry function of nvcc's ``-Xptxas -v`` report whose mangled name
    holds ``match``, demangled when ``c++filt`` is there."""
    import re
    import shutil
    rows = []
    for block in report.split("Compiling entry function '")[1:]:
        name = block.split("'", 1)[0]
        if match not in name:
            continue
        nums = [re.search(pat, block) for pat in (
            r"Used (\d+) registers", r"(\d+) bytes smem",
            r"(\d+) bytes spill stores")]
        rows.append([name] + [int(m.group(1)) if m else 0 for m in nums])
    if rows and shutil.which("c++filt"):
        out = subprocess.run(["c++filt"], input="\n".join(r[0] for r in rows),
                             capture_output=True, text=True, timeout=60)
        for r, name in zip(rows, out.stdout.splitlines()):
            r[0] = name
    return [tuple(r) for r in rows]


def phase_build() -> None:
    import re

    from repro_torch.kernels import build
    t0 = time.time()
    reports = build.build()
    log(f"[build] {build.sources()} built with nvcc "
        f"{' '.join(build.NVCC_FLAGS)} in {time.time() - t0:.2f} s")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    for name, report in reports.items():
        (out_dir / f"nvcc_{name}.txt").write_text(report)
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", report)]
        spills = [int(r) for r in
                  re.findall(r"(\d+) bytes spill stores", report)]
        log(f"[build] {name}: {len(regs)} kernel instances, registers "
            f"{min(regs, default=0)}..{max(regs, default=0)}, spill stores "
            f"up to {max(spills, default=0)} B (ptxas report in "
            f"chiprun_out/nvcc_{name}.txt)")
    # the kernels redesigned for the card: each instance on its own
    for name, match in (("fused_consensus_sgd", "fused_sgd_kernel"),
                        ("paged_decode", "paged_decode_kernel"),
                        ("ssd_scan", "ssd_prep_kernel"),
                        ("ssd_scan", "ssd_scan_kernel")):
        for kernel, regs, smem, spill in ptxas_entries(
                reports.get(name, ""), match):
            log(f"[build] ptxas {kernel}: {regs} registers, {smem} B static "
                f"shared memory, {spill} B spill stores")


def phase_kernels() -> dict:
    import torch
    from repro_torch.core.mixing import matrix_powers
    from repro_torch.kernels.consensus_mix import (
        consensus_mix, consensus_mix_plain)

    worst = {}
    cases = [(shape, dt, None) for shape in TEST_SHAPES
             for dt in ("float32", "bfloat16")]
    cases += [(shape, "float32", None) for shape in NN_LEAF_SHAPES]
    # the Γ the Remark-1 rule gives the main path: up to its cap of 64
    cases += [(shape, "float32", np.resize(np.array([0, 2, 64], np.int32),
                                           shape[0]))
              for shape in NN_LEAF_SHAPES]
    for i, (shape, dt, g) in enumerate(cases):
        z, V, gamma = mixing_inputs(shape, getattr(torch, dt), seed=i,
                                    gamma=g)
        out = consensus_mix(z, V, gamma)
        torch.cuda.synchronize()
        plain = consensus_mix_plain(z, V, gamma)
        err = float((out.float() - plain.float()).abs().max())
        assert out.dtype == z.dtype and out.shape == z.shape
        assert err <= TOL[dt], (shape, dt, err)
        same = consensus_mix(z, V, torch.zeros_like(gamma))
        assert torch.equal(same, z), (shape, dt, "gamma=0 must copy z")
        worst[dt] = max(worst.get(dt, 0.0), err)
        log(f"[kernels] {shape} {dt} gamma={sorted(set(gamma.tolist()))} "
            f"max_abs_err={err:.3e} (tol {TOL[dt]})")

    # the main path's largest leaf: f32, Γ = 2 in every cluster
    N, s, M = MAIN_SHAPE
    z, V, gamma = mixing_inputs(MAIN_SHAPE, torch.float32, seed=100,
                                gamma=np.full((N,), 2, np.int32))
    out = consensus_mix(z, V, gamma)
    torch.cuda.synchronize()
    plain = consensus_mix_plain(z, V, gamma)
    err = float((out - plain).abs().max())
    assert err <= TOL["float32"], err
    del out, plain
    log(f"[kernels] {MAIN_SHAPE} float32 gamma=2 max_abs_err={err:.3e}")
    W = matrix_powers(V, gamma)
    kernel_ms = cuda_ms(lambda: consensus_mix(z, V, gamma), iters=20, warmup=2)
    plain_ms = cuda_ms(lambda: consensus_mix_plain(z, V, gamma), iters=3)
    library_ms = cuda_ms(lambda: torch.bmm(W, z), iters=20, warmup=2)
    bytes_moved = 2 * z.numel() * z.element_size()
    flops = sum(int(g) * 2 * s * s * M for g in gamma.tolist())
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    log(f"[kernels] {MAIN_SHAPE} f32 Γ=2: kernel {kernel_ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, torch.bmm(V^Γ, z) {library_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bytes_moved} B at 3.35 TB/s; {flops} FLOP at "
        f"67 TFLOP/s = {ops_ms:.4f} ms), kernel at "
        f"{bytes_moved / kernel_ms / 1e6:.1f} GB/s")
    del z, W
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "max_abs_err_all_shapes": {"float32": max(worst["float32"], err),
                                       "bfloat16": worst["bfloat16"]}}


def bound(bytes_moved: int, flops: int) -> tuple[float, str]:
    """The least time for the work (ms) and what decides it: bytes over
    the HBM rate or float32 operations over the f32 peak."""
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def scale_W():
    """The scale path's W = V^Γ (4 replicas in ring clusters of 2, Γ = 2)
    on the card."""
    from repro_torch.core.distributed import TTHFScaleConfig
    from repro_torch.core.mixing import build_mixing_plan
    net = TTHFScaleConfig(replicas=4, cluster_size=2).network()
    return build_mixing_plan(net, 2, backend="fused_power",
                             device="cuda").W


def sgd_inputs(shape, dtype, seed):
    import torch
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    return w.to("cuda", dtype), g.to("cuda", dtype)


def compare(out, plain, dt: str, what) -> float:
    """max |out - plain|; fails unless allclose at the dtype's tolerance
    (atol and rtol, as tests/test_kernels.py)."""
    import torch
    tol = SGD_TOL[dt]
    assert out.dtype == plain.dtype and out.shape == plain.shape, what
    err = float((out.float() - plain.float()).abs().max())
    assert torch.allclose(out.float(), plain.float(), atol=tol, rtol=tol), \
        (what, dt, err)
    return err


def phase_fused_kernels() -> dict:
    """``fused_consensus_sgd`` and ``fused_sgd`` against their plain
    versions, then timed at the scale path's flat replica buffer."""
    import torch
    from repro_torch.core.mixing import matrix_powers
    from repro_torch.kernels.fused_consensus_sgd import (
        fused_consensus_sgd, fused_consensus_sgd_plain)
    from repro_torch.kernels.fused_sgd import fused_sgd, fused_sgd_plain

    worst = {"fused_consensus_sgd": {}, "fused_sgd": {}}
    for dt in ("float32", "bfloat16"):
        for wd in (0.0, 0.1):
            for i, shape in enumerate(FCS_TEST_SHAPES):
                w, g = sgd_inputs(shape, getattr(torch, dt), seed=i)
                _, V, _ = mixing_inputs(shape, torch.float32, seed=i)
                W = matrix_powers(V, 2)
                out = fused_consensus_sgd(w, g, W, 0.01, weight_decay=wd)
                torch.cuda.synchronize()
                err = compare(out, fused_consensus_sgd_plain(
                    w, g, W, 0.01, weight_decay=wd), dt, shape)
                d = worst["fused_consensus_sgd"]
                d[dt] = max(d.get(dt, 0.0), err)
                log(f"[kernels] fused_consensus_sgd {shape} {dt} wd={wd} "
                    f"max_abs_err={err:.3e} (tol {SGD_TOL[dt]})")
            for i, shape in enumerate(SGD_TEST_SHAPES):
                w, g = sgd_inputs(shape, getattr(torch, dt), seed=i)
                out = fused_sgd(w, g, 0.01, weight_decay=wd)
                torch.cuda.synchronize()
                plain = fused_sgd_plain(w, g, 0.01, weight_decay=wd)
                err = compare(out, plain, dt, shape)
                if dt == "float32":
                    assert torch.equal(out, plain), shape
                d = worst["fused_sgd"]
                d[dt] = max(d.get(dt, 0.0), err)
                log(f"[kernels] fused_sgd {shape} {dt} wd={wd} "
                    f"max_abs_err={err:.3e} (tol {SGD_TOL[dt]}"
                    f"{'; bitwise equal' if dt == 'float32' else ''})")
            # sizes 1..33 around the vector width at offsets 0 and 1
            # (big[1:]: a scalar head), and w, g at other offsets mod 16
            # (the scalar loop)
            for n in range(1, 34):
                big, gbig = sgd_inputs((n + 2,), getattr(torch, dt), seed=n)
                for w, g in ((big[:n], gbig[:n]),
                             (big[1:n + 1], gbig[1:n + 1]),
                             (big[1:n + 1], gbig[2:n + 2])):
                    out = fused_sgd(w, g, 0.01, weight_decay=wd)
                    torch.cuda.synchronize()
                    plain = fused_sgd_plain(w, g, 0.01, weight_decay=wd)
                    err = compare(out, plain, dt, (n, w.data_ptr() % 16))
                    if dt == "float32":
                        assert torch.equal(out, plain), n
                    d = worst["fused_sgd"]
                    d[dt] = max(d.get(dt, 0.0), err)
            log(f"[kernels] fused_sgd sizes 1..33 at offsets 0 and 1 and "
                f"unequal offsets {dt} wd={wd}: max_abs_err "
                f"{worst['fused_sgd'][dt]:.3e}"
                f"{' (bitwise equal)' if dt == 'float32' else ''}")

    # the scale path: the flat (4, P) f32 buffer of qwen1.5-0.5b, seen as
    # (N, s, P) = (2, 2, P) at the block end
    gen = torch.Generator(device="cuda").manual_seed(7)
    w = torch.randn((2, 2, QWEN_P), generator=gen, device="cuda")
    g = torch.randn((2, 2, QWEN_P), generator=gen, device="cuda")
    W = scale_W()
    eta = torch.tensor(SCALE_LR, dtype=torch.float32, device="cuda")
    numbers = {}

    out = fused_consensus_sgd(w, g, W, eta)
    torch.cuda.synchronize()
    err = compare(out, fused_consensus_sgd_plain(w, g, W, eta), "float32",
                  "fused_consensus_sgd main")
    del out
    torch.cuda.empty_cache()
    ms = cuda_ms(lambda: fused_consensus_sgd(w, g, W, eta), iters=10,
                 warmup=2)
    plain_ms = cuda_ms(lambda: fused_consensus_sgd_plain(w, g, W, eta),
                       iters=3)
    library_ms = cuda_ms(
        lambda: torch.bmm(W, torch.add(w, g, alpha=-SCALE_LR)), iters=5,
        warmup=1)
    n = w.numel()
    bytes_moved = 3 * n * w.element_size()
    b_ms, b_by = bound(bytes_moved, n * (2 + 2 * 2))
    log(f"[kernels] fused_consensus_sgd (2, 2, {QWEN_P}) f32: kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, torch.bmm(W, torch.add(w, "
        f"g, alpha=-η)) (two calls) {library_ms:.4f} ms, bound {b_ms:.4f} "
        f"ms ({b_by}: {bytes_moved} B at 3.35 TB/s), kernel at "
        f"{bytes_moved / ms / 1e6:.1f} GB/s, max_abs_err {err:.3e}")
    numbers["fused_consensus_sgd"] = {
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by,
        "max_abs_err_all_shapes": {
            "float32": max(worst["fused_consensus_sgd"]["float32"], err),
            "bfloat16": worst["fused_consensus_sgd"]["bfloat16"]}}

    w2, g2 = w.view(4, QWEN_P), g.view(4, QWEN_P)
    out = fused_sgd(w2, g2, eta)
    torch.cuda.synchronize()
    plain = fused_sgd_plain(w2, g2, eta)
    err = compare(out, plain, "float32", "fused_sgd main")
    assert torch.equal(out, plain), "fused_sgd main: not bitwise equal"
    del out, plain
    torch.cuda.empty_cache()
    # kernel and torch.add in turns (kernel, add, add, kernel, kernel,
    # add), after an untimed turn of each: the first launches after
    # empty_cache map a fresh 7.4 GB output
    calls = {"kernel": lambda: fused_sgd(w2, g2, eta),
             "add": lambda: torch.add(w2, g2, alpha=-SCALE_LR)}
    for fn in calls.values():
        cuda_ms(fn, iters=5)
    order = ("kernel", "add", "add", "kernel", "kernel", "add")
    turns = [cuda_ms(calls[name], iters=20, warmup=2) for name in order]
    ms = sum(t for t, name in zip(turns, order) if name == "kernel") / 3
    library_ms = sum(t for t, name in zip(turns, order) if name == "add") / 3
    plain_ms = cuda_ms(lambda: fused_sgd_plain(w2, g2, eta), iters=3)
    b_ms, b_by = bound(bytes_moved, n * 2)
    log(f"[kernels] fused_sgd (4, {QWEN_P}) f32: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, torch.add(w, g, alpha=-η) {library_ms:.4f} ms "
        f"(in turns: {', '.join(f'{n} {t:.4f}' for n, t in zip(order, turns))}"
        f" ms), bound {b_ms:.4f} ms "
        f"({b_by}: {bytes_moved} B at 3.35 TB/s), kernel at "
        f"{bytes_moved / ms / 1e6:.1f} GB/s, max_abs_err {err:.3e} (bitwise "
        f"equal)")
    numbers["fused_sgd"] = {
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by,
        "max_abs_err_all_shapes": {
            "float32": max(worst["fused_sgd"]["float32"], err),
            "bfloat16": worst["fused_sgd"]["bfloat16"]}}
    del w, g, w2, g2
    torch.cuda.empty_cache()
    return numbers


class NumpyDraws:
    """A draw source from one numpy generator: the same indices on any
    device, so a run on the card can be held against a CPU run."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)

    def minibatch(self, num_devices, batch, points):
        import torch
        return torch.from_numpy(
            self.rng.integers(0, points, size=(num_devices, batch)))

    def picks(self, num_clusters, cluster_size, k):
        import torch
        if k == 1:
            return torch.from_numpy(
                self.rng.integers(0, cluster_size, size=(num_clusters,)))
        return torch.from_numpy(np.stack(
            [self.rng.permutation(cluster_size)[:k]
             for _ in range(num_clusters)]))


def phase_slice(profile: bool = False) -> int:
    import torch
    from repro_torch.configs import TopologyConfig, TTHFConfig
    from repro_torch.core import TTHFTrainer
    from repro_torch.data import fashion_synth, partition_noniid_labels
    from repro_torch.kernels.consensus_mix import consensus_mix
    from repro_torch.models import make_sim_model

    steps, eval_every = 40, 10
    x, y = fashion_synth(num_points=12_500, seed=0)
    data = partition_noniid_labels(x, y, num_devices=125,
                                   labels_per_device=3, seed=0)
    topo = TopologyConfig(num_devices=125, num_clusters=25,
                          graph="geometric", seed=0)
    nn = make_sim_model("nn", data.feature_dim, data.num_classes, 7840)
    svm = make_sim_model("svm", data.feature_dim, data.num_classes)

    def algo(gamma_d2d=2):
        return TTHFConfig(tau=20, consensus_every=5, gamma_d2d=gamma_d2d,
                          constant_lr=2e-3)

    def run(model, cfg, run_steps=steps, **kw):
        tr = TTHFTrainer(model, data, topo, cfg, batch_size=16, **kw)
        torch.cuda.synchronize()
        t0 = time.time()
        _, hist = tr.run(steps=run_steps, seed=0, eval_every=eval_every)
        torch.cuda.synchronize()
        return tr, hist, time.time() - t0

    def ledger(tr):
        led = tr.ledger
        return (led.uplinks, led.d2d_msgs, led.d2d_rounds, led.local_steps)

    # warm-up (allocator, cuBLAS handles, the kernel's first load) so
    # that the timed runs below compare like with like
    for kw in (dict(use_kernel=True), dict(backend="masked_loop")):
        _, _, wall0 = run(nn, algo(), run_steps=5, **kw)
        log(f"[slice] warm-up nn-7840 {kw}: 5 steps in {wall0:.3f} s")

    # the main path: NN at full width, consensus through the kernel
    torch.cuda.reset_peak_memory_stats()
    consensus_mix.launches = 0
    tr, hist, wall = run(nn, algo(), use_kernel=True)
    launches = consensus_mix.launches
    peak = torch.cuda.max_memory_allocated()
    events = steps // tr.algo.consensus_every
    assert tr.backend == "pallas" and tr.device.type == "cuda"
    assert tr.model_dim == 6_232_810, tr.model_dim
    assert np.isfinite(hist.global_loss).all(), hist.global_loss
    # one launch per parameter leaf (b1, b2, w1, w2) per consensus event
    assert launches == events * 4 == 32, launches
    log(f"[slice] nn-7840 kernel: {steps} steps in {wall:.3f} s = "
        f"{steps / wall:.3f} steps/s, loss {hist.global_loss}, acc "
        f"{hist.global_acc}, ledger {ledger(tr)}, launches {launches}, "
        f"max_memory_allocated {peak} B")

    # the same run through the masked_loop backend, timed in turns
    # (kernel, masked_loop, masked_loop, kernel)
    consensus_mix.launches = 0
    tr2, hist2, wall2 = run(nn, algo(), backend="masked_loop")
    _, _, wall2b = run(nn, algo(), backend="masked_loop")
    assert consensus_mix.launches == 0
    np.testing.assert_allclose(hist2.global_loss, hist.global_loss, rtol=1e-4)
    assert ledger(tr2) == ledger(tr)
    assert [g.tolist() for g in hist2.gamma_used] == \
        [g.tolist() for g in hist.gamma_used]
    _, _, wallb = run(nn, algo(), use_kernel=True)
    log(f"[slice] nn-7840 masked_loop: loss {hist2.global_loss} (rtol 1e-4 "
        f"vs the kernel run), same ledger and gamma_used")
    log(f"[slice] nn-7840 steps/s in turns: kernel {steps / wall:.3f}, "
        f"masked_loop {steps / wall2:.3f}, masked_loop {steps / wall2b:.3f}, "
        f"kernel {steps / wallb:.3f}")

    consensus_mix.launches = 0
    tr3, hist3, wall3 = run(svm, algo(), use_kernel=True)
    assert np.isfinite(hist3.global_loss).all()
    assert consensus_mix.launches == events * 2, consensus_mix.launches
    log(f"[slice] svm kernel: {steps / wall3:.3f} steps/s, loss "
        f"{hist3.global_loss}, ledger {ledger(tr3)}")

    consensus_mix.launches = 0
    tr4, hist4, wall4 = run(nn, algo(gamma_d2d=-1), use_kernel=True)
    assert np.isfinite(hist4.global_loss).all()
    assert consensus_mix.launches == 32, consensus_mix.launches
    log(f"[slice] nn-7840 adaptive Γ kernel: {steps / wall4:.3f} steps/s, "
        f"loss {hist4.global_loss}, gamma_used "
        f"{[g.tolist() for g in hist4.gamma_used]}, ledger {ledger(tr4)}")
    # the kernel at the Γ this rule gives it, against the plain rounds
    tr5, hist5, wall5 = run(nn, algo(gamma_d2d=-1), backend="masked_loop")
    np.testing.assert_allclose(hist5.global_loss, hist4.global_loss,
                               rtol=1e-4)
    assert ledger(tr5) == ledger(tr4)
    assert [g.tolist() for g in hist5.gamma_used] == \
        [g.tolist() for g in hist4.gamma_used]
    log(f"[slice] nn-7840 adaptive Γ masked_loop: {steps / wall5:.3f} "
        f"steps/s, loss {hist5.global_loss} (rtol 1e-4 vs the kernel run), "
        f"same ledger and gamma_used")

    # the card against the CPU on a small input: same data, weights
    # and draws; the CPU run takes the plain versions of the kernels
    xs, ys = fashion_synth(num_points=2000, seed=1)
    small = partition_noniid_labels(xs, ys, num_devices=25, seed=1)
    stopo = TopologyConfig(num_devices=25, num_clusters=5, seed=1)
    snn = make_sim_model("nn", 784, 10, 64)
    w0 = snn.init(torch.Generator().manual_seed(1), "cpu")
    hists = []
    for dev in ("cuda", "cpu"):
        t = TTHFTrainer(snn, small, stopo, algo(), batch_size=8,
                        use_kernel=True, device=dev)
        st = t.init(1, w0=w0, draws=NumpyDraws(1))
        hists.append(t.run(steps=40, eval_every=10, state=st)[1])
    np.testing.assert_allclose(hists[0].global_loss, hists[1].global_loss,
                               rtol=1e-4)
    assert [g.tolist() for g in hists[0].gamma_used] == \
        [g.tolist() for g in hists[1].gamma_used]
    log(f"[slice] small nn on cuda vs cpu: loss {hists[0].global_loss} vs "
        f"{hists[1].global_loss} (rtol 1e-4), same gamma_used")
    if profile:
        profile_main_path(lambda: run(nn, algo(), use_kernel=True,
                                      run_steps=20)[2], "20 sim steps")
    return launches


def read_losses(path: Path) -> list:
    """The per-interval train losses a run's metric log wrote."""
    return [json.loads(line)["train_loss"]
            for line in path.read_text().splitlines()]


def phase_scale(profile: bool = False) -> dict:
    """ScaleTrainer on the full-size qwen1.5-0.5b: the fused interval
    (the main path, through fused_consensus_sgd), the per-leaf step held
    to it, and a reduced run on the card held to the CPU. Returns each
    kernel's launches in the main path's run."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core.distributed import TTHFScaleConfig
    from repro_torch.kernels.consensus_mix import consensus_mix
    from repro_torch.kernels.fused_consensus_sgd import fused_consensus_sgd
    from repro_torch.kernels.fused_sgd import fused_sgd
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_leaves
    from repro_torch.train import ScaleTrainer, TrainerConfig

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    cfg = get_arch("qwen1.5-0.5b")
    # the scale CLI's defaults
    scale = TTHFScaleConfig(replicas=4, cluster_size=2, tau=20,
                            consensus_every=5, gamma_d2d=2, lr=SCALE_LR)
    tokens_per_interval = scale.tau * scale.replicas * SCALE_BATCH * 128
    w0 = build_model(cfg).init(
        torch.Generator(device="cuda").manual_seed(0), "cuda")

    def run(fused: bool, intervals: int, name: str, c=cfg, sc=scale,
            batch=SCALE_BATCH, seq=128, device="cuda", weights=w0,
            seed=0):
        log_path = out_dir / f"scale_{name}.jsonl"
        log_path.unlink(missing_ok=True)
        tr = ScaleTrainer(c, sc, TrainerConfig(
            batch_per_replica=batch, seq_len=seq, intervals=intervals,
            eval_every=0, seed=0, fused_interval=fused,
            log_path=str(log_path)), device=device)
        tr.init(w0=weights, draws=NumpyDraws(seed))
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.time()
        tr.run()
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.time() - t0
        tr.close()
        led = tr.ledger
        return tr, read_losses(log_path), wall, (
            led.uplinks, led.d2d_msgs, led.d2d_rounds, led.local_steps)

    # warm-up: allocator, cuBLAS handles, the kernel's first load
    tr, losses, wall, _ = run(True, 1, "warmup")
    log(f"[scale] warm-up qwen1.5-0.5b fused interval: 1 interval in "
        f"{wall:.3f} s, loss {losses}")
    del tr
    torch.cuda.empty_cache()

    # the main path: the fused interval through fused_consensus_sgd
    torch.cuda.reset_peak_memory_stats()
    fused_consensus_sgd.launches = 0
    consensus_mix.launches = 0
    fused_sgd.launches = 0
    tr, losses, wall, ledger = run(True, 2, "fused")
    launches = {"fused_consensus_sgd": fused_consensus_sgd.launches,
                "fused_sgd": fused_sgd.launches}
    peak = torch.cuda.max_memory_allocated()
    assert tr._spec.total == QWEN_P, tr._spec.total
    assert np.isfinite(losses).all() and len(losses) == 2, losses
    # one launch per consensus block: 4 blocks per interval
    assert launches["fused_consensus_sgd"] == 8, launches
    # no trainer calls fused_sgd, in the reference or in the port
    assert launches["fused_sgd"] == 0, launches
    assert consensus_mix.launches == 0
    # the global model, replica 0's row of the flat (R, P) buffer
    g_fused = tr.params[0].clone()
    spec = tr._spec
    log(f"[scale] qwen1.5-0.5b fused interval: 2 intervals in {wall:.3f} s "
        f"= {2 / wall:.4f} intervals/s, {2 * tokens_per_interval / wall:.1f} "
        f"tokens/s, loss {losses}, ledger {ledger}, fused_consensus_sgd "
        f"launches {launches['fused_consensus_sgd']}, fused_sgd launches "
        f"{launches['fused_sgd']}, max_memory_allocated {peak} B")
    del tr
    torch.cuda.empty_cache()
    if profile:
        profile_main_path(lambda: run(True, 1, "profile")[2],
                          "1 scale interval (fused)")
        torch.cuda.empty_cache()

    # the same run through the per-leaf step (fused_power einsum)
    fused_consensus_sgd.launches = 0
    torch.cuda.reset_peak_memory_stats()
    tr2, losses2, wall2, ledger2 = run(False, 2, "perleaf")
    peak2 = torch.cuda.max_memory_allocated()
    assert fused_consensus_sgd.launches == 0
    np.testing.assert_allclose(losses2, losses, rtol=1e-4)
    assert ledger2 == ledger, (ledger2, ledger)
    # every parameter of the global model, leaf by leaf (params atol
    # 1e-5, as the CPU tests hold the two steps)
    diff = max(float((a - b).abs().max()) for a, b in zip(
        tree_leaves(tr2._global_params()),
        spec.leaf_views(g_fused)))
    assert diff <= 1e-5, diff
    log(f"[scale] qwen1.5-0.5b per-leaf step: 2 intervals in {wall2:.3f} s "
        f"= {2 / wall2:.4f} intervals/s, loss {losses2} (rtol 1e-4 vs the "
        f"fused run), same ledger, max_memory_allocated {peak2} B, global "
        f"model ({QWEN_P} parameters) max |diff| {diff:.3e} (atol 1e-5)")
    del tr2, g_fused
    torch.cuda.empty_cache()
    if profile:
        profile_main_path(lambda: run(False, 1, "profile_perleaf")[2],
                          "1 scale interval (per-leaf)")
    del w0
    torch.cuda.empty_cache()

    # the card against the CPU on a reduced qwen: same weights and draws;
    # the CPU run takes the kernel's plain version
    small = cfg.reduced()
    ssc = TTHFScaleConfig(replicas=4, cluster_size=2, tau=4,
                          consensus_every=2, gamma_d2d=2, lr=0.05)
    sw0 = build_model(small).init(torch.Generator().manual_seed(1), "cpu")
    fused_consensus_sgd.launches = 0
    kw = dict(c=small, sc=ssc, batch=2, seq=32, weights=sw0, seed=1)
    _, l_gpu, _, led_gpu = run(True, 2, "small_cuda", device="cuda", **kw)
    assert fused_consensus_sgd.launches == 4, fused_consensus_sgd.launches
    _, l_cpu, _, led_cpu = run(True, 2, "small_cpu", device="cpu", **kw)
    np.testing.assert_allclose(l_gpu, l_cpu, rtol=1e-4)
    assert led_gpu == led_cpu
    log(f"[scale] reduced qwen on cuda vs cpu: loss {l_gpu} vs {l_cpu} "
        f"(rtol 1e-4), same ledger {led_gpu}")
    return launches


def device_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls: the
    device sleeps while the host queues them, so that the time of a
    kernel of some microseconds is not the host's launch time."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)        # ~0.1 s at the H100's clocks
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def paged_inputs(spec, dtype, seed=0, copies=1):
    """q, [(k_pages, v_pages)] * copies, page_map, pos, window on the
    card for a ``PAGED_CASES`` spec, from one numpy seed (as
    tests/test_torch_kernels.py)."""
    import torch
    B, K, G, hd, ps, P, N, window, pos = spec
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, K, G, hd)).astype(np.float32)
    kp = rng.normal(size=(N, ps, K, hd)).astype(np.float32)
    vp = rng.normal(size=(N, ps, K, hd)).astype(np.float32)
    pages = rng.permutation(np.arange(1, N))
    page_map = np.zeros((B, P), np.int32)
    pos_v = np.zeros((B,), np.int32)
    for b, pb in enumerate(pos):
        if pb is None:
            pos_v[b] = P * ps + 7
        else:
            page_map[b] = pages[b * P:(b + 1) * P] if N > B * P else \
                rng.choice(np.arange(1, N), size=P)
            pos_v[b] = pb
    cuda = lambda a: torch.from_numpy(a).cuda()  # noqa: E731
    pools = [(cuda(kp).to(dtype), cuda(vp).to(dtype))]
    # the timing copies: other values, the same shapes
    pools += [(torch.randn_like(pools[0][0]), torch.randn_like(pools[0][1]))
              for _ in range(copies - 1)]
    return cuda(q), pools, cuda(page_map), cuda(pos_v), window


def phase_paged_kernel() -> dict:
    """``paged_decode`` against its plain version at every case, f32 and
    bf16 pools (a second launch must give the same bits: the merge's
    order is fixed); then timed at the serve path's shape and at the
    balanced one against its bound, its plain version and a library
    yardstick."""
    import torch
    from repro_torch.kernels.paged_decode import (
        paged_decode, paged_decode_plain, split_plan)

    worst = {}
    for case, spec in PAGED_CASES.items():
        for dt in ("float32", "bfloat16"):
            q, pools, pm, pos, window = paged_inputs(spec, getattr(torch, dt))
            (kp, vp), = pools
            if case.startswith("split-"):
                assert split_plan(*spec[:6], kp.dtype).chunk == SPLIT_CHUNK
            out = paged_decode(q, kp, vp, pm, pos, window=window)
            torch.cuda.synchronize()
            plain = paged_decode_plain(q, kp, vp, pm, pos, window=window)
            assert out.dtype == torch.float32 and out.shape == q.shape
            assert torch.isfinite(out).all(), case
            assert torch.equal(
                paged_decode(q, kp, vp, pm, pos, window=window), out), case
            err = float((out - plain).abs().max())
            assert err <= PAGED_TOL, (case, dt, err)
            worst[dt] = max(worst.get(dt, 0.0), err)
            log(f"[kernels] paged_decode {case} {PAGED_CASES[case][:8]} "
                f"{dt} max_abs_err={err:.3e} (tol {PAGED_TOL})")

    # the serve path's shape; then every slot at its last position
    numbers = time_paged(PAGED_CASES["qwen-serve"], "qwen-serve")
    numbers["at_balanced_shape"] = time_paged(PAGED_BALANCED,
                                              "qwen-balanced")
    numbers["max_abs_err_all_shapes"] = {
        "float32": max(worst["float32"], numbers["max_abs_err"],
                       numbers["at_balanced_shape"]["max_abs_err"]),
        "bfloat16": worst["bfloat16"]}
    return numbers


def time_paged(spec, label: str) -> dict:
    """``paged_decode`` at ``spec`` in f32, timed against its bound, its
    plain version and a library yardstick. Four copies of the pools (4 x
    42 MB at the serve shape) rotate, so each launch finds its pages out
    of the 50 MB L2, as every layer's pages are in a decode step."""
    import itertools

    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.paged_decode import (
        paged_decode, paged_decode_plain, split_plan)

    q, pools, pm, pos, window = paged_inputs(spec, torch.float32, seed=1,
                                             copies=4)
    B, K, G, hd, ps, P, _, _, _ = spec
    kp, vp = pools[0]
    out = paged_decode(q, kp, vp, pm, pos, window=window)
    torch.cuda.synchronize()
    err = float((out - paged_decode_plain(q, kp, vp, pm, pos,
                                          window=window)).abs().max())
    assert err <= PAGED_TOL, (label, err)
    turn = itertools.cycle(pools)
    ms = device_ms(lambda: paged_decode(q, *next(turn), pm, pos,
                                        window=window), iters=400)
    plain_ms = device_ms(lambda: paged_decode_plain(q, *next(turn), pm, pos,
                                                    window=window), iters=100)
    # the library yardstick: one gather of both pools and SDPA with the
    # same boolean mask (the G query heads of a kv head as its queries)
    kvs = [torch.stack([k, v]) for k, v in pools]
    pml = pm.long()
    k_pos = torch.arange(P * ps, device="cuda")
    mask = (k_pos[None, :] <= pos.long()[:, None])[:, None, None, :]

    def library(kv):
        g = kv[:, pml].reshape(2, B, P * ps, K, hd).transpose(2, 3)
        return F.scaled_dot_product_attention(q, g[0], g[1], attn_mask=mask)

    lib_err = float((library(kvs[0]) - out).abs().max())
    rot = itertools.cycle(kvs)
    library_ms = device_ms(lambda: library(next(rot)), iters=100)
    # the positions the kernel walks: max(0, pos - window + 1) ..
    # min(pos, P*ps - 1) (window 0 at these shapes)
    assert window == 0
    live = int((torch.clamp(pos.long(), max=P * ps - 1) + 1).sum())
    bytes_moved = (2 * live * K * hd * kp.element_size()
                   + 2 * q.numel() * 4 + (pm.numel() + pos.numel()) * 4)
    b_ms, b_by = bound(bytes_moved, 4 * live * K * G * hd)
    plan = split_plan(B, K, G, hd, ps, P, kp.dtype)
    log(f"[kernels] paged_decode {label} {spec[:7]} f32, {live} live "
        f"positions, chunk {plan.chunk}, {plan.n_split} splits: kernel "
        f"{ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, gather + "
        f"scaled_dot_product_attention {library_ms * 1e3:.2f} us (max |diff| "
        f"vs kernel {lib_err:.2e}), bound {b_ms * 1e3:.2f} us ({b_by}: "
        f"{bytes_moved} B at 3.35 TB/s), kernel at "
        f"{bytes_moved / ms / 1e6:.1f} GB/s, max_abs_err {err:.3e}")
    del pools, kvs
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by,
            "live_positions": live}


def ssd_inputs(shape, dtype, seed=0, copies=1):
    """[(x, dt, loga, B, C)] * copies on the card, the first from one
    numpy seed as tests/test_kernels.py makes them, the others (timing
    copies) from torch's generator on the card."""
    import torch
    BH, T, P, S, _ = shape
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(BH, T, P)).astype(np.float32)
    dt = rng.uniform(0.001, 0.1, size=(BH, T)).astype(np.float32)
    loga = (-dt * rng.uniform(0.5, 2.0, size=(BH, 1))).astype(np.float32)
    B = (rng.normal(size=(BH, T, S)) * 0.3).astype(np.float32)
    C = (rng.normal(size=(BH, T, S)) * 0.3).astype(np.float32)
    cuda = lambda a, d=dtype: torch.from_numpy(a).to("cuda", d)  # noqa
    sets = [(cuda(x), cuda(dt, torch.float32), cuda(loga, torch.float32),
             cuda(B), cuda(C))]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for _ in range(copies - 1):
        d = torch.rand((BH, T), generator=gen, device="cuda") * 0.099 + 1e-3
        sets.append((
            torch.randn((BH, T, P), generator=gen, device="cuda").to(dtype),
            d, -d, (torch.randn((BH, T, S), generator=gen, device="cuda")
                    * 0.3).to(dtype),
            (torch.randn((BH, T, S), generator=gen, device="cuda")
             * 0.3).to(dtype)))
    return sets


def ssd_compare(y, h, yp, hp, dt: str, what) -> tuple[float, float]:
    """(max |y - plain|, that over max |plain|), the second held to the
    dtype's tolerance; the float32 final state to rtol/atol 1e-4."""
    import torch
    assert y.dtype == yp.dtype and y.shape == yp.shape, what
    assert torch.isfinite(y.float()).all() and torch.isfinite(h).all(), what
    err = float((y.float() - yp.float()).abs().max())
    rel = err / (float(yp.float().abs().max()) + 1e-6)
    assert rel < SSD_TOL[dt], (what, dt, rel)
    assert torch.allclose(h, hp, rtol=1e-4, atol=1e-4), \
        (what, float((h - hp).abs().max()))
    return err, rel


def ssd_group_inputs(shape, dtype, seed=0, copies=1):
    """[(x (b, T, H, P), dt, loga (b, T, H), B, C (b, T, S))] * copies on
    the card, in the model's layout: the first from one numpy seed, the
    others (timing copies) from torch's generator on the card."""
    import torch
    b, H, T, P, S, _ = shape
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, T, H, P)).astype(np.float32)
    dt = rng.uniform(0.001, 0.1, size=(b, T, H)).astype(np.float32)
    loga = (-dt * rng.uniform(0.5, 2.0, size=(b, 1, H))).astype(np.float32)
    B = (rng.normal(size=(b, T, S)) * 0.3).astype(np.float32)
    C = (rng.normal(size=(b, T, S)) * 0.3).astype(np.float32)
    cuda = lambda a, d=dtype: torch.from_numpy(a).to("cuda", d)  # noqa
    sets = [(cuda(x), cuda(dt, torch.float32), cuda(loga, torch.float32),
             cuda(B), cuda(C))]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for _ in range(copies - 1):
        d = torch.rand((b, T, H), generator=gen, device="cuda") * 0.099 + 1e-3
        sets.append((
            torch.randn((b, T, H, P), generator=gen, device="cuda").to(dtype),
            d, -d, (torch.randn((b, T, S), generator=gen, device="cuda")
                    * 0.3).to(dtype),
            (torch.randn((b, T, S), generator=gen, device="cuda")
             * 0.3).to(dtype)))
    return sets


def ssd_work(shape) -> tuple[int, int]:
    """(bytes, operations) the grouped call needs: x and y, dt and loga
    and h per row, B and C per group, each read or written once; the
    causal half of G = C Bᵀ once per (group, chunk), per (row, chunk) the
    causal half of M X and the carry, and per (row, chunk after the
    first) the carried-state term (the first chunk starts from zero)."""
    b, H, T, P, S, Q = shape
    nc = -(-T // Q)
    bytes_moved = 4 * (b * H * (2 * T * P + 2 * T + S * P) + b * 2 * T * S)
    flops = (b * nc * Q * (Q + 1) * S
             + b * H * (nc * (Q * (Q + 1) * P + 2 * Q * S * P)
                        + (nc - 1) * 2 * Q * S * P))
    return bytes_moved, flops


def phase_ssd_kernel() -> dict:
    """``ssd_scan`` against its plain version at the reference's shapes,
    one row per head; chunk 64 against 256; the main paths' grouped calls
    (B and C once per batch element, x in the model's layout) in f32 and
    bf16; timed at both main shapes against both bounds and the plain
    scan, beside the same kernel behind transposed copies of x, dt and
    loga, and behind those and per-head copies of B and C (what the
    model's wrapper did before B and C were shared by a group)."""
    import itertools

    import torch
    from repro_torch.kernels.ssd_scan import (
        ssd_chunked, ssd_scan, ssd_scan_heads, ssd_scan_plain)

    worst = {}
    shapes = SSD_TEST_SHAPES + list(SSD_MAIN_SHAPES.values())
    for i, shape in enumerate(shapes):
        chunk = shape[-1]
        for dt in ("float32", "bfloat16"):
            args, = ssd_inputs(shape, getattr(torch, dt), seed=i)
            y, h = ssd_scan(*args, chunk=chunk)
            torch.cuda.synchronize()
            yp, hp = ssd_scan_plain(*args, chunk=chunk)
            err, rel = ssd_compare(y, h, yp, hp, dt, shape)
            worst[dt] = max(worst.get(dt, 0.0), err)
            log(f"[kernels] ssd_scan {shape} {dt} max_abs_err={err:.3e}, "
                f"over max|y| {rel:.3e} (tol {SSD_TOL[dt]}), h max|diff| "
                f"{float((h - hp).abs().max()):.3e}")
            del args, y, h, yp, hp
    # the state carry across chunks: chunk 64 against chunk 256
    args, = ssd_inputs((2, 256, 32, 64, 64), torch.float32, seed=2)
    y64, h64 = ssd_scan(*args, chunk=64)
    y256, h256 = ssd_scan(*args, chunk=256)
    torch.cuda.synchronize()
    assert torch.allclose(y64, y256, rtol=1e-4, atol=1e-4)
    assert torch.allclose(h64, h256, rtol=1e-4, atol=1e-4)
    log(f"[kernels] ssd_scan chunk 64 vs 256: y max|diff| "
        f"{float((y64 - y256).abs().max()):.3e}, h max|diff| "
        f"{float((h64 - h256).abs().max()):.3e} (rtol/atol 1e-4)")

    def rows(t, b, H):        # (b, T, H, ...) -> (b*H, T, ...) copies
        return t.transpose(1, 2).reshape(b * H, *t.shape[1:2],
                                         *t.shape[3:]).contiguous()

    # the main paths' grouped calls: the model's layout through strides,
    # and rows with heads_per_group = H, against ssd_chunked
    for i, (name, shape) in enumerate(SSD_GROUP_SHAPES.items()):
        b, H, T, P, S, Q = shape
        for dt in ("float32", "bfloat16"):
            (x, d, la, B, C), = ssd_group_inputs(shape, getattr(torch, dt),
                                                 seed=20 + i)
            y, h = ssd_scan_heads(x, d, la, B, C, chunk=Q)
            y2, h2 = ssd_scan_heads(x, d, la, B, C, chunk=Q)
            yr, hr = ssd_scan(rows(x, b, H), rows(d, b, H), rows(la, b, H),
                              B, C, chunk=Q, heads_per_group=H)
            torch.cuda.synchronize()
            assert torch.equal(y, y2) and torch.equal(h, h2), (name, dt)
            yp, hp = ssd_chunked(x, d, la, B, C, chunk=Q)
            err, rel = ssd_compare(y, h, yp, hp, dt, (name, "heads"))
            err_r, _ = ssd_compare(
                yr, hr, rows(yp, b, H), hp.reshape(b * H, S, P), dt,
                (name, "rows"))
            worst[dt] = max(worst[dt], err, err_r)
            log(f"[kernels] ssd_scan grouped {name} {shape} {dt}: "
                f"ssd_scan_heads max_abs_err={err:.3e} (over max|y| "
                f"{rel:.3e}, tol {SSD_TOL[dt]}), h max|diff| "
                f"{float((h - hp).abs().max()):.3e}, a second launch "
                f"bitwise equal; rows with heads_per_group={H} "
                f"max_abs_err={err_r:.3e}")
            del x, d, la, B, C, y, h, y2, h2, yr, hr, yp, hp

    numbers = {}
    for name, shape in SSD_GROUP_SHAPES.items():
        b, H, T, P, S, Q = shape
        # inputs rotated so that every launch reads them from HBM: 16 sets
        # of the 4.8 MB serve shape, two of the 77 MB forward one
        sets = ssd_group_inputs(shape, torch.float32, seed=50,
                                copies=16 if name == "serve" else 2)
        y, h = ssd_scan_heads(*sets[0], chunk=Q)
        torch.cuda.synchronize()
        err, rel = ssd_compare(y, h, *ssd_chunked(*sets[0], chunk=Q),
                               "float32", shape)
        del y, h
        turn = itertools.cycle(sets)

        def copies(x, d, la, B, C):      # x, dt and loga transposed to rows
            return ssd_scan(rows(x, b, H), rows(d, b, H), rows(la, b, H),
                            B, C, chunk=Q, heads_per_group=H)

        def per_row(x, d, la, B, C):     # and B, C repeated for every head
            rep = lambda t: t[:, None].expand(  # noqa: E731
                b, H, T, S).reshape(b * H, T, S).contiguous()
            return ssd_scan(rows(x, b, H), rows(d, b, H), rows(la, b, H),
                            rep(B), rep(C), chunk=Q)

        iters = 200 if name == "serve" else 20
        kernel = lambda: ssd_scan_heads(*next(turn), chunk=Q)  # noqa: E731
        # the kernel timed three times, in turns with the two variants; its
        # median is the number kept
        runs = [device_ms(kernel, iters)]
        copies_ms = device_ms(lambda: copies(*next(turn)), iters)
        runs.append(device_ms(kernel, iters))
        per_row_ms = device_ms(lambda: per_row(*next(turn)), iters)
        runs.append(device_ms(kernel, iters))
        ms = float(np.median(runs))
        plain_ms = device_ms(lambda: ssd_chunked(*next(turn), chunk=Q),
                             iters=20 if name == "serve" else 4, warmup=1)
        bytes_moved, flops = ssd_work(shape)
        bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
        f32_ms = max(bytes_ms, flops / F32_FLOPS_PER_S * 1e3)
        tf32_ms = max(bytes_ms, 3 * flops / TF32_FLOPS_PER_S * 1e3)
        log(f"[kernels] ssd_scan {name} {shape} f32 (B/C ({b}, {T}, {S}), "
            f"{H} heads): ssd_scan_heads {ms:.4f} ms (median of "
            f"{', '.join(f'{t:.4f}' for t in runs)}; two launches a call), "
            f"behind transposed copies of x, dt, "
            f"loga {copies_ms:.4f} ms, behind those and per-head B, C "
            f"{per_row_ms:.4f} ms, plain ssd_chunked {plain_ms:.4f} ms; "
            f"{flops} FLOP and {bytes_moved} B: 3xTF32 bound {tf32_ms:.4f} "
            f"ms (3 x {flops} at 495 TFLOP/s; the products run on the "
            f"tensor cores), kernel at {tf32_ms / ms:.3f} of it; f32 bound "
            f"{f32_ms:.4f} ms (67 TFLOP/s), kernel at {f32_ms / ms:.3f} of "
            f"it; bytes {bytes_ms:.4f} ms; {flops / ms / 1e9:.1f} TFLOP/s; "
            f"no single PyTorch call computes the scan; max_abs_err "
            f"{err:.3e} (over max|y| {rel:.3e})")
        numbers[name] = {"max_abs_err": err, "ms": ms, "ms_runs": runs,
                         "plain_ms": plain_ms, "bound_ms": tf32_ms,
                         "bound_by": "operations" if tf32_ms > bytes_ms
                         else "bytes",
                         "bound_f32_ms": f32_ms, "copies_ms": copies_ms,
                         "per_row_ms": per_row_ms}
        del sets
        torch.cuda.empty_cache()
    return dict(numbers["serve"], library_ms=None,
                max_abs_err_all_shapes=worst,
                at_forward_shape=numbers["forward"])


TRACE_STATS = ("requests_done", "prefills", "decode_steps",
               "tokens_generated", "slot_steps", "live_slot_steps")
RECORD_FIELDS = ("rid", "submit", "admit", "first_token", "retire",
                 "decode", "budget")


def trace_stats(stats, sched=None) -> dict:
    """A trace's stats and per-request records; with a paged scheduler,
    its page counters too."""
    out = {f: getattr(stats, f) for f in TRACE_STATS}
    out["records"] = [tuple(getattr(r, f) for f in RECORD_FIELDS)
                      for r in stats.records]
    if hasattr(sched, "page_deferrals"):
        out.update(page_deferrals=sched.page_deferrals,
                   prefix_pages_hit=sched.prefix_pages_hit,
                   prefix_pages_possible=sched.prefix_pages_possible,
                   prefill_chunks=[r.prefill_chunks for r in stats.records])
    return out


def phase_serve(profile: bool = False) -> int:
    """Paged continuous-batching serving of the full-size qwen1.5-0.5b
    through the serve CLI's trace: the main path (the paged_decode
    kernel), the plain gather, a one-shot paged prefill and the ring
    scheduler held to it, teacher-forced logits, and a reduced trace on
    the card against the CPU. Returns paged_decode's launches in the
    main path's run."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels.paged_decode import paged_decode
    from repro_torch.launch.serve import make_arrivals
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_map
    from repro_torch.serving import (
        PageTable, make_scheduler, pages_per_slot, run_trace)

    cfg = get_arch("qwen1.5-0.5b")
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        "cuda")

    def run(kind, *, c=cfg, m=model, p=params, trace=SERVE_TRACE,
            device="cuda", **over):
        kw = dict(SERVE_SCHED, device=device, **over)
        if kind == "paged":
            kw = {**SERVE_PAGED, **kw}
        sched = make_scheduler(kind, m, **kw)
        arrivals = make_arrivals(c, **trace)
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.time()
        stats = run_trace(sched, p, arrivals)
        if device == "cuda":
            torch.cuda.synchronize()
        return sched, stats, arrivals, time.time() - t0

    # warm-up: allocator, cuBLAS handles, the kernel's first load
    _, st, _, wall = run("paged", trace=dict(SERVE_TRACE, requests=2, gen=4))
    log(f"[serve] warm-up: 2 requests, {st.decode_steps} decode steps in "
        f"{wall:.3f} s")

    # the main path: PagedContinuousScheduler with the kernel (auto-on)
    torch.cuda.reset_peak_memory_stats()
    paged_decode.launches = 0
    sched, stats, arrivals, wall = run("paged")
    launches = paged_decode.launches
    peak = torch.cuda.max_memory_allocated()
    main = trace_stats(stats, sched)
    pool_bytes = sum(t.numel() * t.element_size()
                     for t in sched._cache["layers"].values())
    assert sched.paged_kernel and sched.cache_pages == 321, sched.cache_pages
    assert stats.requests_done == SERVE_TRACE["requests"]
    assert launches == cfg.num_layers * stats.decode_steps, launches
    assert sched.table.num_free == sched.cache_pages - 1   # no page leaked
    assert len(sched.trie) == 0
    assert all(len(r.out_tokens) == r.budget for _, r in arrivals)
    assert sched.prefix_pages_hit > 0
    log(f"[serve] qwen1.5-0.5b paged (kernel): {stats.requests_done} "
        f"requests, {stats.prefills} prefills in "
        f"{sum(main['prefill_chunks'])} chunks, {stats.decode_steps} decode "
        f"steps, {stats.tokens_generated} tokens in {wall:.3f} s = "
        f"{stats.tokens_generated / wall:.1f} tokens/s, "
        f"{stats.decode_steps / wall:.2f} decode steps/s, util "
        f"{stats.utilization:.3f}, prefix hit rate {sched.prefix_hit_rate:.4f}"
        f" ({sched.prefix_pages_hit}/{sched.prefix_pages_possible} pages), "
        f"deferrals {sched.page_deferrals}, paged_decode launches {launches} "
        f"= {cfg.num_layers} x {stats.decode_steps}, pool {pool_bytes} B, "
        f"max_memory_allocated {peak} B, no page leaked")
    kernel_tokens = {r.rid: list(r.out_tokens) for _, r in arrivals}
    del sched
    torch.cuda.empty_cache()
    if profile:
        profile_main_path(lambda: run("paged")[3], "serve trace (paged)")

    # the same trace through the plain gather: the schedule and every
    # stat are the kernel run's (requests retire by budget, not by token)
    paged_decode.launches = 0
    sched, stats, arrivals, wall2 = run("paged", paged_kernel=False)
    assert paged_decode.launches == 0
    assert trace_stats(stats, sched) == main
    same = sum(kernel_tokens[r.rid] == r.out_tokens for _, r in arrivals)
    log(f"[serve] plain gather: {wall2:.3f} s = "
        f"{stats.tokens_generated / wall2:.1f} tokens/s, every stat and "
        f"record equal to the kernel run; {same}/{len(arrivals)} requests "
        f"with identical greedy tokens at the full vocabulary")
    del sched
    torch.cuda.empty_cache()

    # one-shot paged prefill against the ring scheduler: every stat equal
    sched, stats, _, wall3 = run("paged", prefill_chunk=None)
    oneshot = trace_stats(stats)
    del sched
    torch.cuda.empty_cache()
    sched, stats, _, wall4 = run("continuous")
    ring = trace_stats(stats)
    assert ring == oneshot, (ring, oneshot)
    for f in ("requests_done", "prefills", "tokens_generated"):
        assert ring[f] == main[f], f
    log(f"[serve] ring ContinuousScheduler: {wall4:.3f} s = "
        f"{stats.tokens_generated / wall4:.1f} tokens/s, every stat equal "
        f"to the one-shot paged run ({wall3:.3f} s, {ring['decode_steps']} "
        f"decode steps); the chunked run's {main['decode_steps']} decode "
        f"steps: its two-chunk prompts emit a tick later")
    del sched
    torch.cuda.empty_cache()

    # teacher forcing: 8 prompts of the trace prefilled, then 16 decode
    # steps fed the same tokens through the kernel and the plain gather
    ps, P = SERVE_PAGED["page_size"], pages_per_slot(
        SERVE_SCHED["max_total"], SERVE_PAGED["page_size"])
    slots, steps = SERVE_SCHED["slots"], 16
    cache = model.init_paged_cache(slots, slots * P + 1, ps, torch.float32,
                                   device="cuda")
    table = PageTable(slots * P + 1, ps)
    page_map = np.zeros((slots, P), np.int32)
    plens = np.zeros((slots,), np.int32)
    chunk = SERVE_PAGED["prefill_chunk"]
    for b, (_, req) in enumerate(arrivals[:slots]):
        plen = len(req.prompt)
        pages = table.alloc(-(-(plen + steps) // ps))
        page_map[b, :len(pages)] = pages
        padded = np.zeros((1, -(-plen // chunk) * chunk), np.int32)
        padded[0, :plen] = req.prompt
        for start in range(0, plen, chunk):
            toks = torch.from_numpy(padded[:, start:start + chunk]).cuda()
            model.prefill_chunk(params, cache, toks, start,
                                min(chunk, plen - start), page_map[b], b,
                                dtype=torch.float32)
        plens[b] = plen
    cache_plain = tree_map(lambda t: t.clone(), cache)
    feed = np.random.default_rng(5).integers(
        1, cfg.vocab_size, size=(steps, slots, 1)).astype(np.int32)
    pm, live = torch.from_numpy(page_map).cuda(), torch.ones(
        slots, dtype=torch.bool, device="cuda")
    pos = torch.from_numpy(plens).cuda()
    tf_err = 0.0
    for i in range(steps):
        tok = torch.from_numpy(feed[i]).cuda()
        lk, _ = model.decode_step_paged(params, tok, cache, pos, pm, live,
                                        dtype=torch.float32, use_kernel=True)
        lp, _ = model.decode_step_paged(params, tok, cache_plain, pos, pm,
                                        live, dtype=torch.float32,
                                        use_kernel=False)
        assert torch.isfinite(lk).all()
        tf_err = max(tf_err, float((lk - lp).abs().max()))
        pos = pos + 1
    assert tf_err <= 1e-4, tf_err
    log(f"[serve] teacher forcing, {slots} prefilled prompts of "
        f"{plens.tolist()} tokens, {steps} decode steps over "
        f"{cfg.num_layers} layers: logits max |kernel - plain| {tf_err:.3e} "
        f"(atol 1e-4)")
    del cache, cache_plain, params
    torch.cuda.empty_cache()

    # the card against the CPU: a reduced qwen, the same weights and trace
    small = cfg.reduced()
    sm = build_model(small)
    w_cpu = sm.init(torch.Generator().manual_seed(1), "cpu")
    w_gpu = tree_map(lambda t: t.cuda(), w_cpu)
    trace = dict(requests=8, prompt_len=64, gen=16, seed=1,
                 prefix_template=20, arrival_gap=2.0)
    over = dict(max_prompt=64, max_total=80, slots=4, prefill_chunk=32)
    outs = {}
    for dev, w in (("cuda", w_gpu), ("cpu", w_cpu)):
        sc, st, arr, _ = run("paged", c=small, m=sm, p=w, trace=trace,
                             device=dev, **over)
        outs[dev] = ([r.out_tokens for _, r in arr], trace_stats(st, sc))
    assert outs["cuda"] == outs["cpu"]
    log(f"[serve] reduced qwen paged trace on cuda vs cpu: the same tokens "
        f"for all {trace['requests']} requests and the same stats "
        f"({outs['cpu'][1]['decode_steps']} decode steps)")
    return launches


def record_margins(cls) -> tuple:
    """Patch ``cls._sample`` to record, at every sampling, each emitting
    request's top-two logit margin and max |logit| at the index of the
    token it is about to emit: ``{(rid, index): (margin, max_abs)}``.
    Returns (the record, a function that removes the patch)."""
    import torch
    record = {}
    original = cls._sample

    def sample(self, logits):
        last = logits[:, -1].float()
        top = torch.topk(last, 2, dim=-1).values
        margin = (top[:, 0] - top[:, 1]).cpu().numpy()
        biggest = last.abs().amax(-1).cpu().numpy()
        for i, r in enumerate(self.active):
            if r is not None and not r.done and self._slot_ready(i):
                record[(r.rid, len(r.out_tokens))] = (float(margin[i]),
                                                      float(biggest[i]))
        return original(self, logits)

    cls._sample = sample
    return record, lambda: setattr(cls, "_sample", original)


def check_tokens(name: str, got: dict, ref: dict, margins: dict) -> list:
    """Every request's greedy tokens equal the plain run's, except that a
    request may part from it at a step where the plain run's top two
    logits are within LOGIT_TOL of its max |logit| (after that step its
    tokens follow other inputs and are not compared). Returns the
    partings as (rid, index, margin / max |logit|)."""
    partings = []
    for rid, want in ref.items():
        have = got[rid]
        assert len(have) == len(want), (name, rid)
        k = next((i for i, (a, b) in enumerate(zip(have, want)) if a != b),
                 None)
        if k is None:
            continue
        margin, biggest = margins[(rid, k)]
        assert margin <= LOGIT_TOL * biggest, (
            f"{name}: request {rid} diverged at token {k}, where the plain "
            f"run's top-two margin {margin} exceeds {LOGIT_TOL} x {biggest}")
        partings.append((rid, k, margin / biggest))
    return partings


def phase_serve_ssm(profile: bool = False) -> int:
    """The serve CLI's continuous scheduler on the full-size mamba2-370m:
    the main path (``ssd_scan`` in every admission's prefill), the plain
    scan and the chunked paged scheduler held to it, and the trace's
    counts held to a CPU run at reduced width. Returns ssd_scan's
    launches in the main path's run."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_leaves
    from repro_torch.serving import ContinuousScheduler

    args = serve_cli.parse_args(SERVE_SSM_ARGV)
    cfg = get_arch(args.arch)
    model = build_model(cfg)
    device = torch.device("cuda")
    params = serve_cli.init_params(model, args, device)
    n_params = sum(t.numel() for t in tree_leaves(params))
    assert n_params == 368_285_184, n_params

    def run(argv=(), **over):
        a = serve_cli.parse_args(SERVE_SSM_ARGV + list(argv))
        return serve_cli.run_scheduler_trace(a, cfg, model, device, params,
                                             **over)

    # the trace's counts at reduced width on the CPU (they follow from the
    # trace, not the weights)
    small = cfg.reduced()
    _, cpu_stats, _, cpu_wall = serve_cli.run_scheduler_trace(
        serve_cli.parse_args(SERVE_SSM_ARGV + ["--reduced"]), small,
        build_model(small), torch.device("cpu"))
    log(f"[serve-ssm] the trace on the CPU at reduced width: "
        f"{cpu_stats.prefills} prefills, {cpu_stats.decode_steps} decode "
        f"steps, {cpu_stats.tokens_generated} tokens ({cpu_wall:.1f} s)")

    # warm-up: allocator, cuBLAS handles, the kernel's first load
    _, st, _, wall = run(["--requests", "2", "--gen", "4"])
    log(f"[serve-ssm] warm-up: 2 requests, {st.decode_steps} decode steps "
        f"in {wall:.3f} s")

    # the main path: the continuous scheduler with the kernel (auto-on)
    torch.cuda.reset_peak_memory_stats()
    ssd_scan.launches = 0
    sched, stats, arrivals, wall = run()
    launches = ssd_scan.launches
    peak = torch.cuda.max_memory_allocated()
    main = trace_stats(stats)
    state_bytes = sum(t.numel() * t.element_size()
                      for t in sched._cache["layers"].values())
    assert sched.ssd_kernel and stats.requests_done == 32
    assert main == trace_stats(cpu_stats), "the trace's counts moved"
    assert launches == cfg.num_layers * cpu_stats.prefills == 48 * 32, \
        launches
    assert all(len(r.out_tokens) == r.budget for _, r in arrivals)
    log(f"[serve-ssm] mamba2-370m continuous (kernel): "
        f"{stats.requests_done} requests, {stats.prefills} prefills, "
        f"{stats.decode_steps} decode steps, {stats.tokens_generated} "
        f"tokens in {wall:.3f} s = {stats.tokens_generated / wall:.1f} "
        f"tokens/s, {stats.decode_steps / wall:.2f} decode steps/s, util "
        f"{stats.utilization:.3f}, ssd_scan launches {launches} = "
        f"{cfg.num_layers} x {cpu_stats.prefills} prefills of the CPU run, "
        f"every stat and record equal to it; state cache {state_bytes} B, "
        f"max_memory_allocated {peak} B")
    kernel_tokens = {r.rid: list(r.out_tokens) for _, r in arrivals}
    del sched
    torch.cuda.empty_cache()
    if profile:
        profile_main_path(lambda: run()[3], "serve-ssm trace (continuous)")

    # the same trace through the plain scan, recording its logit margins
    ssd_scan.launches = 0
    margins, unpatch = record_margins(ContinuousScheduler)
    try:
        sched, stats, arrivals, wall2 = run(ssd_kernel=False)
    finally:
        unpatch()
    assert ssd_scan.launches == 0
    assert trace_stats(stats) == main
    plain_tokens = {r.rid: list(r.out_tokens) for _, r in arrivals}
    parted = check_tokens("kernel", kernel_tokens, plain_tokens, margins)
    closest = min(m / b for m, b in margins.values())
    log(f"[serve-ssm] plain ssd_chunked: {wall2:.3f} s = "
        f"{stats.tokens_generated / wall2:.1f} tokens/s (margins recorded: "
        f"one host copy per tick), every stat and record equal to the "
        f"kernel run; {32 - len(parted)}/32 requests with identical greedy "
        f"tokens, partings (rid, token, margin / max|logit|) {parted}; "
        f"smallest top-two margin of the plain run {closest:.3e} of max "
        f"|logit| over {len(margins)} sampled tokens (tol {LOGIT_TOL})")
    del sched
    torch.cuda.empty_cache()

    # the paged scheduler, chunks of 256: first chunks through the kernel,
    # later ones through ssd_chunked from the carried state
    ssd_scan.launches = 0
    sched, stats, arrivals, wall3 = run(["--scheduler", "paged",
                                         "--prefill-chunk", "256"])
    chunks = [r.prefill_chunks for r in stats.records]
    assert ssd_scan.launches == cfg.num_layers * 32, ssd_scan.launches
    assert sum(chunks) > 32 and sched.table.num_free == sched.cache_pages - 1
    for f in ("requests_done", "prefills", "tokens_generated"):
        assert getattr(stats, f) == main[f], f
    parted_paged = check_tokens(
        "paged", {r.rid: list(r.out_tokens) for _, r in arrivals},
        plain_tokens, margins)
    log(f"[serve-ssm] paged, chunks of 256: {wall3:.3f} s = "
        f"{stats.tokens_generated / wall3:.1f} tokens/s, {sum(chunks)} "
        f"chunks ({sum(c > 1 for c in chunks)} prompts in two), "
        f"{stats.decode_steps} decode steps, ssd_scan launches "
        f"{ssd_scan.launches} (the first chunks), no page used; requests, "
        f"prefills and tokens equal to the ring run; partings from the "
        f"plain run {parted_paged}")
    del sched, params
    torch.cuda.empty_cache()
    return launches


def phase_forward_ssm() -> None:
    """The full-size mamba2-370m forward through the kernel against the
    plain scan, and a reduced mamba2 serve trace on the card against the
    CPU."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.models import build_model
    from repro_torch.launch.serve import make_arrivals
    from repro_torch.models.common import tree_map
    from repro_torch.serving import make_scheduler, run_trace

    cfg = get_arch("mamba2-370m")
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        1, cfg.vocab_size, size=(8, 1024))).to("cuda")
    with torch.no_grad():
        model.forward(params, {"tokens": toks[:, :256]}, dtype=torch.float32,
                      use_kernel=True)                    # warm-up
        torch.cuda.synchronize()
        ssd_scan.launches = 0
        t0 = time.time()
        lk, _ = model.forward(params, {"tokens": toks}, dtype=torch.float32,
                              use_kernel=True)
        torch.cuda.synchronize()
        t_kernel = time.time() - t0
        assert ssd_scan.launches == cfg.num_layers, ssd_scan.launches
        t0 = time.time()
        lp, _ = model.forward(params, {"tokens": toks}, dtype=torch.float32)
        torch.cuda.synchronize()
        t_plain = time.time() - t0
    assert lk.shape == (8, 1024, cfg.padded_vocab)
    assert torch.isfinite(lk).all()
    err = float((lk - lp).abs().max())
    biggest = float(lp.abs().max())
    assert err <= 1e-4 * biggest, (err, biggest)
    log(f"[forward-ssm] mamba2-370m forward, 8 x 1024 tokens f32, "
        f"{cfg.num_layers} layers: kernel {t_kernel:.3f} s "
        f"({cfg.num_layers} ssd_scan launches), plain ssd_chunked "
        f"{t_plain:.3f} s; logits max "
        f"|kernel - plain| {err:.3e}, max |logit| {biggest:.3f} (tol "
        f"{1e-4 * biggest:.3e})")
    del lk, lp, params
    torch.cuda.empty_cache()

    # the card against the CPU: a reduced mamba2, the same weights and trace
    small = cfg.reduced()
    sm = build_model(small)
    w_cpu = sm.init(torch.Generator().manual_seed(1), "cpu")
    w_gpu = tree_map(lambda t: t.to("cuda"), w_cpu)
    trace = dict(requests=8, prompt_len=64, gen=16, seed=1,
                 prefix_template=20, arrival_gap=2.0)
    outs = {}
    for dev, w in (("cuda", w_gpu), ("cpu", w_cpu)):
        sched = make_scheduler("continuous", sm, slots=4, max_prompt=64,
                               max_total=80, temperature=0.0, device=dev)
        arrivals = make_arrivals(small, **trace)
        stats = run_trace(sched, w, arrivals)
        outs[dev] = ([r.out_tokens for _, r in arrivals], trace_stats(stats))
    assert outs["cuda"] == outs["cpu"]
    log(f"[forward-ssm] reduced mamba2 continuous trace on cuda (kernel) vs "
        f"cpu (plain): the same tokens for all {trace['requests']} requests "
        f"and the same stats ({outs['cpu'][1]['decode_steps']} decode "
        f"steps)")


def profile_main_path(fn, label: str) -> None:
    """Device time by kernel and the device's busy share over one run
    of a main path (torch.profiler, CUDA activity only: recording every
    host operator of a scale interval, some 10^6 events, takes minutes
    to process); ``fn`` runs it and returns its wall time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wall = fn()
    # device-side entries only (kernels, copies), not the runtime calls
    # that launched them
    events = [e for e in prof.key_averages()
              if str(getattr(e, "device_type", "")).endswith("CUDA")]

    def device_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    busy_us = sum(device_us(e) for e in events)
    log(f"[profile] {label}: wall {wall:.3f} s, device busy "
        f"{busy_us / 1e6:.3f} s, idle share {1 - busy_us / 1e6 / wall:.3f}")
    for e in sorted(events, key=device_us, reverse=True)[:15]:
        if device_us(e) > 0:
            log(f"[profile] {device_us(e) / 1e3:10.3f} ms {e.count:6d}x "
                f"{e.key[:90]}")


def main() -> int:
    import torch
    import repro_torch  # noqa: F401  (fails without the repository)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(card_line())
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    profile = "--profile" in sys.argv[1:]
    t0 = time.time()

    def timed(name, fn, *args, **kw):
        t = time.time()
        out = fn(*args, **kw)
        log(f"[time] phase {name}: {time.time() - t:.1f} s "
            f"(script at {time.time() - t0:.1f} s)")
        return out

    timed("build", phase_build)
    numbers = {"consensus_mix": timed("kernels", phase_kernels),
               **timed("fused kernels", phase_fused_kernels)}
    numbers["paged_decode"] = timed("paged kernel", phase_paged_kernel)
    numbers["ssd_scan"] = timed("ssd kernel", phase_ssd_kernel)
    launches = {"consensus_mix": timed("slice", phase_slice,
                                       profile=profile),
                **timed("scale", phase_scale, profile=profile),
                "paged_decode": timed("serve", phase_serve,
                                      profile=profile),
                "ssd_scan": timed("serve-ssm", phase_serve_ssm,
                                  profile=profile)}
    timed("forward-ssm", phase_forward_ssm)
    replaces = {"consensus_mix": "src/repro/kernels/consensus_mix.py:44",
                "fused_consensus_sgd":
                    "src/repro/kernels/fused_consensus_sgd.py:52",
                "fused_sgd": "src/repro/kernels/fused_sgd.py:37",
                "paged_decode": "src/repro/kernels/paged_attn.py:76",
                "ssd_scan": "src/repro/kernels/ssd_scan.py:75"}
    # fused_sgd's streaming kernel shares fused_consensus_sgd.cu (and its
    # SGD step) with fused_consensus_sgd
    sources = {"consensus_mix": "src/repro_torch/csrc/consensus_mix.cu",
               "fused_consensus_sgd":
                   "src/repro_torch/csrc/fused_consensus_sgd.cu",
               "fused_sgd": "src/repro_torch/csrc/fused_consensus_sgd.cu",
               "paged_decode": "src/repro_torch/csrc/paged_decode.cu",
               "ssd_scan": "src/repro_torch/csrc/ssd_scan.cu"}
    kernels = []
    for name, nums in numbers.items():
        entry = {
            "name": name, "route": "cuda", "source": sources[name],
            "replaces": replaces[name], "launches": launches[name],
            "on_main_path": name != "fused_sgd",
            "max_abs_err": nums["max_abs_err"], "ms": nums["ms"],
            "plain_ms": nums["plain_ms"], "bound_ms": nums["bound_ms"],
            "bound_by": nums["bound_by"], "library_ms": nums["library_ms"],
            "max_abs_err_all_shapes": nums["max_abs_err_all_shapes"]}
        entry.update({key: value for key, value in nums.items()
                      if key.startswith("at_")})
        kernels.append(entry)
    log(card_line())
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
