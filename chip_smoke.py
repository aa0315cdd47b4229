#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It drives the port's two main paths — the paper's Algorithm 1 in
simulation mode at the paper's Sec. IV size (125 devices in 25 clusters,
the 784-7840-10 NN), and TT-HF as the scale-mode sync strategy on the
full-size qwen1.5-0.5b (24 layers, d 1024, vocabulary 151,936) — and
holds every kernel of those paths against its plain PyTorch version.
Phases (any failure ends the run with a non-zero exit; nothing is
caught):

1. build   — compile every CUDA source of the port with nvcc (sm_90a),
             one nvcc per source, all started together.
2. kernels — each kernel against its plain version on the card:
             ``consensus_mix`` at the shapes of tests/test_kernels.py and
             of the sim path, f32 (atol 1e-5) and bf16 (atol 2e-2);
             ``fused_consensus_sgd`` and ``fused_sgd`` at the shapes of
             tests/test_kernels.py with wd in {0, 0.1} (atol 1e-6 in f32,
             1e-2 in bf16) and at the scale path's flat replica buffer,
             f32. At the main paths' shapes it times each kernel, its
             plain version and a library yardstick the port never calls
             (``torch.bmm`` with the precomputed ``V^Γ``; ``torch.add``
             with ``alpha=-η``; and the two calls ``torch.bmm(W,
             torch.add(w, g, alpha=-η))``).
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

It prints the card's name and power limit first, one JSON line with the
kernels' numbers before the last line, and as the last line
``{"ok": true, "device": {...}}``. Float32 products run in full float32
(TF32 off for matmul and cuDNN). Without a CUDA device, or without the
rest of the repository beside it, it exits non-zero and prints no result.

``--profile`` adds one profiled 20-step run of the sim path and one
profiled interval of the scale path, and prints the device time by
kernel and the device's idle share.
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


def phase_build() -> None:
    from repro_torch.kernels import build
    t0 = time.time()
    reports = build.build()
    log(f"[build] {build.sources()} built with nvcc "
        f"{' '.join(build.NVCC_FLAGS)} in {time.time() - t0:.2f} s")
    for name, report in reports.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")


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
                err = compare(out, fused_sgd_plain(w, g, 0.01,
                                                   weight_decay=wd), dt,
                              shape)
                d = worst["fused_sgd"]
                d[dt] = max(d.get(dt, 0.0), err)
                log(f"[kernels] fused_sgd {shape} {dt} wd={wd} "
                    f"max_abs_err={err:.3e} (tol {SGD_TOL[dt]})")

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
    err = compare(out, fused_sgd_plain(w2, g2, eta), "float32",
                  "fused_sgd main")
    del out
    torch.cuda.empty_cache()
    ms = cuda_ms(lambda: fused_sgd(w2, g2, eta), iters=10, warmup=2)
    plain_ms = cuda_ms(lambda: fused_sgd_plain(w2, g2, eta), iters=3)
    library_ms = cuda_ms(lambda: torch.add(w2, g2, alpha=-SCALE_LR),
                         iters=10, warmup=2)
    b_ms, b_by = bound(bytes_moved, n * 2)
    log(f"[kernels] fused_sgd (4, {QWEN_P}) f32: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, torch.add(w, g, alpha=-η) {library_ms:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by}: {bytes_moved} B at 3.35 TB/s), "
        f"kernel at {bytes_moved / ms / 1e6:.1f} GB/s, max_abs_err "
        f"{err:.3e}")
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
    launches = {"consensus_mix": timed("slice", phase_slice,
                                       profile=profile),
                **timed("scale", phase_scale, profile=profile)}
    replaces = {"consensus_mix": "src/repro/kernels/consensus_mix.py:44",
                "fused_consensus_sgd":
                    "src/repro/kernels/fused_consensus_sgd.py:52",
                "fused_sgd": "src/repro/kernels/fused_sgd.py:37"}
    # fused_sgd launches fused_consensus_sgd.cu's one-replica instance
    sources = {"consensus_mix": "src/repro_torch/csrc/consensus_mix.cu",
               "fused_consensus_sgd":
                   "src/repro_torch/csrc/fused_consensus_sgd.cu",
               "fused_sgd": "src/repro_torch/csrc/fused_consensus_sgd.cu"}
    kernels = []
    for name, nums in numbers.items():
        kernels.append({
            "name": name, "route": "cuda", "source": sources[name],
            "replaces": replaces[name], "launches": launches[name],
            "on_main_path": name != "fused_sgd",
            "max_abs_err": nums["max_abs_err"], "ms": nums["ms"],
            "plain_ms": nums["plain_ms"], "bound_ms": nums["bound_ms"],
            "bound_by": nums["bound_by"], "library_ms": nums["library_ms"],
            "max_abs_err_all_shapes": nums["max_abs_err_all_shapes"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
