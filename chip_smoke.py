#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It drives the port's main path — the paper's Algorithm 1 in simulation
mode at the paper's Sec. IV size (125 devices in 25 clusters, the
784-7840-10 NN) — and holds every kernel of that path against its
plain PyTorch version. Phases (any failure ends the run with a
non-zero exit; nothing is caught):

1. build   — compile every CUDA source of the port with nvcc (sm_90a).
2. kernels — ``consensus_mix`` against ``consensus_mix_plain`` on the
             card at the shapes of tests/test_kernels.py and of the main
             path, f32 (atol 1e-5) and bf16 (atol 2e-2); at the main
             path's largest leaf it times the kernel, the plain version
             and one ``torch.bmm`` with the precomputed ``V^Γ`` (the
             library yardstick, which the port never calls).
3. slice   — ``TTHFTrainer`` on the card, kernel on: 40 steps, with the
             launch counter reset just before; then the same run through
             the ``masked_loop`` backend (same loss history, same
             ledger), the SVM, and Remark-1 adaptive Γ (kernel and
             ``masked_loop``, held against each other); and a small run
             on the card against the same run on the CPU.

It prints the card's name and power limit first, one JSON line with the
kernels' numbers before the last line, and as the last line
``{"ok": true, "device": {...}}``. Float32 products run in full float32
(TF32 off for matmul and cuDNN). Without a CUDA device, or without the
rest of the repository beside it, it exits non-zero and prints no result.

``--profile`` adds one profiled 20-step run of the main path and prints
the device time by kernel and the device's idle share.
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
                                      run_steps=20))
    return launches


def profile_main_path(fn) -> None:
    """Device time by kernel and the device's busy share over one run
    of the main path (torch.profiler, CPU and CUDA activities)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, _, wall = fn()
    # device-side entries only (kernels, copies): the operators that
    # launched them carry the same time again
    events = [e for e in prof.key_averages()
              if str(getattr(e, "device_type", "")).endswith("CUDA")]

    def device_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    busy_us = sum(device_us(e) for e in events)
    log(f"[profile] 20 steps: wall {wall:.3f} s, device busy "
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
    phase_build()
    numbers = phase_kernels()
    launches = phase_slice(profile="--profile" in sys.argv[1:])
    kernel = {
        "name": "consensus_mix", "route": "cuda",
        "source": "src/repro_torch/csrc/consensus_mix.cu",
        "replaces": "src/repro/kernels/consensus_mix.py:44",
        "launches": launches, "max_abs_err": numbers["max_abs_err"],
        "ms": numbers["ms"], "plain_ms": numbers["plain_ms"],
        "bound_ms": numbers["bound_ms"], "bound_by": numbers["bound_by"],
        "library_ms": numbers["library_ms"],
        "max_abs_err_all_shapes": numbers["max_abs_err_all_shapes"],
    }
    print(json.dumps({"kernels": [kernel]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
