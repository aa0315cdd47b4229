#!/usr/bin/env python3
"""The port's layer spans on the card: the shared clock, what tracing
costs, and the layer readings of the benchmark's three cells.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 tools/trace_layers.py [--cells sim.nn7840.static,...]
        [--seed N] [--out chiprun_out/trace_layers.json]
    python3 tools/trace_layers.py --tiny     # the CPU, the tests' sizes

1. ``clock``: ``torch.profiler`` (host and CUDA activity) over a device
   span (``repro_torch.obs``) around two kernels: the span's host
   interval against the ``cudaLaunchKernel`` calls issued in it, its
   device interval against the kernels' device start and end, and the
   profiler's host stamps against ``time.time_ns()``.
2. Each cell, set up as ``perfbench/run.py`` sets it up (its driver's
   ``setup``, the same inputs from ``--seed``), then:
   - ``cost``: windows in turns (bare, spans-only sink, sink, bare, ...;
     the sim cells 10 aggregation periods a window, training ``run(2)``),
     each ending on a synchronise;
   - the benchmark's traced window (the sim cells 2 periods, training the
     last interval's step; CUDA activity only), bare and then with a
     spans-only sink: the idle share of each as ``harness.trace`` reads
     it, and with the sink the layer readings of ``perfbench/spans.py``
     (``local_step_ms``, ``idle_in_snapshot``, ``replica_grads_ms``,
     ``idle_in_gc``), the share of the ``local_step`` spans whose
     ``fused`` arg is set (``local_step_fused_share``, the spans that took
     the model's fused step), the layer counters (snapshot builds and cache
     hits, collections by generation) and the window's ten longest idle
     gaps, each with the CUDA runtime call under its middle, the
     innermost program span there and the layer spans it overlaps.

One JSON line a phase on standard output; all of them in ``--out``. The
card's name and power limit come first.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[0:0] = [str(ROOT), str(ROOT / "src")]

CELLS = ("sim.nn7840.static", "sim.nn7840.churn", "train.mamba2-370m.tthf")


def log(rec: dict) -> dict:
    print(json.dumps(rec), flush=True)
    return rec


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------------------
# the profiler, its events kept
# ---------------------------------------------------------------------------

def profiled(fn, device, host_ops: bool = False):
    """``fn()`` under ``torch.profiler``: CUDA activity on the card (and
    host operators with ``host_ops``), host activity on the CPU. ->
    (fn's result, {"lo", "hi": the window on the profiler's clock,
    "wall_s", "device": [(a, b, name)], "host": [(a, b, name)]})."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = ([ProfilerActivity.CUDA] if device.type == "cuda"
            else [ProfilerActivity.CPU])
    if host_ops and device.type == "cuda":
        acts.append(ProfilerActivity.CPU)
    sync(device)
    with profile(activities=acts) as prof:
        lo, t0 = time.time_ns(), time.perf_counter()
        out = fn()
        sync(device)
        wall, hi = time.perf_counter() - t0, time.time_ns()
    CUDA = torch._C._autograd.DeviceType.CUDA
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        iv = (e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
        (dev if e.device_type() == CUDA else host).append(iv)
    return out, {"lo": lo, "hi": hi, "wall_s": wall, "device": dev,
                 "host": host}


# ---------------------------------------------------------------------------
# 1. the clock
# ---------------------------------------------------------------------------

def clock(device) -> dict:
    import torch
    from repro_torch.obs.sink import Observability
    a = torch.randn(4096, 4096, device=device)
    b = torch.empty_like(a)
    for _ in range(3):
        torch.mm(a, a, out=b)
    sync(device)
    obs = Observability()

    def work():
        stamps = [time.time_ns()]
        with torch.profiler.record_function("clock_probe"):
            pass
        stamps.append(time.time_ns())
        with obs.device_span("probe", device):
            a.mul_(1.0)
            torch.mm(a, a, out=b)
        return stamps
    profiled(lambda: None, device, host_ops=True)   # CUPTI's start-up
    (before, after), tr = profiled(work, device, host_ops=True)
    obs.close()
    (s,) = [x for x in obs.spans() if x["name"] == "probe"]
    (rf,) = [h for h in tr["host"] if h[2] == "clock_probe"]
    launches = [h for h in tr["host"] if "LaunchKernel" in h[2]]
    kernels = sorted(tr["device"])
    rec = {"phase": "clock", "span_host_ns": [s["start_ns"], s["end_ns"]],
           "span_device_ns": [s.get("dev_start_ns"), s.get("dev_end_ns")],
           "window_ns": [tr["lo"], tr["hi"]],
           # time.time_ns() just before and after a record_function
           # against the profiler's stamps of it
           "record_function_after_time_ns_us": (rf[0] - before) / 1e3,
           "record_function_before_time_ns_us": (after - rf[1]) / 1e3}
    rec["launches"] = [
        {"name": n, "after_span_start_us": (x - s["start_ns"]) / 1e3,
         "before_span_end_us": (s["end_ns"] - y) / 1e3,
         "inside": s["start_ns"] <= x and y <= s["end_ns"]}
        for x, y, n in launches]
    rec["kernels"] = [
        {"name": n[:60],
         "after_device_start_us": (x - s["dev_start_ns"]) / 1e3,
         "before_device_end_us": (s["dev_end_ns"] - y) / 1e3,
         "start_inside": s["dev_start_ns"] <= x <= s["dev_end_ns"],
         "end_inside": y <= s["dev_end_ns"]}
        for x, y, n in kernels]
    rec["ok"] = bool(launches and kernels and before <= rf[0] <= rf[1]
                     <= after
                     and all(k["inside"] for k in rec["launches"])
                     and all(k["start_inside"] for k in rec["kernels"]))
    return rec


# ---------------------------------------------------------------------------
# 2. the cells
# ---------------------------------------------------------------------------

def idle_share(tr: dict) -> float:
    """``harness.trace``'s reading: 1 - busy / wall, in %."""
    from perfbench.spans import union
    busy = sum(b - a for a, b in union((a, b) for a, b, _ in
                                       tr["device"])) * 1e-9
    return 100.0 * (1.0 - busy / tr["wall_s"])


def reduced(tr: dict) -> dict:
    """A bare window's idle share and wall time alone: its events, some
    10^5 tuples in training, would lengthen the next window's garbage
    collections."""
    return {"bare_idle_share": idle_share(tr), "bare_window_s": tr["wall_s"]}


def readings(tr: dict, obs) -> dict:
    """The window's layer readings from the sink's spans, its last
    samples of the layer counters (``netsim.snapshot``: builds and
    cache hits; ``gc``: collections by generation), and its gaps."""
    from perfbench import spans as red
    spans = obs.spans()
    lo, hi = tr["lo"], tr["hi"]
    idle = red.idle_stretches([(a, b) for a, b, _ in tr["device"]],
                              lo, hi)
    out = {"window_s": (hi - lo) * 1e-9, "idle_share": idle_share(tr),
           "spans_in_window": len([s for s in spans
                                   if lo <= s["start_ns"] <= hi])}
    for e in obs.tracer.events:
        if e["ph"] == "C" and e.get("cat") == "layer":
            out[f"counter_{e['name']}"] = e["args"]
    for name in ("local_step", "replica_grads", "block_end", "eval",
                 "consensus_event", "aggregation"):
        ms = red.median_device_ms([s for s in spans if s["cat"] == "layer"],
                                  name, lo, hi)
        if ms is not None:
            out[f"{name}_ms"] = ms
            out[f"{name}_n"] = len(red.named(
                [s for s in spans if s["cat"] == "layer"], name, lo, hi))
    steps = red.named([s for s in spans if s["cat"] == "layer"],
                      "local_step", lo, hi)
    if steps:
        # the share of the window's local steps that took the model's
        # fused step (the span's ``fused`` arg)
        out["local_step_fused_share"] = 100.0 * sum(
            bool(s["args"].get("fused")) for s in steps) / len(steps)
    for name in ("netsim.snapshot", "gc"):
        out[f"idle_in_{name}"] = red.idle_share_in(spans, name, idle, lo,
                                                   hi)
    gaps = []
    for a, b in sorted(idle, key=lambda g: g[0] - g[1])[:10]:
        mid = (a + b) // 2
        call = None
        for x, y, n in tr["host"]:
            if x <= mid <= y and (call is None or y - x < call[1] - call[0]):
                call = (x, y, n)
        inner = red.innermost(spans, mid)
        chain, byid = [], {s["id"]: s for s in spans}
        s = inner
        while s is not None:
            chain.append(s["name"])
            s = byid.get(s["parent"])
        over = {}
        for s in spans:
            if s["cat"] == "layer" and "device" not in s:
                o = min(b, s["end_ns"]) - max(a, s["start_ns"])
                if o > 0:
                    over[s["name"]] = over.get(s["name"], 0.0) + o * 1e-6
        gaps.append({"ms": (b - a) * 1e-6, "at_s": (a - lo) * 1e-9,
                     "cuda_call": call[2] if call else
                     "(host: no CUDA call)",
                     "innermost": " < ".join(chain) or None,
                     "host_layer_ms": over})
    out["gaps"] = gaps
    return out


def sim_cell(cell, seed: int, device, pairs: int, chunks: int) -> list:
    from perfbench.drivers import sim
    from repro_torch.obs.sink import NULL_OBS, Observability
    cfg = cell.config
    chunk, every = cfg["schedule"]["tau"], cfg["eval_every"]
    t0 = time.perf_counter()
    tr, st, _, per_chunk = sim.setup(cell, seed, device)
    setup_s = time.perf_counter() - t0

    def window(n, obs):
        nonlocal st
        for _ in range(n):
            st, _ = tr.run(chunk, eval_every=every, state=st, obs=obs)

    recs = []
    walls = {"bare": [], "sink": []}
    for i in range(pairs):
        for kind in (("bare", "sink") if i % 2 == 0 else ("sink", "bare")):
            obs = Observability() if kind == "sink" else NULL_OBS
            sync(device)
            t = time.perf_counter()
            window(chunks, obs)
            sync(device)
            walls[kind].append(chunks * chunk / (time.perf_counter() - t))
            if kind == "sink":
                obs.close()
    recs.append(log({"phase": "cost", "cell": cell.name,
                     "setup_s": setup_s, "steps_per_s": walls,
                     "median_ratio": statistics.median(walls["sink"])
                     / statistics.median(walls["bare"])}))
    n = cell.traffic["trace_chunks"]
    profiled(lambda: None, device)              # the profiler's start-up
    bare = reduced(profiled(lambda: window(n, NULL_OBS), device)[1])
    obs = Observability()
    _, traced = profiled(lambda: window(n, obs), device)
    obs.close()
    recs.append(log({"phase": "trace", "cell": cell.name, **bare,
                     **readings(traced, obs)}))
    del tr, st
    return recs


def train_cell(cell, seed: int, device, pairs: int) -> list:
    import gc

    from perfbench.drivers import scale
    from repro_torch.obs.sink import NULL_OBS, Observability
    t0 = time.perf_counter()
    tr, rec, _ = scale.setup(cell, seed, device)
    setup_s = time.perf_counter() - t0
    rec.close()
    tok = (cell.traffic["tau"] * cell.traffic["replicas"]
           * cell.traffic["batch_per_replica"] * cell.traffic["seq_len"])

    recs = []
    rates = {"bare": [], "sink": []}
    for i in range(pairs):
        for kind in (("bare", "sink") if i % 2 == 0 else ("sink", "bare")):
            obs = Observability() if kind == "sink" else NULL_OBS
            sync(device)
            t = time.perf_counter()
            tr.run(2, obs=obs)
            sync(device)
            rates[kind].append(2 * tok / (time.perf_counter() - t))
            if kind == "sink":
                obs.close()
    recs.append(log({"phase": "cost", "cell": cell.name,
                     "setup_s": setup_s, "tokens_per_s": rates,
                     "median_ratio": statistics.median(rates["sink"])
                     / statistics.median(rates["bare"])}))

    # the benchmark's traced window: the last interval's step
    step, n = tr._step, cell.traffic["trace_intervals"]
    got = {}

    def record(obs):
        calls = []

        def wrapped(*a, **k):
            calls.append(None)
            if len(calls) == n:
                out, got["trace"] = profiled(lambda: step(*a, **k), device)
            else:
                out = step(*a, **k)
            float(out[1])                       # as the driver reads it
            return out
        tr._step = wrapped
        try:
            tr.run(n, obs=obs)
        finally:
            tr._step = step
        return got.pop("trace")

    profiled(lambda: None, device)
    bare = reduced(record(NULL_OBS))
    obs = Observability()
    traced = record(obs)
    obs.close()
    recs.append(log({"phase": "trace", "cell": cell.name, **bare,
                     "gc_counts": gc.get_count(),
                     **readings(traced, obs)}))
    del tr
    return recs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", default=",".join(CELLS))
    ap.add_argument("--seed", type=int, default=7_100_000_001)
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--chunks", type=int, default=10)
    ap.add_argument("--tiny", action="store_true",
                    help="the CPU and the benchmark tests' tiny cells")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"
                                         / "trace_layers.json"))
    args = ap.parse_args(argv)
    os.environ.setdefault("REPRO_TORCH_BUILD_DIR",
                          str(ROOT / "src" / "repro_torch" / "build"))
    import torch

    from perfbench import harness
    from perfbench.drivers.common import free
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.tiny:
        device = torch.device("cpu")
        conftest = harness.load_module(
            harness.HERE / "tests" / "conftest.py", "perfbench_conftest")
        cells = {"sim.nn7840.static": conftest.tiny_sim(
                     "static", "sim.nn7840.static"),
                 "sim.nn7840.churn": conftest.tiny_sim(
                     "device_churn", "sim.nn7840.churn"),
                 "train.mamba2-370m.tthf": conftest.tiny_train()}
        recs = [log({"phase": "card", "card": "cpu (rehearsal)",
                     "torch": torch.__version__})]
    else:
        if not torch.cuda.is_available():
            print("trace_layers: needs a CUDA device (or --tiny)",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        cells = {name: harness.Cell.load(name) for name in CELLS}
        recs = [log({"phase": "card", "card": card_line(),
                     "torch": torch.__version__})]
        recs.append(log(clock(device)))
    for name in args.cells.split(","):
        cell = cells[name]
        cell.name = name
        if cell.config["kind"] == "sim":
            recs += sim_cell(cell, args.seed, device, args.pairs,
                             args.chunks)
        else:
            recs += train_cell(cell, args.seed, device, args.pairs)
        free(device)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text("\n".join(json.dumps(r) for r in recs) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
