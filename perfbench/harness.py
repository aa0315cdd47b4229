"""What every driver shares: cell lookup, the model plug-ins, the clock,
the device record, the profiler's reduction to busy time, kernel time,
the idle stretches, the longest device operations and idle gaps, the
correctness checks, and the guard against JAX in the process."""
from __future__ import annotations

import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
# one plug-in a model kind: models/<kind>.py (see model_plugin)
MODELS = HERE / "models"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def model_plugin(cfg: dict):
    """The plug-in of the configuration's ``model.kind``,
    ``models/<kind>.py``. It exports ``model_config(cfg)`` (the program's
    ``ModelConfig``), ``weights(cfg, seed, device)`` (the parameter tree
    from the seed), ``loss(params, tokens, labels, cfg, prec)`` (the
    plain model's mean loss in ``prec``, for the reference) and
    ``window_flops(cfg, traffic, intervals, facts)`` (the model
    operations of the traced intervals)."""
    kind = cfg["model"]["kind"]
    return load_module(MODELS / f"{kind}.py", f"perfbench_model_{kind}")


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""
    name: str
    config: dict
    traffic: dict
    limits: dict
    chips: int
    end_to_end: list
    per_layer: list

    @classmethod
    def load(cls, name: str, bench: dict | None = None) -> "Cell":
        bench = bench or load_json(ROOT / "BENCHMARK.json")
        wl = {w["name"]: w for w in bench["workloads"]}
        if name not in wl:
            raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json "
                             f"has {sorted(wl)}")
        w = wl[name]
        conf = {c["name"]: c for c in bench["configs"]}[w["config"]]

        def mine(metric):
            return "workloads" not in metric or name in metric["workloads"]
        return cls(name=name, config=load_json(ROOT / conf["file"]),
                   traffic=load_json(HERE / "traffic"
                                     / f"{w['traffic']}.json"),
                   limits=load_json(HERE / "limits" / f"{name}.json"),
                   chips=int(w["chips"]),
                   end_to_end=[m for m in bench["end_to_end"] if mine(m)],
                   per_layer=[m for m in bench["per_layer"] if mine(m)])


def sync(device) -> None:
    if getattr(device, "type", device) == "cuda":
        import torch
        torch.cuda.synchronize()


def forbidden_loaded() -> list[str]:
    """Modules of JAX or of the JAX package in this process, compared by
    whole top-level name."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


# ---------------------------------------------------------------------------
# the profiler
# ---------------------------------------------------------------------------

@dataclass
class Trace:
    """A traced stretch: its wall seconds, the seconds in which the card
    ran a kernel or a copy, device seconds by kernel name, the longest
    idle gaps with the host operation under each, and the window's ends
    ``lo``, ``hi`` and its idle stretches ``idle`` in nanoseconds on the
    profiler's clock, which program spans are stamped on."""
    window_s: float
    busy_s: float
    by_name: dict
    idle_gaps: list = field(default_factory=list)
    lo: int = 0
    hi: int = 0
    idle: list = field(default_factory=list)

    def kernel_s(self, fragment: str) -> float:
        return sum(v for k, v in self.by_name.items() if fragment in k)

    def breakdown(self) -> dict:
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [list(g) for g in self.idle_gaps[:10]]}


def _ns(e, what: str) -> int:
    f = getattr(e, f"{what}_ns", None)
    return int(f()) if f is not None else int(getattr(e, f"{what}_us")()
                                              * 1000)


def trace(fn, device) -> tuple[object, Trace]:
    """Run ``fn()`` under the profiler and reduce what it recorded: on
    the card CUDA activity alone (kernels, copies and the host's CUDA
    runtime calls, which label the idle gaps), on the CPU host
    operations. -> (fn's result, the trace)."""
    import torch
    from torch._C._profiler import _ExperimentalConfig
    from torch.autograd import (ProfilerActivity, ProfilerConfig,
                                ProfilerState, _disable_profiler,
                                _enable_profiler, _prepare_profiler)

    from perfbench.spans import idle_stretches
    cfg = ProfilerConfig(ProfilerState.KINETO, False, False, False, False,
                         False, _ExperimentalConfig())
    acts = {ProfilerActivity.CUDA
            if getattr(device, "type", device) == "cuda"
            else ProfilerActivity.CPU}
    sync(device)
    _prepare_profiler(cfg, acts)
    _enable_profiler(cfg, acts)
    try:
        lo, t0 = time.time_ns(), time.perf_counter()
        out = fn()
        sync(device)
        wall, hi = time.perf_counter() - t0, time.time_ns()
    finally:
        results = _disable_profiler()
    CUDA = torch._C._autograd.DeviceType.CUDA
    dev, host = [], []
    for e in results.events():
        iv = (_ns(e, "start"), _ns(e, "start") + e.duration_ns()
              if hasattr(e, "duration_ns") else _ns(e, "end"), e.name())
        (dev if e.device_type() == CUDA else host).append(iv)
    by_name: dict = {}
    for a, b, n in dev:
        by_name[n] = by_name.get(n, 0.0) + (b - a) * 1e-9
    merged = []
    for a, b, _ in sorted(dev):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged) * 1e-9
    gaps = []
    if merged and host:
        lo = min(a for a, _, _ in host + dev)
        hi = max(b for _, b, _ in host + dev)
        edges = [lo] + [x for iv in merged for x in iv] + [hi]
        gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                       for i in range(0, len(edges) - 1, 2)
                       if edges[i + 1] > edges[i]), reverse=True)[:10]

    def under(t):
        best = None
        for a, b, n in host:
            if a <= t <= b and (best is None or b - a < best[0]):
                best = (b - a, n)
        return best[1] if best else "(host: no CUDA call)"
    idle = [(under(a + g // 2), g * 1e-9) for g, a in gaps]
    return out, Trace(window_s=wall, busy_s=busy, by_name=by_name,
                      idle_gaps=idle, lo=lo, hi=hi,
                      idle=idle_stretches([(a, b) for a, b, _ in dev],
                                          lo, hi))


# ---------------------------------------------------------------------------
# correctness
# ---------------------------------------------------------------------------

def rel_gap(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def leaf_gaps(prog: dict, ref: dict, ref_first: dict) -> dict:
    """Each leaf's gap between the program's and the reference's norms,
    against the reference's norm of that leaf or of the median leaf,
    whichever is larger. Leaves whose first-step reference change is
    under a thousandth of the median leaf's move by round-off alone and
    are left out."""
    med_first = sorted(ref_first.values())[len(ref_first) // 2]
    keep = [k for k in ref if ref_first[k] >= 1e-3 * med_first]
    med = sorted(ref[k] for k in keep)[len(keep) // 2]
    return {k: (abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
                if math.isfinite(prog[k]) else math.inf) for k in keep}


def checks(values: dict, limits: dict) -> dict:
    """{name: {"value", "limit"}}; a value that is not finite fails."""
    return {k: {"value": float(v), "limit": float(limits[k])}
            for k, v in values.items()}


def passed(chk: dict) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in chk.values())
