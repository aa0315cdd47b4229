"""The port's layer spans (``repro_torch.obs``) on the CPU: the shared
clock with ``torch.profiler``, the spans-only sink on both trainers
(bitwise the bare run, no file, no probe; the span counts and nesting),
the ``gc`` spans, and the reductions the layer metrics read
(``perfbench/spans.py``) on synthetic spans and idle stretches."""
import _torch_threads  # noqa: F401  (torch threads per xdist worker)
import collections
import gc
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench import spans as red  # noqa: E402

from repro_torch.configs import (  # noqa: E402
    DynamicsConfig, TopologyConfig, TTHFConfig, get_arch)
from repro_torch.core import TTHFTrainer  # noqa: E402
from repro_torch.core.distributed import TTHFScaleConfig  # noqa: E402
from repro_torch.data.synth import FederatedDataset  # noqa: E402
from repro_torch.models import make_sim_model  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402
from repro_torch.obs.sink import NULL_OBS, Observability  # noqa: E402
from repro_torch.obs.trace import LAYER, Tracer  # noqa: E402
from repro_torch.train import ScaleTrainer, TrainerConfig  # noqa: E402


def _by_name(spans) -> collections.Counter:
    return collections.Counter(s["name"] for s in spans)


def _ancestors(spans, s) -> list:
    byid = {x["id"]: x for x in spans}
    out = []
    while s["parent"] is not None:
        s = byid[s["parent"]]
        out.append(s["name"])
    return out


# ===========================================================================
# the clock, the records, gc
# ===========================================================================

def test_span_encloses_the_profilers_aten_op_on_the_shared_clock():
    tr = Tracer()
    a = torch.randn(192, 192)
    before = time.time_ns()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tr.span("outer"):
            with tr.device_span("mm", torch.device("cpu"), k=1):
                a @ a
    after = time.time_ns()
    mm = [e for e in prof.profiler.kineto_results.events()
          if e.name() == "aten::mm"]
    assert len(mm) == 1
    spans = {s["name"]: s for s in tr.spans()}
    s = spans["mm"]
    assert before <= s["start_ns"] <= mm[0].start_ns()
    assert mm[0].start_ns() + mm[0].duration_ns() <= s["end_ns"] <= after
    # on the CPU a device span is its host span
    assert (s["dev_start_ns"], s["dev_end_ns"]) == (s["start_ns"],
                                                    s["end_ns"])
    assert s["parent"] == spans["outer"]["id"] and s["cat"] == LAYER
    assert s["args"] == {"k": 1} and s["device"] == "cpu"
    assert "dev_start_ns" not in spans["outer"]
    # the Chrome export's ts is the same clock, in microseconds
    ev = [e for e in tr.events if e["name"] == "mm"][0]
    assert ev["ts"] == s["start_ns"] / 1e3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (runs on the card)")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
def test_device_span_holds_its_kernels_on_the_card(cuda_device):
    """The launches issued in a device span lie in its host interval and
    their kernels start in its device interval, on the profiler's
    clock."""
    a = torch.randn(2048, 2048, device=cuda_device)
    b = torch.empty_like(a)
    torch.mm(a, a, out=b)
    torch.cuda.synchronize()
    obs = Observability()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with obs.device_span("mm", cuda_device):
            a.mul_(1.0)
            torch.mm(a, a, out=b)
        torch.cuda.synchronize()
    obs.close()
    (s,) = [x for x in obs.spans() if x["name"] == "mm"]
    assert s["device"].startswith("cuda")
    CUDA = torch._C._autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    launches = [e for e in events if "LaunchKernel" in e.name()]
    kernels = [e for e in events if e.device_type() == CUDA]
    assert len(launches) >= 2 and len(kernels) >= 2
    for e in launches:
        assert s["start_ns"] <= e.start_ns()
        assert e.start_ns() + e.duration_ns() <= s["end_ns"]
    for e in kernels:
        assert s["dev_start_ns"] <= e.start_ns() <= s["dev_end_ns"]
    busy = sum(e.duration_ns() for e in kernels)
    assert busy <= s["dev_end_ns"] - s["dev_start_ns"]


def test_gc_spans_only_while_a_live_sink_is_open():
    with Observability() as obs:
        with obs.span("outer"):
            gc.collect()
    after = len(obs.spans())
    gc.collect()
    spans = obs.spans()
    assert len(spans) == after
    (g,) = [s for s in spans if s["name"] == "gc"]
    assert g["cat"] == LAYER and g["args"]["generation"] == 2
    assert _ancestors(spans, g) == ["outer"]
    counts = [e["args"] for e in obs.tracer.events
              if e["ph"] == "C" and e["name"] == "gc"]
    assert counts[-1]["gen2"] >= 1
    assert obs.tracer._on_gc not in gc.callbacks


def test_spans_only_sink_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    obs = Observability()
    assert obs.enabled and not obs.telemetry and obs.dir is None
    with obs.span("run"):
        obs.counter("ledger", uplinks=1)
        obs.emit("round", 1, a=1)           # no stream: dropped
    obs.flush()
    obs.close()
    assert list(tmp_path.iterdir()) == []
    assert [s["name"] for s in obs.spans()] == ["run"]
    assert not NULL_OBS.telemetry


# ===========================================================================
# the sim trainer
# ===========================================================================

_STEPS, _TAU, _CE, _EVAL = 8, 4, 2, 4


def _sim(dynamics, model="svm", use_kernel=True):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, 40, 784)).astype(np.float32)
    y = rng.integers(0, 10, size=(8, 40))
    data = FederatedDataset(x, y, np.full(8, 40, np.int32), 10)
    tr = TTHFTrainer(
        make_sim_model(model, 784, 10, 16), data,
        TopologyConfig(num_devices=8, num_clusters=2, graph="geometric",
                       seed=0),
        TTHFConfig(tau=_TAU, consensus_every=_CE, gamma_d2d=2,
                   constant_lr=0.01),
        batch_size=8, use_kernel=use_kernel, dynamics=dynamics,
        device="cpu")
    return tr, tr.init(0)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("scenario", ["static", "device_churn"])
def test_local_step_spans_say_whether_the_step_was_fused(scenario,
                                                         use_kernel):
    """``nn`` under ``use_kernel=True`` takes its fused step and every
    ``local_step`` span says so (``fused=True``); without the kernels
    every one says ``fused=False``."""
    dyn = None if scenario == "static" else DynamicsConfig(
        name="device_churn", p_device_drop=0.2, p_device_return=0.3,
        seed=1)
    tr, st = _sim(dyn, "nn", use_kernel)
    with Observability() as obs:
        tr.run(_STEPS, eval_every=_EVAL, state=st, obs=obs)
    steps = [s for s in obs.spans() if s["name"] == "local_step"]
    assert len(steps) == _STEPS
    assert {s["args"]["fused"] for s in steps} == {use_kernel}


@pytest.mark.parametrize("scenario", ["static", "device_churn"])
def test_spans_only_sink_on_the_sim_trainer(scenario, tmp_path,
                                            monkeypatch):
    dyn = None if scenario == "static" else DynamicsConfig(
        name="device_churn", p_device_drop=0.2, p_device_return=0.3,
        seed=1)
    bare, st0 = _sim(dyn)
    bare_st, bare_hist = bare.run(_STEPS, eval_every=_EVAL, state=st0)
    monkeypatch.chdir(tmp_path)
    tr, st1 = _sim(dyn)
    with Observability() as obs:
        st, hist = tr.run(_STEPS, eval_every=_EVAL, state=st1, obs=obs)
    for a, b in zip(tree_leaves(bare_st.params), tree_leaves(st.params)):
        assert torch.equal(a, b)
    assert hist.global_loss == bare_hist.global_loss
    assert tr._obs_probe is None and tr._obs_gauges is None
    assert list(tmp_path.iterdir()) == []

    spans = [s for s in obs.spans() if s["name"] != "gc"]
    n = _by_name(s for s in spans if s["cat"] == LAYER)
    assert n["local_step"] == _STEPS
    assert n["consensus_event"] == _STEPS // _CE
    assert n["aggregation"] == _STEPS // _TAU
    assert n["eval"] == _STEPS // _EVAL
    # every iteration's snapshot built once (the resolver's are hits)
    assert n["netsim.snapshot"] == (0 if dyn is None else _STEPS)
    for s in spans:
        if s["name"] == "local_step":
            assert _ancestors(spans, s)[:1] == ["interval"]
        if s["name"] == "netsim.snapshot":
            assert _ancestors(spans, s)[0] == "interval"
        if s["name"] == "netsim.snapshot":
            assert "device" not in s            # a host span
        elif s["cat"] == LAYER:
            assert s["dev_start_ns"] == s["start_ns"]
    assert sorted(s["args"]["t"] for s in spans
                  if s["name"] == "local_step") == list(range(1, _STEPS + 1))
    # the svm has no fused step: every local step ran autograd
    assert {s["args"]["fused"] for s in spans
            if s["name"] == "local_step"} == {False}
    # the layer copies of consensus_event / aggregation sit inside the
    # reference's spans of the same name
    for name in ("consensus_event", "aggregation"):
        for s in spans:
            if s["name"] == name and s["cat"] == LAYER:
                assert _ancestors(spans, s)[0] == name
    if dyn is not None:
        (last,) = [e["args"] for e in obs.tracer.events
                   if e["name"] == "netsim.snapshot" and e["ph"] == "C"][-1:]
        assert last["builds"] == _STEPS and last["hits"] >= _STEPS // _CE


# ===========================================================================
# the scale trainer
# ===========================================================================

_SCALE = dict(replicas=4, cluster_size=2, tau=2, consensus_every=1,
              gamma_d2d=1, lr=0.05)
_INTERVALS = 2


def _scale(fused):
    tr = ScaleTrainer(
        get_arch("qwen1.5-0.5b").reduced(num_layers=1, d_model=32, d_ff=64,
                                         vocab_size=128),
        TTHFScaleConfig(**_SCALE),
        TrainerConfig(batch_per_replica=2, seq_len=8, eval_every=2,
                      eval_batches=1, fused_interval=fused),
        device="cpu")
    tr.init(w0=None)
    return tr


@pytest.mark.parametrize("fused", [False, True], ids=["per_leaf", "fused"])
def test_spans_only_sink_on_the_scale_trainer(fused, tmp_path, monkeypatch):
    torch.manual_seed(0)
    bare = _scale(fused)
    torch.manual_seed(0)
    tr = _scale(fused)
    bare.run(_INTERVALS)
    monkeypatch.chdir(tmp_path)
    with Observability() as obs:
        tr.run(_INTERVALS, obs=obs)
    if fused:
        assert torch.equal(bare.params, tr.params)
    else:
        for a, b in zip(tree_leaves(bare.params), tree_leaves(tr.params)):
            assert torch.equal(a, b)
    for key in ("train_loss", "eval_loss"):
        assert bare.metrics._recent[key] == tr.metrics._recent[key]
    assert tr._obs_probe is None and tr.obs is NULL_OBS
    assert list(tmp_path.iterdir()) == []

    spans = [s for s in obs.spans() if s["name"] != "gc"]
    R, tau = _SCALE["replicas"], _SCALE["tau"]
    n = _by_name(s for s in spans if s["cat"] == LAYER)
    assert n["replica_grads"] == R * tau * _INTERVALS
    assert n["block_end"] == tau // _SCALE["consensus_every"] * _INTERVALS
    assert n["aggregation"] == _INTERVALS
    grads = [s for s in spans if s["name"] == "replica_grads"]
    assert collections.Counter(
        (s["args"]["replica"], s["args"]["microstep"]) for s in grads) == \
        {(r, m): _INTERVALS for r in range(R) for m in range(tau)}
    for s in spans:
        if s["cat"] == LAYER:
            assert _ancestors(spans, s)[:3] == ["interval", "round", "run"]
    # the trainer's own sink is untouched, and a bare run after it
    # records nothing more
    k = len(obs.spans())
    tr.run(1)
    assert len(obs.spans()) == k


# ===========================================================================
# the reductions the layer metrics read
# ===========================================================================

def _s(name, a, b, dev=None):
    s = {"name": name, "start_ns": a, "end_ns": b}
    if dev is not None:
        s["dev_start_ns"], s["dev_end_ns"] = dev
    return s


def test_idle_stretches_and_overlap():
    busy = [(10, 20), (15, 30), (50, 60), (95, 140)]
    assert red.union(busy) == [(10, 30), (50, 60), (95, 140)]
    assert red.idle_stretches(busy, 0, 100) == [(0, 10), (30, 50), (60, 95)]
    assert red.idle_stretches([], 0, 100) == [(0, 100)]
    assert red.idle_stretches([(0, 100)], 0, 100) == []
    assert red.overlap([(0, 10), (30, 50)], [(5, 35), (40, 41)]) == 11


def test_median_device_ms_reads_the_windows_device_time():
    ms = 1_000_000
    spans = [_s("local_step", 0, 1 * ms, (0, 22 * ms)),
             _s("local_step", 2 * ms, 3 * ms, (22 * ms, 46 * ms)),
             _s("local_step", 4 * ms, 5 * ms, (46 * ms, 69 * ms)),
             _s("local_step", 200 * ms, 201 * ms, (0, 90 * ms)),  # outside
             _s("eval", 6 * ms, 7 * ms, (69 * ms, 99 * ms))]
    assert red.median_device_ms(spans, "local_step", 0, 100 * ms) == 23.0
    assert red.median_device_ms(spans, "replica_grads", 0, 100 * ms) is None
    assert red.median_device_ms(spans, "eval", 0, 100 * ms) == 30.0


def test_idle_share_in_counts_idle_time_under_the_span():
    # window 0..1000; the card idles 100..300 and 600..700; the host is
    # inside netsim.snapshot at 150..250 (idle under all of it), 280..320
    # (20 of idle) and 650..900 (50 of idle), and in gc at 620..640
    idle = red.idle_stretches([(0, 100), (300, 600), (700, 1000)], 0, 1000)
    spans = [_s("netsim.snapshot", 150, 250), _s("netsim.snapshot", 280, 320),
             _s("netsim.snapshot", 650, 900), _s("gc", 620, 640),
             _s("gc", 1100, 1200)]
    assert red.idle_share_in(spans, "netsim.snapshot", idle, 0, 1000) == \
        pytest.approx(17.0)
    assert red.idle_share_in(spans, "gc", idle, 0, 1000) == \
        pytest.approx(2.0)
    assert red.idle_share_in(spans, "local_step", idle, 0, 1000) == 0.0
    assert red.idle_share_in(spans, "gc", idle, 5, 5) is None
    # two spans over the same idle time count it once
    spans.append(_s("netsim.snapshot", 160, 240))
    assert red.idle_share_in(spans, "netsim.snapshot", idle, 0, 1000) == \
        pytest.approx(17.0)
    assert red.innermost(spans, 200)["start_ns"] == 160
    assert red.innermost(spans, 1050) is None
