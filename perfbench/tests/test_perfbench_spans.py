"""The per-layer readers of the program's spans (``metrics/local_step_ms.
sim``, ``idle_in_snapshot.sim``, ``replica_grads_ms.train``,
``idle_in_gc.train``) on synthetic spans and idle stretches, the
window's ends and idle stretches in ``harness.Trace``, and traced runs
of the tiny cells, which hand the spans to the readers (runs that are
not traced open no sink)."""
import time

import pytest

from perfbench import harness
from perfbench.drivers import scale, sim
from perfbench.drivers.common import Run

from conftest import CPU

READERS = ("local_step_ms.sim", "idle_in_snapshot.sim",
           "replica_grads_ms.train", "idle_in_gc.train")


def reader(name: str):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py",
                               f"perfbench_metric_{name.replace('.', '_')}")


def span(name, a, b, dev=None):
    s = {"name": name, "cat": "layer", "start_ns": a, "end_ns": b}
    if dev is not None:
        s["dev_start_ns"], s["dev_end_ns"] = dev
    return s


# a window of 1 ms from 10 ms on the profiler's clock; the card idle in
# 0.1-0.3 and 0.6-0.7 ms of it
LO, HI = 10_000_000, 11_000_000
IDLE = [(LO + 100_000, LO + 300_000), (LO + 600_000, LO + 700_000)]
TRACE = harness.Trace(window_s=1e-3, busy_s=0.7e-3, by_name={}, lo=LO,
                      hi=HI, idle=IDLE)


def test_device_ms_readers_take_the_median_of_the_window():
    for name, kind, span_name in (
            ("local_step_ms.sim", "sim", "local_step"),
            ("replica_grads_ms.train", "scale", "replica_grads")):
        spans = [span(span_name, LO + 1_000, LO + 2_000,
                      (LO + 5_000, LO + 2_005_000)),           # 2 ms
                 span(span_name, LO + 3_000, LO + 4_000,
                      (LO + 10_000, LO + 4_010_000)),          # 4 ms
                 span(span_name, LO + 5_000, LO + 6_000,
                      (LO + 20_000, LO + 3_020_000)),          # 3 ms
                 # before the window
                 span(span_name, LO - 5_000, LO - 1_000, (0, 10**9)),
                 span("other", LO + 1_000, LO + 2_000, (0, 10**9))]
        r = reader(name)
        assert r.read({"kind": kind, "spans": spans}, TRACE, None) == 3.0
        assert r.read({"kind": kind, "spans": []}, TRACE, None) is None


def test_idle_readers_count_the_idle_time_inside_the_host_span():
    for name, kind, span_name in (
            ("idle_in_snapshot.sim", "sim", "netsim.snapshot"),
            ("idle_in_gc.train", "scale", "gc")):
        r = reader(name)
        # inside 0.2-0.65 ms: 0.1 ms of the first idle stretch and
        # 0.05 ms of the second, 15 % of the window
        spans = [span(span_name, LO + 200_000, LO + 650_000),
                 span("local_step", LO, HI, (LO, HI))]
        got = r.read({"kind": kind, "spans": spans}, TRACE, None)
        assert got == pytest.approx(15.0)
        # overlapping spans count once; a span over the window's end
        # counts its part inside
        spans += [span(span_name, LO + 250_000, LO + 290_000),
                  span(span_name, HI - 1_000, HI + 5_000)]
        assert r.read({"kind": kind, "spans": spans}, TRACE, None) \
            == pytest.approx(15.0)
        # no such span in the window: the card never idled inside one
        assert r.read({"kind": kind, "spans": spans[1:2]}, TRACE,
                      None) == 0.0


@pytest.mark.parametrize("name", READERS)
def test_readers_read_nothing_without_spans(name):
    r = reader(name)
    kind = "sim" if name.endswith(".sim") else "scale"
    other = "scale" if kind == "sim" else "sim"
    spans = [span("local_step", LO, HI, (LO, HI))]
    assert r.read({"kind": "none"}, None, None) is None
    assert r.read({"kind": kind}, TRACE, None) is None
    assert r.read({"kind": kind, "spans": spans}, None, None) is None
    assert r.read({"kind": other, "spans": spans}, TRACE, None) is None


def test_trace_keeps_the_window_on_the_profilers_clock():
    before = time.time_ns()
    _, tr = harness.trace(lambda: sum(range(10_000)), CPU)
    after = time.time_ns()
    assert before <= tr.lo < tr.hi <= after
    # on the CPU no device event: the whole window is idle
    assert tr.idle == [(tr.lo, tr.hi)]


@pytest.mark.parametrize("which,names", [
    ("sim_churn", ("local_step_ms.sim", "idle_in_snapshot.sim")),
    ("train", ("replica_grads_ms.train", "idle_in_gc.train"))])
def test_traced_run_hands_its_spans_to_the_readers(which, names, request):
    cell = request.getfixturevalue(which)
    drv = sim if which.startswith("sim") else scale
    out = drv.run(Run(cell=cell, seed=9, seconds=0.1, trace=True,
                      device=CPU, t_start=time.perf_counter()))
    spans = out.facts["spans"]
    assert spans and all(s["end_ns"] >= s["start_ns"] for s in spans)
    assert out.trace.lo < out.trace.hi
    for name in names:
        v = reader(name).read(out.facts, out.trace, cell)
        assert v is not None and v >= 0.0, (name, v)
    bare = drv.run(Run(cell=cell, seed=9, seconds=0.1, trace=False,
                       device=CPU, t_start=time.perf_counter()))
    assert "spans" not in bare.facts
