"""Span-based tracer with zero-dep Chrome-trace export — the port of
``repro/obs/trace.py``.

The span hierarchy mirrors the paper's two timescales:

  training:  run > round > {interval, consensus_event, aggregation}
  serving:   run > {prefill, decode_step, admission}

Spans are recorded host-side (``time.perf_counter``-clocked, ts/dur in
microseconds) into a flat event list and exported as Chrome trace JSON
— open ``trace.json`` in ``chrome://tracing`` or https://ui.perfetto.dev.
A span times the host's dispatch, not the device's work: CUDA calls
return before the card finishes, and no span synchronises.

``annotate=True`` (profiling on) also enters a
``torch.profiler.record_function`` per span, so that the host spans
line up with the CUDA timeline of a ``torch.profiler`` trace.
"""
from __future__ import annotations

import json
import threading
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Any, Optional

import torch

# Chrome trace event phases used here: X = complete span, i = instant,
# C = counter, M = metadata (process/thread names)
_PID = 1


class Tracer:
    """Collects spans/instants/counters; exports Chrome trace JSON.

    ``annotate=True`` additionally wraps every span in a
    ``torch.profiler.record_function`` so host spans appear on the
    profile when a ``torch.profiler.profile`` is active.
    """

    def __init__(self, annotate: bool = False):
        self._events: list[dict] = []
        self._t0 = time.perf_counter()
        self._lock = threading.Lock()
        self._tids: dict[int, int] = {}
        self._annotate = annotate
        self._depth: dict[int, int] = {}   # per-thread open-span depth

    # ------------------------------------------------------------------
    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def _tid(self) -> int:
        ident = threading.get_ident()
        with self._lock:
            if ident not in self._tids:
                self._tids[ident] = len(self._tids)
            return self._tids[ident]

    @staticmethod
    def _clean(args: dict) -> dict:
        """JSON-ready span arguments: arrays and tensors to lists (a 0-d
        tensor to a number), other numbers to float. Reading a CUDA
        tensor here copies it to the host and so waits for the card."""
        out = {}
        for k, v in args.items():
            if hasattr(v, "tolist"):
                v = v.tolist()
            elif hasattr(v, "__float__") and not isinstance(v, (int, bool)):
                v = float(v)
            out[k] = v
        return out

    # ------------------------------------------------------------------
    @contextmanager
    def span(self, name: str, cat: str = "span", **args: Any):
        """One complete ('X') event; nests by call structure."""
        tid = self._tid()
        self._depth[tid] = self._depth.get(tid, 0) + 1
        ts = self._now_us()
        ann = None
        if self._annotate:
            ann = torch.profiler.record_function(name)
            ann.__enter__()
        try:
            yield self
        finally:
            if ann is not None:
                ann.__exit__(None, None, None)
            dur = self._now_us() - ts
            self._depth[tid] -= 1
            with self._lock:
                self._events.append({
                    "name": name, "cat": cat, "ph": "X", "pid": _PID,
                    "tid": tid, "ts": ts, "dur": dur,
                    "args": self._clean(args)})

    def instant(self, name: str, cat: str = "event", **args: Any) -> None:
        tid = self._tid()   # resolve BEFORE locking (the lock is not
        with self._lock:    # reentrant; _tid takes it too)
            self._events.append({
                "name": name, "cat": cat, "ph": "i", "s": "t",
                "pid": _PID, "tid": tid, "ts": self._now_us(),
                "args": self._clean(args)})

    def counter(self, name: str, **values: float) -> None:
        """One 'C' sample — renders as a stacked counter track."""
        with self._lock:
            self._events.append({
                "name": name, "ph": "C", "pid": _PID,
                "ts": self._now_us(),
                "args": {k: float(v) for k, v in values.items()}})

    # ------------------------------------------------------------------
    def export(self, path: str, process_name: str = "repro") -> str:
        """Write the Chrome trace JSON (idempotent full rewrite)."""
        with self._lock:
            events = list(self._events)
            tids = dict(self._tids)
        meta = [{"name": "process_name", "ph": "M", "pid": _PID,
                 "args": {"name": process_name}}]
        for ident, tid in tids.items():
            meta.append({"name": "thread_name", "ph": "M", "pid": _PID,
                         "tid": tid, "args": {"name": f"host-{tid}"}})
        doc = {"traceEvents": meta + events, "displayTimeUnit": "ms"}
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        tmp = str(p) + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        Path(tmp).replace(p)
        return str(p)

    @property
    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)


def validate_chrome_trace(doc: dict) -> list[str]:
    """Schema check for an exported trace — returns a list of problems
    (empty = valid)."""
    problems = []
    if "traceEvents" not in doc:
        return ["missing traceEvents"]
    for i, ev in enumerate(doc["traceEvents"]):
        for key in ("name", "ph", "pid"):
            if key not in ev:
                problems.append(f"event {i} missing {key!r}")
        if ev.get("ph") == "X":
            if "ts" not in ev or "dur" not in ev:
                problems.append(f"span {i} ({ev.get('name')}) missing "
                                "ts/dur")
            elif ev["dur"] < 0:
                problems.append(f"span {i} negative dur")
    return problems


PROFILE_DIR = "torch_profile"       # under the trace dir
PROFILE_TRACE = "trace.json"        # the profiler's Chrome trace in it


def make_profiler(trace_dir: str) -> "torch.profiler.profile":
    """A ``torch.profiler.profile`` over host activity and, where there
    is a card, CUDA activity; when it stops it writes its Chrome trace
    to ``<trace_dir>/torch_profile/trace.json``. Errors are not caught:
    a profiler that fails to start or to export fails the run."""
    out = Path(trace_dir) / PROFILE_DIR
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)

    def export(prof) -> None:
        out.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(out / PROFILE_TRACE))

    return torch.profiler.profile(activities=acts, on_trace_ready=export)


def profiler_trace(trace_dir: Optional[str]):
    """:func:`make_profiler` as a context, or a no-op context without a
    trace dir."""
    from contextlib import nullcontext
    if not trace_dir:
        return nullcontext()
    return make_profiler(trace_dir)


__all__ = ["PROFILE_DIR", "PROFILE_TRACE", "Tracer", "make_profiler",
           "profiler_trace", "validate_chrome_trace"]
