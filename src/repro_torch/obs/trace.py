"""Span-based tracer with zero-dep Chrome-trace export — the port of
``repro/obs/trace.py``.

The span hierarchy mirrors the paper's two timescales:

  training:  run > round > {interval, consensus_event, aggregation}
  serving:   run > {prefill, decode_step, admission}

Spans are recorded host-side into a flat event list and exported as
Chrome trace JSON — open ``trace.json`` in ``chrome://tracing`` or
https://ui.perfetto.dev. Every stamp is on the clock ``torch.profiler``
stamps its host events with, nanoseconds since the Unix epoch
(``time.time_ns()`` once at construction, ``time.perf_counter_ns()``
after it), so a span lies over the profiler's events and over the card's
idle gaps (``ts`` in microseconds on that clock).

A span times the host's dispatch, not the device's work: CUDA calls
return before the card finishes, and no span synchronises. A *device
span* (:meth:`Tracer.device_span`, category :data:`LAYER`) also records
a CUDA event on the device's current stream where it opens and where it
closes. The events are read only by :meth:`Tracer.spans` (and an export,
which calls it), after the window: they are set on the shared clock by
an anchor event recorded right after a synchronise when the tracer
first meets the device. On the CPU a device span's device interval is
its host interval. Each span record (:meth:`Tracer.spans`) carries its
id and its parent's, the innermost span open on its thread when it
opened.

Host spans of the :data:`LAYER` category mark layer boundaries the
reference has no span for (``netsim.snapshot``, ``gc``: one span a
garbage collection, while :meth:`Tracer.watch_gc` is on); a tool that
compares the port's trace with the reference's leaves that category
out.

``annotate=True`` (profiling on) also enters a
``torch.profiler.record_function`` per span, so that the host spans
line up with the CUDA timeline of a ``torch.profiler`` trace.
"""
from __future__ import annotations

import gc
import itertools
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
LAYER = "layer"         # the category of the spans the reference lacks


class Tracer:
    """Collects spans/instants/counters; exports Chrome trace JSON.

    ``annotate=True`` additionally wraps every span in a
    ``torch.profiler.record_function`` so host spans appear on the
    profile when a ``torch.profiler.profile`` is active.
    """

    def __init__(self, annotate: bool = False):
        self._events: list[dict] = []
        self._spans: list[dict] = []    # one record a finished span
        self._pc0 = time.perf_counter_ns()
        self._ns0 = time.time_ns()
        # reentrant: a garbage collection, and so _on_gc, can start in
        # any bytecode, including one that holds the lock
        self._lock = threading.RLock()
        self._tids: dict[int, int] = {}
        self._open = threading.local()  # .ids: the thread's open spans
        self._ids = itertools.count()
        self._annotate = annotate
        self._anchors: dict[int, tuple] = {}   # CUDA index -> (ns, event)
        self._gc_start: Optional[int] = None
        self._gc_counts = [0, 0, 0]
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            self._anchor(torch.cuda.current_device())

    # ------------------------------------------------------------------
    def now_ns(self) -> int:
        """Now, in nanoseconds since the Unix epoch (the profiler's
        clock), advanced by the monotonic ``perf_counter``."""
        return self._ns0 + time.perf_counter_ns() - self._pc0

    def _tid(self) -> int:
        ident = threading.get_ident()
        with self._lock:
            if ident not in self._tids:
                self._tids[ident] = len(self._tids)
            return self._tids[ident]

    def _stack(self) -> list:
        ids = getattr(self._open, "ids", None)
        if ids is None:
            ids = self._open.ids = []
        return ids

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

    # -- the device clock ------------------------------------------------
    def _anchor(self, index: int) -> None:
        """An event on an idle card, stamped with the middle of the
        host's narrowest bracket of it: from just before its record to
        just after the host saw it done."""
        torch.cuda.synchronize(index)
        stream = torch.cuda.current_stream(index)
        best = None
        for _ in range(5):
            ev = torch.cuda.Event(enable_timing=True)
            before = self.now_ns()
            ev.record(stream)
            ev.synchronize()
            after = self.now_ns()
            if best is None or after - before < best[0]:
                best = (after - before, (before + after) // 2, ev)
        self._anchors[index] = best[1:]

    def _cuda_event(self, device) -> Optional[tuple]:
        """(index, event) recorded on ``device``'s current stream; None
        for a device that is not a CUDA device."""
        if getattr(device, "type", None) != "cuda":
            return None
        index = (device.index if device.index is not None
                 else torch.cuda.current_device())
        if index not in self._anchors:
            self._anchor(index)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(index))
        return index, ev

    # ------------------------------------------------------------------
    @contextmanager
    def _record(self, name: str, cat: str, device, args: dict):
        tid = self._tid()
        stack = self._stack()
        sid = next(self._ids)
        parent = stack[-1] if stack else None
        stack.append(sid)
        t0 = self.now_ns()
        ann = None
        if self._annotate:
            ann = torch.profiler.record_function(name)
            ann.__enter__()
        ev0 = self._cuda_event(device) if device is not None else None
        try:
            yield self
        finally:
            ev1 = self._cuda_event(device) if ev0 is not None else None
            if ann is not None:
                ann.__exit__(None, None, None)
            t1 = self.now_ns()
            stack.pop()
            rec = {"name": name, "cat": cat, "tid": tid, "id": sid,
                   "parent": parent, "start_ns": t0, "end_ns": t1,
                   "args": self._clean(args)}
            if device is not None:
                rec["device"] = str(device)
                if ev0 is not None:
                    rec["_events"] = (ev0[0], ev0[1], ev1[1])
                else:                           # the CPU: the host span
                    rec["dev_start_ns"], rec["dev_end_ns"] = t0, t1
            self._add(rec)

    def _add(self, rec: dict) -> None:
        with self._lock:
            self._spans.append(rec)
            self._events.append({
                "name": rec["name"], "cat": rec["cat"], "ph": "X",
                "pid": _PID, "tid": rec["tid"], "ts": rec["start_ns"] / 1e3,
                "dur": (rec["end_ns"] - rec["start_ns"]) / 1e3,
                "args": rec["args"]})

    def span(self, name: str, cat: str = "span", **args: Any):
        """One complete ('X') event; nests by call structure."""
        return self._record(name, cat, None, args)

    def device_span(self, name: str, device, **args: Any):
        """A :data:`LAYER` span that also times ``device``'s work between
        its ends (CUDA events on the current stream, read by
        :meth:`spans`). ``args``: host scalars only."""
        return self._record(name, LAYER, device, args)

    def instant(self, name: str, cat: str = "event", **args: Any) -> None:
        tid = self._tid()
        with self._lock:
            self._events.append({
                "name": name, "cat": cat, "ph": "i", "s": "t",
                "pid": _PID, "tid": tid, "ts": self.now_ns() / 1e3,
                "args": self._clean(args)})

    def counter(self, name: str, cat: Optional[str] = None,
                **values: float) -> None:
        """One 'C' sample — renders as a stacked counter track."""
        ev = {"name": name, "ph": "C", "pid": _PID,
              "ts": self.now_ns() / 1e3,
              "args": {k: float(v) for k, v in values.items()}}
        if cat is not None:
            ev["cat"] = cat
        with self._lock:
            self._events.append(ev)

    # -- garbage collections ---------------------------------------------
    def watch_gc(self, on: bool) -> None:
        """While on, every garbage collection is a host span ``gc``
        (args: its generation and the objects it collected) under the
        span open on its thread, and the ``gc`` counter counts the
        collections by generation."""
        if on and self._on_gc not in gc.callbacks:
            gc.callbacks.append(self._on_gc)
        elif not on and self._on_gc in gc.callbacks:
            gc.callbacks.remove(self._on_gc)

    def _on_gc(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._gc_start = self.now_ns()
            return
        t0, self._gc_start = self._gc_start, None
        if t0 is None:
            return
        stack = self._stack()
        gen = info["generation"]
        self._add({"name": "gc", "cat": LAYER, "tid": self._tid(),
                   "id": next(self._ids),
                   "parent": stack[-1] if stack else None,
                   "start_ns": t0, "end_ns": self.now_ns(),
                   "args": {"generation": gen,
                            "collected": info["collected"]}})
        self._gc_counts[gen] += 1
        self.counter("gc", cat=LAYER, **{f"gen{g}": n for g, n in
                                         enumerate(self._gc_counts)})

    # ------------------------------------------------------------------
    def spans(self) -> list[dict]:
        """Every finished span, in the order they closed: ``name``,
        ``cat``, ``tid``, ``id``, ``parent`` (None at the top),
        ``start_ns``/``end_ns`` on the host, ``args`` and, for a device
        span, ``device`` and ``dev_start_ns``/``dev_end_ns``, all on the
        shared clock. Reads
        the device spans' CUDA events, waiting for the card to reach
        them: call it after the window, never in it."""
        with self._lock:
            recs = list(self._spans)
        for rec in recs:
            pending = rec.pop("_events", None)
            if pending is None:
                continue
            index, ev0, ev1 = pending
            ev1.synchronize()
            host, anchor = self._anchors[index]
            rec["dev_start_ns"] = host + round(
                anchor.elapsed_time(ev0) * 1e6)
            rec["dev_end_ns"] = rec["dev_start_ns"] + round(
                ev0.elapsed_time(ev1) * 1e6)
        return [dict(r) for r in recs]

    def export(self, path: str, process_name: str = "repro") -> str:
        """Write the Chrome trace JSON (idempotent full rewrite). The
        device intervals of CUDA device spans go on a thread of their
        own, ``device``."""
        spans = self.spans()
        with self._lock:
            events = list(self._events)
            tids = dict(self._tids)
        meta = [{"name": "process_name", "ph": "M", "pid": _PID,
                 "args": {"name": process_name}}]
        for ident, tid in tids.items():
            meta.append({"name": "thread_name", "ph": "M", "pid": _PID,
                         "tid": tid, "args": {"name": f"host-{tid}"}})
        dev_tid = len(tids)
        on_card = [{"name": r["name"], "cat": LAYER, "ph": "X",
                    "pid": _PID, "tid": dev_tid,
                    "ts": r["dev_start_ns"] / 1e3,
                    "dur": (r["dev_end_ns"] - r["dev_start_ns"]) / 1e3,
                    "args": r["args"]}
                   for r in spans if r.get("device", "").startswith("cuda")]
        if on_card:
            meta.append({"name": "thread_name", "ph": "M", "pid": _PID,
                         "tid": dev_tid, "args": {"name": "device"}})
        doc = {"traceEvents": meta + events + on_card,
               "displayTimeUnit": "ms"}
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


__all__ = ["LAYER", "PROFILE_DIR", "PROFILE_TRACE", "Tracer", "make_profiler",
           "profiler_trace", "validate_chrome_trace"]
