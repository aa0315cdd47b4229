"""Reductions of a traced window's program spans against the card's idle
stretches, for the per-layer metrics of the layer spans.

A span record is what ``repro_torch.obs.Observability.spans()`` returns:
``name``, ``start_ns``/``end_ns`` on the host and, for a device span,
``dev_start_ns``/``dev_end_ns``, all in nanoseconds on the clock
``torch.profiler`` stamps its events with. A window is ``(lo, hi)`` on
that clock; idle stretches are the parts of it in which the card ran no
kernel and no copy. A traced run's drivers hand the spans to the
per-layer readers as ``facts["spans"]``, and ``harness.trace`` the
window as ``Trace.lo``, ``Trace.hi`` and ``Trace.idle``.
"""
from __future__ import annotations

import statistics


def union(intervals) -> list:
    """The sorted, merged union of ``(a, b)`` intervals."""
    out: list = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        elif b > a:
            out.append([a, b])
    return [tuple(iv) for iv in out]


def overlap(xs, ys) -> int:
    """The length of the intersection of two merged interval lists."""
    total, i, j = 0, 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(0, b - a)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_stretches(busy, lo: int, hi: int) -> list:
    """The stretches of ``(lo, hi)`` that no busy interval covers."""
    out, at = [], lo
    for a, b in union((max(a, lo), min(b, hi)) for a, b in busy
                      if b > lo and a < hi):
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if hi > at:
        out.append((at, hi))
    return out


def named(spans, name: str, lo: int, hi: int) -> list:
    """The spans called ``name`` that lie in the window on the host."""
    return [s for s in spans if s["name"] == name
            and s["start_ns"] >= lo and s["end_ns"] <= hi]


def median_device_ms(spans, name: str, lo: int, hi: int) -> float | None:
    """The median device duration, in ms, of the window's ``name``
    spans; None if the window has none."""
    d = [(s["dev_end_ns"] - s["dev_start_ns"]) * 1e-6
         for s in named(spans, name, lo, hi) if "dev_start_ns" in s]
    return statistics.median(d) if d else None


def idle_share_in(spans, name: str, idle, lo: int, hi: int) -> float | None:
    """The share of the window, in %, in which the card is idle and the
    host is inside a ``name`` span; None for an empty window."""
    if hi <= lo:
        return None
    inside = union((max(s["start_ns"], lo), min(s["end_ns"], hi))
                   for s in spans if s["name"] == name
                   and s["end_ns"] > lo and s["start_ns"] < hi)
    return 100.0 * overlap(union(idle), inside) / (hi - lo)


def innermost(spans, t: int) -> dict | None:
    """The shortest span whose host interval holds the instant ``t``."""
    best = None
    for s in spans:
        if s["start_ns"] <= t <= s["end_ns"] and (
                best is None or s["end_ns"] - s["start_ns"]
                < best["end_ns"] - best["start_ns"]):
            best = s
    return best
