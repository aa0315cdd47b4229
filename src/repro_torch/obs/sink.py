"""The disabled observability sink — the port of ``NULL_OBS`` from
``repro/obs/sink.py``.

Instrumented call sites hold ``NULL_OBS``; every method is a no-op. The
recording sink (tracer, metrics stream, manifest) is still to port
(ROADMAP.md, Queue 1 item 5).
"""
from __future__ import annotations

from contextlib import nullcontext
from typing import Any


class _NullObs:
    """The disabled sink — safe to call everywhere, records nothing."""
    enabled = False
    tracer = None
    metrics = None

    def span(self, name: str, **args: Any):
        return nullcontext(self)

    def instant(self, name: str, **args: Any) -> None:
        pass

    def counter(self, name: str, **values: Any) -> None:
        pass

    def emit(self, kind: str, step: int, **fields: Any) -> None:
        pass

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


NULL_OBS = _NullObs()

__all__ = ["NULL_OBS"]
