"""The observability sink: tracer + one JSONL metrics stream + manifest
— the port of ``repro/obs/sink.py``.

One :class:`Observability` object per run directory. It owns

* a :class:`~repro_torch.obs.trace.Tracer` exported to ``trace.json``
  (Chrome trace / Perfetto),
* ONE ``metrics.jsonl`` stream (a :class:`~repro_torch.train.metrics.
  MetricLogger`) that every record kind shares — train rows, theory
  gauges, comms attribution, serving latency — so bound-vs-actual for
  a round is a single grep,
* a ``manifest.json`` (config hash, git SHA, devices, backend) written
  at construction,
* with ``profile``, a ``torch.profiler`` trace of host and CUDA
  activity in ``torch_profile/trace.json``, written at :meth:`close`,
  so that the card's timeline lines up with the host spans.

Instrumented call sites hold ``NULL_OBS`` by default — every method is
a no-op costing one attribute lookup — and are handed a real sink via
``make_obs(trace_dir, ...)``. Unlike the reference, which swallows
``jax.profiler`` errors, a profiler that fails to start or to export
fails the run.

``Observability()``, with no config, is the *spans-only* sink: spans
and counters held in memory (:meth:`Observability.spans`), no file, no
probe, no synchronise on the path (``telemetry`` False: the trainers'
probes, gauges and records, which read the card, stay off). It is handed
to a run as it is (``TTHFTrainer.run(obs=)``, ``ScaleTrainer.run(obs=)``)
and closed after it. Every live sink records a ``gc`` span a garbage
collection until it is closed.
"""
from __future__ import annotations

from contextlib import contextmanager, nullcontext
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Optional

from repro_torch.obs.manifest import write_manifest
from repro_torch.obs.trace import Tracer, make_profiler

# NOTE: repro_torch.train.metrics is imported lazily inside
# Observability.__init__ — a top-level import would cycle
# (train/__init__ -> trainer -> obs.sink -> train.metrics ->
# train/__init__) whenever the import starts from repro_torch.train.


@dataclass
class ObsConfig:
    trace_dir: Optional[str] = None     # None = observability off
    profile: bool = False               # torch.profiler trace
    window: int = 100                   # MetricLogger smoothing window
    console_every: int = 0              # 0 = JSONL only, no console


class _NullObs:
    """The disabled sink — safe to call everywhere, records nothing."""
    enabled = False
    telemetry = False
    tracer = None
    metrics = None

    def span(self, name: str, **args: Any):
        return nullcontext(self)

    def device_span(self, name: str, device, **args: Any):
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


def _jsonable(v: Any) -> Any:
    if hasattr(v, "tolist"):
        return v.tolist()
    if hasattr(v, "__float__") and not isinstance(v, (int, bool, float)):
        return float(v)
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    return v


class Observability:
    """A live sink: with ``cfg`` (a trace dir), the run directory's
    trace, stream, manifest and profile; without, spans and counters in
    memory alone (the spans-only sink)."""
    enabled = True

    def __init__(self, cfg: Optional[ObsConfig] = None,
                 run_name: str = "run", config: Any = None,
                 extra: Optional[dict] = None):
        if cfg is not None and not cfg.trace_dir:
            raise ValueError("Observability needs a trace_dir; use "
                             "Observability() for the spans-only sink, "
                             "NULL_OBS / make_obs(None) for the disabled "
                             "sink")
        self.cfg = cfg
        self.telemetry = cfg is not None
        self.tracer = Tracer(annotate=cfg is not None and cfg.profile)
        self._closed = False
        self.dir = self.metrics = self._profiler = None
        if cfg is not None:
            self._open_dir(cfg, run_name, config, extra)
        self.tracer.watch_gc(True)

    def _open_dir(self, cfg: ObsConfig, run_name: str, config: Any,
                  extra: Optional[dict]) -> None:
        """The run directory: its stream, manifest and profiler."""
        self.dir = Path(cfg.trace_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        from repro_torch.train.metrics import MetricLogger
        self.metrics = MetricLogger(str(self.dir / "metrics.jsonl"),
                                    console_every=cfg.console_every,
                                    window=cfg.window)
        self.manifest_path = write_manifest(
            str(self.dir), config=config,
            extra={"run": run_name, **(extra or {})})
        if cfg.profile:
            try:
                self._profiler = make_profiler(str(self.dir))
                self._profiler.start()
            except BaseException:
                self.metrics.close()
                raise

    # -- tracer passthrough -------------------------------------------------
    @contextmanager
    def span(self, name: str, **args: Any):
        with self.tracer.span(name, **args):
            yield self

    @contextmanager
    def device_span(self, name: str, device, **args: Any):
        with self.tracer.device_span(name, device, **args):
            yield self

    def spans(self) -> list[dict]:
        """The resolved span records (:meth:`Tracer.spans`): read after
        the window, it waits for the card."""
        return self.tracer.spans()

    def instant(self, name: str, **args: Any) -> None:
        self.tracer.instant(name, **args)

    def counter(self, name: str, **values: Any) -> None:
        self.tracer.counter(name, **values)

    # -- telemetry ----------------------------------------------------------
    def emit(self, kind: str, step: int, **fields: Any) -> None:
        """One JSONL record tagged ``kind`` into the shared stream (none
        on the spans-only sink)."""
        if self.metrics is None:
            return
        self.metrics.log(step, kind=kind,
                         **{k: _jsonable(v) for k, v in fields.items()})

    # -- lifecycle ----------------------------------------------------------
    def flush(self) -> None:
        """Export the Chrome trace collected so far (full rewrite); the
        spans-only sink writes nothing."""
        if self.dir is not None:
            self.tracer.export(str(self.dir / "trace.json"))

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self.tracer.watch_gc(False)
        if self.dir is None:
            return
        try:
            self.flush()
            if self._profiler is not None:
                prof, self._profiler = self._profiler, None
                prof.stop()         # exports torch_profile/trace.json
        finally:
            self.metrics.close()

    def __enter__(self) -> "Observability":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def make_obs(trace_dir: Optional[str], profile: bool = False,
             run_name: str = "run", config: Any = None,
             extra: Optional[dict] = None, window: int = 100,
             console_every: int = 0):
    """The one constructor call sites use: ``None`` → ``NULL_OBS``."""
    if not trace_dir:
        return NULL_OBS
    return Observability(
        ObsConfig(trace_dir=trace_dir, profile=profile, window=window,
                  console_every=console_every),
        run_name=run_name, config=config, extra=extra)


__all__ = ["NULL_OBS", "ObsConfig", "Observability", "make_obs"]
