"""Structured metric logging: in-memory ring + JSONL sink + console —
a copy of ``repro/train/metrics.py`` (jax-free).

No external deps (no tensorboard/wandb offline) — JSONL is greppable
and loads straight into numpy/pandas.
"""
from __future__ import annotations

import json
import time
from collections import deque
from pathlib import Path
from typing import Any, Optional


class MetricLogger:
    """Usable bare or as a context manager (closes the JSONL handle);
    ``window`` sizes the smoothing ring. This is also the JSONL sink
    behind :class:`repro_torch.obs.sink.Observability` — every record
    kind (train / theory / comm / serve) shares one stream."""

    def __init__(self, out_path: Optional[str] = None,
                 console_every: int = 1, window: int = 100):
        self.out = Path(out_path) if out_path else None
        if self.out:
            self.out.parent.mkdir(parents=True, exist_ok=True)
            self._fh = self.out.open("a")
        else:
            self._fh = None
        self.console_every = console_every
        self.window = int(window)
        self._recent: dict[str, deque] = {}
        self._t0 = time.time()
        self._n = 0

    def log(self, step: int, **metrics: Any) -> None:
        rec = {"step": int(step), "wall_s": round(time.time() - self._t0, 2)}
        for k, v in metrics.items():
            v = float(v) if hasattr(v, "__float__") else v
            rec[k] = v
            if isinstance(v, float):
                self._recent.setdefault(
                    k, deque(maxlen=self.window)).append(v)
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        self._n += 1
        if self.console_every and self._n % self.console_every == 0:
            kv = " ".join(f"{k}={v:.4f}" if isinstance(v, float)
                          else f"{k}={v}" for k, v in rec.items()
                          if k not in ("wall_s",))
            print(f"[{rec['wall_s']:8.1f}s] {kv}", flush=True)

    def smoothed(self, key: str) -> float:
        vals = self._recent.get(key)
        return sum(vals) / len(vals) if vals else float("nan")

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "MetricLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
