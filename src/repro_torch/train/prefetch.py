"""Double-buffered host pipeline for interval batches — the port of
``repro/train/prefetch.py``.

The synchronous trainer loop serializes three phases per interval:
build the (tau, R, b, T) batch on the host, copy it to the device, then
run the interval step. :class:`PrefetchLoader` runs the build and copy
in a daemon thread and keeps up to ``depth`` ready batches in a bounded
queue — interval k+1's batch materializes while interval k computes.

Determinism contract (as the reference's): the worker calls the SAME
build function the synchronous path uses, strictly in order, from one
thread, so a prefetched run consumes identical batches in the identical
order; the stream ends (``StopIteration``) when ``build`` raises it, and
an error in the worker is raised by the next :meth:`get`. Draw
accounting stays with the consumer (``ScaleTrainer.run``).
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Optional

_SENTINEL = object()


class PrefetchLoader:
    """Pulls batches from ``build`` in a background thread.

    build:  zero-arg callable returning the next batch (or raising
            ``StopIteration`` to end the stream).
    depth:  max batches in flight (1 = classic double buffering).
    put:    optional placement callable applied to each built batch IN
            THE WORKER (e.g. a copy to the trainer's device), so the
            copy also overlaps compute; the default keeps the batch as
            built.

    Use as a context manager or call :meth:`close`; the worker is a
    daemon thread either way.
    """

    def __init__(self, build: Callable[[], object], depth: int = 1,
                 put: Optional[Callable[[object], object]] = None):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self._build = build
        self._put = put if put is not None else (lambda batch: batch)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._worker, name="interval-prefetch", daemon=True)
        self._thread.start()

    def _worker(self):
        try:
            while not self._stop.is_set():
                try:
                    batch = self._put(self._build())
                except StopIteration:
                    break
                # bounded put that stays responsive to close()
                while not self._stop.is_set():
                    try:
                        self._q.put(batch, timeout=0.05)
                        break
                    except queue.Full:
                        continue
                else:
                    return
        except BaseException as e:        # raised by the next get()
            self._err = e
        finally:
            while True:                   # wake any blocked consumer
                try:
                    self._q.put_nowait(_SENTINEL)
                    break
                except queue.Full:
                    try:
                        self._q.get_nowait()
                    except queue.Empty:
                        pass

    def get(self):
        """Next batch, in build order. Raises the worker's exception if
        it died, ``StopIteration`` when the stream ended."""
        item = self._q.get()
        if item is _SENTINEL:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self):
        """Stop the worker and drop any prefetched batches."""
        self._stop.set()
        self._thread.join(timeout=5.0)
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


__all__ = ["PrefetchLoader"]
