"""Per-rank cost of a program — the port's counterpart of
``repro/launch/hlo_cost.py``.

The reference walks the partitioned HLO of a compiled program. The port
has no HLO: it runs the program once (on fake tensors in the dry run,
on the card's tensors when measured) under :class:`CostMode`, a
``TorchDispatchMode`` that sees every ATen op a rank runs and counts:

  * flops      — the matmul and convolution operations of the *local*
                 ops (``torch.utils.flop_counter``'s formulas: 2 M N K a
                 product); elementwise work is not counted, as the
                 reference counts dots only;
  * bytes      — each local op's tensor inputs plus outputs (views,
                 allocations and waits move nothing): the unfused
                 counterpart of the reference's per-op proxy;
  * collective — result bytes and counts per collective a rank issues
                 (DTensor's functional collectives), under the
                 reference's kind names;
  * memory     — the bytes of the storages the run allocates, live at
                 its peak, beside the arguments' and outputs' bytes (the
                 reference's ``memory_analysis`` fields).

An op on DTensors is counted where it runs: the mode passes it on
(``NotImplemented``) to DTensor's dispatch and sees the local ops that
dispatch issues. DTensor's sharding propagation runs each op once more
on fake tensors of the *global* shapes; those ops are not counted (they
are no rank's work). A kernel wrapper given fake tensors charges its own
formula instead (:func:`repro_torch.kernels.runtime.charge`).
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.kernels import runtime

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# op name fragment (underscores dropped) -> the reference's collective
# kind
_KINDS = (("allgather", "all-gather"), ("reducescatter", "reduce-scatter"),
          ("allreduce", "all-reduce"), ("alltoall", "all-to-all"),
          ("permute", "collective-permute"))
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d_functional", "c10d",
                          "_dtensor")
# ops that move no bytes: allocations, identity waits, metadata
_NO_BYTES = ("empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided", "wait_tensor", "detach", "alias",
             "lift_fresh", "lift_fresh_copy")


@dataclass
class CostRecord:
    """What one rank does in one run of a program."""
    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: dict = field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVES})
    coll_counts: dict = field(
        default_factory=lambda: {k: 0 for k in COLLECTIVES})
    kernels: dict = field(default_factory=dict)  # name -> calls, flops, bytes
    arg_bytes: float = 0.0      # the arguments' local bytes
    out_bytes: float = 0.0      # the outputs' local bytes
    alias_bytes: float = 0.0    # outputs that are arguments updated in place
    temp_bytes: float = 0.0     # allocated during the run, live at its peak,
                                # less the new outputs
    peak_bytes: float = 0.0     # arguments + allocations live at the peak
    ops: int = 0                # local ATen ops run

    @property
    def coll_total(self) -> float:
        return float(sum(self.coll_bytes.values()))

    def add(self, other: "CostRecord") -> "CostRecord":
        """The sum of two runs' counts (memory fields: the larger)."""
        out = CostRecord(
            flops=self.flops + other.flops, bytes=self.bytes + other.bytes,
            ops=self.ops + other.ops)
        for k in set(self.coll_bytes) | set(other.coll_bytes):
            out.coll_bytes[k] = (self.coll_bytes.get(k, 0.0)
                                 + other.coll_bytes.get(k, 0.0))
            out.coll_counts[k] = (self.coll_counts.get(k, 0)
                                  + other.coll_counts.get(k, 0))
        for d in (self.kernels, other.kernels):
            for name, c in d.items():
                acc = out.kernels.setdefault(
                    name, {"calls": 0, "flops": 0, "bytes": 0})
                for key in acc:
                    acc[key] += c[key]
        for f in ("arg_bytes", "out_bytes", "alias_bytes", "temp_bytes",
                  "peak_bytes"):
            setattr(out, f, max(getattr(self, f), getattr(other, f)))
        return out


def _tensors(value) -> list:
    return [x for x in tree_flatten(value)[0] if isinstance(x, torch.Tensor)]


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if _is_dtensor_type(type(t)) else t


def _is_dtensor_type(cls) -> bool:
    from torch.distributed.tensor import DTensor
    return issubclass(cls, DTensor)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _kind(func) -> "str | None":
    """The collective kind of a functional collective op, else None."""
    if func.namespace not in _COLLECTIVE_NAMESPACES:
        return None
    name = func._opname
    if name == "wait_tensor":
        return None
    for frag, kind in _KINDS:
        if frag in name.replace("_", ""):
            return kind
    return name


class _Propagating:
    """Marks DTensor's sharding propagation while it runs: wraps
    ``ShardingPropagator._propagate_tensor_meta_non_cached``, the fake
    run of an op on global shapes (cached or not, every propagation
    goes through it), with a depth count."""

    def __init__(self):
        from torch.distributed.tensor._sharding_prop import (
            ShardingPropagator)
        self.cls, self.depth = ShardingPropagator, 0
        self.orig = ShardingPropagator._propagate_tensor_meta_non_cached

        def marked(prop, *args, **kwargs):
            self.depth += 1
            try:
                return self.orig(prop, *args, **kwargs)
            finally:
                self.depth -= 1

        self.cls._propagate_tensor_meta_non_cached = marked

    def restore(self) -> None:
        self.cls._propagate_tensor_meta_non_cached = self.orig


class CostMode(TorchDispatchMode):
    """Counts a rank's local ops into ``self.record`` (see the module
    note). ``fake_mode``: the dry run's ``FakeTensorMode``, whose fake
    tensors are the rank's own; fake tensors of any other mode are
    DTensor's propagation stand-ins, and not counted."""

    def __init__(self, fake_mode=None):
        super().__init__()
        self.fake_mode = fake_mode
        self.record = CostRecord()
        self._live: dict = {}          # storage key -> bytes
        self._live_bytes = 0
        self._peak = 0

    # -- the propagation marker and the kernels' charges --------------
    def __enter__(self):
        self._prop = _Propagating()
        runtime.LISTENERS.append(self._charge)
        return super().__enter__()

    def __exit__(self, *exc):
        self._prop.restore()
        runtime.LISTENERS.remove(self._charge)
        return super().__exit__(*exc)

    def _charge(self, kernel: str, flops: int, bytes_moved: int) -> None:
        w = runtime.WEIGHT[-1]
        flops, bytes_moved = w * flops, w * bytes_moved
        r = self.record
        r.flops += flops
        r.bytes += bytes_moved
        c = r.kernels.setdefault(kernel, {"calls": 0, "flops": 0,
                                          "bytes": 0})
        c["calls"] += w
        c["flops"] += flops
        c["bytes"] += bytes_moved

    # -- memory ------------------------------------------------------
    def _free(self, key) -> None:
        self._live_bytes -= self._live.pop(key, 0)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        n = st.nbytes()
        self._live[key] = n
        self._live_bytes += n
        self._peak = max(self._peak, self._live_bytes)
        weakref.finalize(st, self._free, key)

    # -- the ops -----------------------------------------------------
    def _foreign(self, args, kwargs) -> bool:
        if self._prop.depth:
            return True
        for x in tree_flatten((args, kwargs))[0]:
            if runtime.is_fake(x) and x.fake_mode is not self.fake_mode:
                return True
        return False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(_is_dtensor_type(t) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        # metadata queries (a fake tensor's .device) and propagation
        if func.namespace == "prim" or self._foreign(args, kwargs):
            return out
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        from torch.utils.flop_counter import flop_registry
        r, w = self.record, runtime.WEIGHT[-1]
        r.ops += w
        outs = _tensors(out)
        kind = _kind(func)
        if kind is not None:
            # a c10d collective that returns only its work handle writes
            # into its first argument
            res = outs or _tensors(args)[:1]
            r.coll_bytes[kind] = r.coll_bytes.get(kind, 0.0) + w * sum(
                _nbytes(t) for t in res)
            r.coll_counts[kind] = r.coll_counts.get(kind, 0) + w
        packet = func._overloadpacket
        if packet in flop_registry:
            r.flops += w * flop_registry[packet](*args, **kwargs,
                                                 out_val=out)
        ins = _tensors((args, kwargs))
        if outs and not func.is_view and func._opname not in _NO_BYTES:
            r.bytes += w * sum(_nbytes(t) for t in ins + outs)
        # new storages only: a view, an in-place op or a wait returns
        # storage its inputs hold
        held = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            if t.untyped_storage()._cdata not in held:
                self._track(t)


def _storages(tensors) -> dict:
    """{storage key: bytes} of the tensors' (local) storages."""
    out: dict = {}
    for t in tensors:
        st = _local(t).untyped_storage()
        out[st._cdata] = st.nbytes()
    return out


def measure(fn, *args, fake_mode=None):
    """Run ``fn(*args)`` under :class:`CostMode`; returns ``(out,
    record)`` with the memory fields filled from the storages of
    ``args`` and ``out`` (their local tensors')."""
    arg_keys = _storages(_tensors(args))
    with CostMode(fake_mode) as mode:
        out = fn(*args)
    rec = mode.record
    seen = _storages(_tensors(out))
    rec.arg_bytes = float(sum(arg_keys.values()))
    rec.out_bytes = float(sum(seen.values()))
    rec.alias_bytes = float(sum(n for k, n in seen.items()
                                if k in arg_keys))
    rec.peak_bytes = rec.arg_bytes + mode._peak
    rec.temp_bytes = max(float(mode._peak) - (rec.out_bytes
                                              - rec.alias_bytes), 0.0)
    return out, rec


__all__ = ["COLLECTIVES", "CostMode", "CostRecord", "measure"]
