"""Logical-axis sharding layer — the port of ``repro/dist/sharding.py``
on ``torch.distributed``'s ``DeviceMesh`` and ``DTensor``.

Model code names *logical* axes ("embed", "ffn", "cache_seq", ...);
this module owns the mapping onto *physical* mesh axes, so that a phase
is re-sharded by editing one rule table instead of model code.

* :class:`ShardingRules` — an ordered ``logical axis -> mesh axes``
  table. ``rules.spec(axes, mesh)`` resolves a per-dimension tuple of
  logical names into a *spec*: a plain tuple with one entry per
  dimension (None, a mesh axis name, or a tuple of names), the
  counterpart of JAX's ``PartitionSpec``. Mesh axes the target mesh
  lacks are dropped (one table serves the 256-chip pod and the 512-chip
  multi-pod mesh), and a mesh axis already claimed by an earlier
  dimension is dropped from later ones.

* :func:`placements` — a spec as ``DTensor`` placements, one per mesh
  dim: ``Shard(d)`` for the tensor dim that claims that mesh dim,
  ``Replicate()`` otherwise (``NamedSharding`` on a JAX mesh).

* :func:`hint` — the ``with_sharding_constraint`` wrapper, taking one
  *physical* spec entry per tensor dimension. Under :func:`use_mesh` it
  redistributes a ``DTensor`` to the resolved placements; with no
  ambient mesh, or on a plain tensor, it returns its input, so model
  code hints unconditionally.

* :func:`drop_hint_axes` — masks the named mesh axes out of every
  ``hint`` issued underneath it (the replica axes of TT-HF scale mode).

A mesh is a ``DeviceMesh`` whose ``mesh_dim_names`` are set, or an
:class:`AbstractMesh`: names and sizes only, for resolving the
production geometries, which no card set here can hold.
"""
from __future__ import annotations

import sys
import threading
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Iterable, Optional, Union

import torch

# one rule value: this logical axis is unsharded (None), sharded over
# one mesh axis ("model"), or sharded over several ( ("pod", "data") ).
MeshAxes = Union[None, str, tuple]


@dataclass(frozen=True)
class AbstractMesh:
    """A mesh of names and sizes only (JAX's ``AbstractMesh``): rules
    resolve against it, nothing can be placed on it."""
    axis_sizes: tuple
    axis_names: tuple

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"{len(self.axis_sizes)} sizes for "
                             f"{len(self.axis_names)} axis names")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.axis_sizes:
            n *= s
        return n


def mesh_axis_names(mesh) -> tuple:
    """The mesh's axis names in mesh-dim order."""
    if isinstance(mesh, AbstractMesh):
        return mesh.axis_names
    return tuple(mesh.mesh_dim_names)


def mesh_axis_sizes(mesh) -> dict:
    """``{axis name: size}`` for a ``DeviceMesh`` or an
    :class:`AbstractMesh`."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def _as_tuple(entry: MeshAxes) -> tuple:
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


def _dim_entry(axes: tuple) -> Union[None, str, tuple]:
    """Canonical spec entry for a resolved mesh-axis tuple."""
    if not axes:
        return None
    if len(axes) == 1:
        return axes[0]
    return tuple(axes)


class ShardingRules:
    """Ordered, immutable ``logical axis -> mesh axes`` rule table."""

    def __init__(self, rules: Iterable[tuple]):
        table = []
        seen = set()
        for name, entry in rules:
            if name in seen:
                raise ValueError(f"duplicate rule for logical axis {name!r}")
            seen.add(name)
            table.append((name, _as_tuple(entry)))
        self._rules = tuple(table)

    # -- introspection ----------------------------------------------------
    @property
    def rules(self) -> tuple:
        return self._rules

    def logical_axes(self) -> tuple:
        return tuple(name for name, _ in self._rules)

    def mesh_axes(self, logical: str) -> tuple:
        for name, entry in self._rules:
            if name == logical:
                return entry
        raise KeyError(
            f"no sharding rule for logical axis {logical!r}; known axes: "
            f"{self.logical_axes()}")

    # -- derivation -------------------------------------------------------
    def with_overrides(self, **overrides: MeshAxes) -> "ShardingRules":
        """New table with the named rules remapped in place (order kept);
        logical axes not previously present are appended."""
        pending = {k: _as_tuple(v) for k, v in overrides.items()}
        out = []
        for name, entry in self._rules:
            out.append((name, pending.pop(name, entry)))
        out.extend(pending.items())
        return ShardingRules(out)

    # -- resolution -------------------------------------------------------
    def spec(self, axes: tuple, mesh) -> tuple:
        """Resolve per-dimension logical names into a spec.

        ``axes``: one entry per tensor dimension — a logical axis name or
        None (dimension unconstrained). Mesh axes absent from ``mesh``
        are dropped; a mesh axis already claimed by an earlier dimension
        is dropped from later ones (leftmost dimension wins).
        """
        present = set(mesh_axis_names(mesh))
        used: set = set()
        dims = []
        for a in axes:
            if a is None:
                dims.append(None)
                continue
            take = tuple(m for m in self.mesh_axes(a)
                         if m in present and m not in used)
            used.update(take)
            dims.append(_dim_entry(take))
        return tuple(dims)

    def spec_for_shape(self, axes: tuple, shape: tuple, mesh) -> tuple:
        """Shape-aware :meth:`spec`: a mesh axis only shards a dimension
        it evenly divides (otherwise it is dropped for that dimension —
        a tensor never fails to place, it degrades toward replication).

        Contested mesh axes go to the dimension whose logical axis
        appears EARLIEST IN THE RULE TABLE (``spec`` gives them to the
        leftmost dimension instead), so a table can express fallbacks:
        list ``cache_kv_heads -> model`` before ``cache_seq -> model``
        and the sequence dimension picks up ``model`` exactly when the
        head count does not divide it (small GQA configs).
        """
        if len(axes) != len(shape):
            raise ValueError(
                f"spec_for_shape got {len(axes)} axis entries for a "
                f"{len(shape)}-d shape {shape}")
        sizes = mesh_axis_sizes(mesh)
        prio = {name: i for i, (name, _) in enumerate(self._rules)}
        order = sorted((i for i, a in enumerate(axes) if a is not None),
                       key=lambda i: (prio.get(axes[i], len(prio)), i))
        used: set = set()
        take: dict = {}
        for i in order:
            got, prod = [], 1
            for m in self.mesh_axes(axes[i]):
                if m not in sizes or m in used:
                    continue
                if shape[i] % (prod * sizes[m]) != 0:
                    continue
                got.append(m)
                used.add(m)
                prod *= sizes[m]
            take[i] = tuple(got)
        return tuple(_dim_entry(take.get(i, ())) for i in range(len(axes)))


# ---------------------------------------------------------------------------
# placements
# ---------------------------------------------------------------------------

def placements(spec: tuple, mesh) -> tuple:
    """``spec`` as DTensor placements on ``mesh``, one per mesh dim:
    ``Shard(d)`` for the tensor dim ``d`` that claims the mesh dim,
    ``Replicate()`` for a mesh dim no tensor dim claims. A dim sharded
    over several mesh axes (``("pod", "data")``) must list them in
    mesh-dim order: DTensor splits a dim over its mesh dims in that
    order, as JAX does over the axes of a ``PartitionSpec`` entry. A
    mesh dim of size 1 replicates."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh_axis_names(mesh)
    sizes = mesh_axis_sizes(mesh)
    owner: dict = {}
    for d, entry in enumerate(spec):
        axes = _as_tuple(entry)
        order = [names.index(m) for m in axes]
        assert order == sorted(order), (
            f"spec entry {entry!r} lists mesh axes out of mesh order "
            f"{names}")
        for m in axes:
            assert m not in owner, f"mesh axis {m!r} shards two dims"
            owner[m] = d
    # a mesh dim of size 1 holds the whole dim either way; Replicate
    # keeps DTensor from refusing views that drop a "sharded" dim of 1
    return tuple(Shard(owner[m]) if m in owner and sizes[m] > 1
                 else Replicate() for m in names)


# ---------------------------------------------------------------------------
# the ambient mesh and activation hints
# ---------------------------------------------------------------------------

_local = threading.local()


def ambient_mesh():
    """The mesh of the innermost :func:`use_mesh`, or None."""
    return getattr(_local, "mesh", None)


@contextmanager
def use_mesh(mesh):
    """Make ``mesh`` (a ``DeviceMesh``) the ambient mesh of this thread:
    the :func:`hint` calls underneath resolve against it (``with mesh:``
    in JAX), and a plain tensor that meets a ``DTensor`` in an op is
    taken as replicated (``implicit_replication``): every rank holds the
    same host-made masks, positions and page maps. ``None`` leaves no
    mesh ambient."""
    prev = ambient_mesh()
    _local.mesh = mesh
    try:
        if mesh is None:
            yield mesh
        else:
            from torch.distributed.tensor.experimental import (
                implicit_replication)
            with implicit_replication():
                yield mesh
    finally:
        _local.mesh = prev


def _dropped_axes() -> frozenset:
    return getattr(_local, "dropped", frozenset())


@contextmanager
def drop_hint_axes(axes: Iterable[str]):
    """Mask ``axes`` out of every :func:`hint` in this context.

    Nestable: inner contexts add to (never replace) the outer drop set.
    """
    prev = _dropped_axes()
    _local.dropped = prev | frozenset(axes)
    try:
        yield
    finally:
        _local.dropped = prev


def hint_scope():
    """This thread's hint state (the ambient mesh and the dropped axes)
    as a context that sets it on whichever thread enters it. A
    rematerialized layer runs again in the backward, which on a CUDA
    device runs on autograd's own thread, where neither is set. Only
    the state is set: the ambient ``implicit_replication`` is a process
    flag, still on while the backward runs."""
    mesh, dropped = ambient_mesh(), _dropped_axes()

    @contextmanager
    def scope():
        prev = ambient_mesh(), _dropped_axes()
        _local.mesh, _local.dropped = mesh, dropped
        try:
            yield
        finally:
            _local.mesh, _local.dropped = prev

    return scope


def resolve_hint_spec(dim_specs: tuple, mesh,
                      shape: Optional[tuple] = None) -> Optional[tuple]:
    """The spec a :func:`hint` would pin on ``mesh`` right now (honoring
    the active :func:`drop_hint_axes` set), or None when every entry
    resolves empty (the hint is a no-op).

    With ``shape``, mesh axes that do not evenly divide their dimension
    are also dropped — a hint written for the production mesh degrades
    to a partial pin (or a no-op) on meshes whose factors don't fit.
    """
    present = set(mesh_axis_names(mesh))
    dropped = _dropped_axes()
    sizes = mesh_axis_sizes(mesh)
    used: set = set()
    dims = []
    for i, entry in enumerate(dim_specs):
        got, prod = [], 1
        for m in _as_tuple(entry):
            if m not in present or m in dropped or m in used:
                continue
            if shape is not None and shape[i] % (prod * sizes[m]) != 0:
                continue
            got.append(m)
            used.add(m)
            prod *= sizes[m]
        dims.append(_dim_entry(tuple(got)))
    return tuple(dims) if used else None


def hint(x: torch.Tensor, *dim_specs: MeshAxes) -> torch.Tensor:
    """Pin ``x``'s placement: one mesh-axes entry per tensor dimension.

    Returns ``x`` when no mesh is ambient or ``x`` is a plain tensor.
    Entries naming mesh axes the ambient mesh lacks, axes masked by
    :func:`drop_hint_axes`, axes already claimed by an earlier
    dimension, or axes whose size does not evenly divide the dimension
    are dropped (never an error), so one call site serves every mesh.
    A ``DTensor`` is redistributed to the resolved placements: mesh
    axes the spec does not name are replicated, as under a
    ``NamedSharding``.
    """
    if len(dim_specs) != x.ndim:
        raise ValueError(
            f"hint got {len(dim_specs)} axis entries for a {x.ndim}-d "
            f"tensor of shape {tuple(x.shape)}")
    mesh = getattr(_local, "mesh", None)
    if mesh is None or not is_dtensor(x):
        return x
    spec = resolve_hint_spec(dim_specs, mesh, tuple(x.shape))
    if spec is None:
        return x
    want = placements(spec, mesh)
    if tuple(x.placements) == want:
        return x
    # rewrapped: a redistribution can leave DTensor's global strides
    # describing another layout than the new shard's
    return from_shard(x.redistribute(x.device_mesh, want).to_local(),
                      x.device_mesh, want)


def is_dtensor(x) -> bool:
    """Is ``x`` a DTensor? No DTensor exists before
    ``torch.distributed.tensor`` is imported, so the unsharded paths,
    which ask this several times a layer, never pay that import."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and type(x) is mod.DTensor


# ---------------------------------------------------------------------------
# local shards: the ops DTensor has no sharding strategy for
# ---------------------------------------------------------------------------

def local(x):
    """``x``'s shard on this rank (``x`` itself when it is not a
    DTensor)."""
    return x.to_local() if is_dtensor(x) else x


def with_dims(place, dims: dict) -> tuple:
    """``place`` with the sharding of tensor dims remapped: ``dims`` maps
    a dim to another dim (the same mesh dims now shard it) or to None
    (those mesh dims replicate). A pending sum (``Partial``) becomes
    ``Replicate``: a region that asks for these placements gets its
    input reduced."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for pl in place:
        if isinstance(pl, Shard):
            d = dims.get(pl.dim, pl.dim)
            out.append(Replicate() if d is None else Shard(d))
        else:
            out.append(Replicate())
    return tuple(out)


def keep_dims(place, dims: tuple) -> tuple:
    """``place`` with the sharding of the tensor dims ``dims`` kept and
    every other mesh dim replicated (``()``: all replicated)."""
    from torch.distributed.tensor import Replicate, Shard
    return tuple(pl if isinstance(pl, Shard) and pl.dim in dims
                 else Replicate() for pl in place)


def _global_meta(x: torch.Tensor, mesh, place) -> tuple:
    """(global shape, global stride) of a DTensor whose local shard is
    ``x`` (even shards): the shape scaled along each sharded dim, and the
    strides of a tensor of that shape laid out in ``x``'s dim order."""
    from torch.distributed.tensor import Shard
    shape = list(x.shape)
    for md, pl in enumerate(place):
        if isinstance(pl, Shard):
            shape[pl.dim] *= mesh.size(md)
    stride = [0] * len(shape)
    step = 1
    for d in sorted(range(len(shape)), key=lambda d: (x.stride(d), -d)):
        stride[d] = step
        step *= shape[d]
    return tuple(shape), tuple(stride)


def from_shard(x: torch.Tensor, mesh, place) -> torch.Tensor:
    """The DTensor whose local shard on this rank is ``x`` (no
    communication). The global shape and strides are given explicitly:
    ``DTensor.from_local`` derives strides that do not follow the local
    layout for some placements (a batch and a head dim both sharded),
    and an op that reads them (``matmul`` folding its batch dims into
    one ``mm``) then takes another path than on a whole tensor."""
    from torch.distributed.tensor import DTensor
    shape, stride = _global_meta(x, mesh, place)
    return DTensor.from_local(x, mesh, list(place), run_check=False,
                              shape=shape, stride=stride)


def on_shards(fn, args: tuple, where):
    """``fn`` over the local shards of ``args`` (``local_map``).
    ``where(mesh)`` gives ``(in_placements, out_placements)``: each
    tensor argument is first redistributed to its entry of
    ``in_placements`` (a plain tensor is taken as replicated: every rank
    holds it whole; an entry None passes its argument as it is), and
    the outputs are DTensors with ``out_placements`` (one placements
    tuple, or a tuple of them for a tuple of outputs). With no DTensor
    among ``args`` this is ``fn(*args)`` and ``where`` is not called:
    the unsharded path runs the same function on whole tensors."""
    mesh = next((a.device_mesh for a in args if is_dtensor(a)), None)
    if mesh is None:
        return fn(*args)
    from torch.distributed.tensor import Placement, Replicate
    in_placements, out_placements = where(mesh)
    shards = []
    for a, pl in zip(args, in_placements):
        if pl is not None and isinstance(a, torch.Tensor):
            if not is_dtensor(a):
                a = from_shard(a, mesh, (Replicate(),) * mesh.ndim)
            if tuple(a.placements) != tuple(pl):
                a = a.redistribute(mesh, list(pl))
            a = a.to_local()
        shards.append(a)
    out = fn(*shards)
    if all(isinstance(pl, Placement) for pl in out_placements):
        return from_shard(out, mesh, out_placements)
    return tuple(from_shard(o, mesh, pl)
                 for o, pl in zip(out, out_placements))


def hint_placements(mesh, shape: tuple, *dim_specs: MeshAxes) -> tuple:
    """The placements :func:`hint` would give a tensor of ``shape`` on
    ``mesh`` (all replicated where the hint resolves to nothing)."""
    spec = resolve_hint_spec(dim_specs, mesh, tuple(shape))
    return placements(spec or (), mesh)


def shard_start(x, dim: int) -> int:
    """The global index of the first element of ``x``'s local shard
    along ``dim`` (0 for a plain tensor or an unsharded dim; even
    shards, as :func:`placements` makes them)."""
    if not is_dtensor(x):
        return 0
    from torch.distributed.tensor import Shard
    mesh = x.device_mesh
    coord = mesh.get_coordinate()
    idx = 0
    for md, pl in enumerate(x.placements):
        if isinstance(pl, Shard) and pl.dim == dim:
            idx = idx * mesh.size(md) + coord[md]
    return idx * x.to_local().shape[dim]


def write_rows(dst: torch.Tensor, src: torch.Tensor, start: int,
               dim: int) -> None:
    """``dst[start:start + n]`` along ``dim`` = ``src`` (n rows), in
    place. On DTensors the ranks that hold those rows of ``dst`` write
    them into their shard; ``src`` is first taken into ``dst``'s layout
    on every other dim (never the other way: the live tensor does not
    move)."""
    if not is_dtensor(dst):
        dst.narrow(dim, start, src.shape[dim]).copy_(local(src))
        return
    want = with_dims(dst.placements, {dim: None})
    if is_dtensor(src):
        src = src.redistribute(dst.device_mesh, want).to_local()
    else:
        src = local(distribute_like(src, dst.device_mesh, want))
    mine = dst.to_local()
    lo = shard_start(dst, dim)
    n = src.shape[dim]
    a, b = max(start, lo), min(start + n, lo + mine.shape[dim])
    if a < b:
        mine.narrow(dim, a - lo, b - a).copy_(src.narrow(dim, a - start,
                                                         b - a))


def read_rows(src: torch.Tensor, start: int, n: int,
              dim: int) -> torch.Tensor:
    """``src[start:start + n]`` along ``dim``. On a DTensor sharded along
    ``dim`` the rows come from the ranks that hold them (one all-reduce
    of the rows, the others adding zeros) and are replicated over those
    mesh dims: the rest of the leaf does not move."""
    if not is_dtensor(src):
        return src.narrow(dim, start, n)
    from torch.distributed.tensor import Partial, Shard
    mine = src.to_local()
    lo = shard_start(src, dim)
    shape = list(mine.shape)
    shape[dim] = n
    out = torch.zeros(shape, dtype=mine.dtype, device=mine.device)
    a, b = max(start, lo), min(start + n, lo + mine.shape[dim])
    if a < b:
        out.narrow(dim, a - start, b - a).copy_(mine.narrow(dim, a - lo,
                                                             b - a))
    part = tuple(Partial() if isinstance(pl, Shard) and pl.dim == dim
                 else pl for pl in src.placements)
    return from_shard(out, src.device_mesh, part).redistribute(
        src.device_mesh, with_dims(src.placements, {dim: None}))


def distribute_like(x: torch.Tensor, mesh, place) -> torch.Tensor:
    """A tensor every rank holds whole, as a DTensor with ``place``:
    each rank keeps a copy of its own shard (``distribute_tensor``'s
    layout: a dim sharded over several mesh dims splits in mesh-dim
    order), and nothing is sent."""
    from torch.distributed.tensor import Shard
    coord = mesh.get_coordinate()
    mine = x
    for md, pl in enumerate(place):
        if isinstance(pl, Shard):
            n = mine.shape[pl.dim] // mesh.size(md)
            mine = mine.narrow(pl.dim, coord[md] * n, n)
    if mine is not x:
        mine = mine.contiguous()
    return from_shard(mine, mesh, place)


__all__ = ["AbstractMesh", "ShardingRules", "ambient_mesh",
           "distribute_like", "drop_hint_axes", "from_shard", "hint",
           "hint_placements", "hint_scope", "is_dtensor",
           "keep_dims", "local", "mesh_axis_names", "mesh_axis_sizes",
           "on_shards", "placements", "read_rows", "resolve_hint_spec",
           "shard_start", "use_mesh", "with_dims",
           "write_rows"]
