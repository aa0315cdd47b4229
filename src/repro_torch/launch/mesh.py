"""Meshes — the port of ``repro/launch/mesh.py``.

Defined as FUNCTIONS, so importing this module touches no process
group. :func:`make_serve_mesh` builds a ``DeviceMesh`` over the ranks of
the ``torch.distributed`` world (``launch/serve.py --mesh``);
:func:`make_production_mesh` gives the production geometries as
sizes-only meshes (:class:`~repro_torch.dist.sharding.AbstractMesh`),
which rules resolve against and nothing is placed on: no card set here
holds 256 or 512 ranks.
"""
from __future__ import annotations

from repro_torch.dist.sharding import AbstractMesh, mesh_axis_sizes


def make_production_mesh(*, multi_pod: bool = False, pods: int = 2
                         ) -> AbstractMesh:
    """Single pod: 256 chips as (data=16, model=16). Multi-pod: ``pods``
    pods of 256 chips as (pod, data=16, model=16) — the default 2 pods
    is the 512-chip production target."""
    if multi_pod:
        return AbstractMesh((pods, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


def chips_in(mesh) -> int:
    """The number of devices (ranks) of a ``DeviceMesh`` or an
    :class:`AbstractMesh`."""
    n = 1
    for s in mesh_axis_sizes(mesh).values():
        n *= s
    return n


def serve_mesh_shape(spec: str, n: int) -> tuple[int, int]:
    """(data, model) of a serving mesh spec over ``n`` ranks:

      * ``"host"``  — all ranks tensor-parallel: (data=1, model=n)
      * ``"data"``  — all ranks data-parallel:   (data=n, model=1)
      * ``"AxB"``   — explicit (data=A, model=B), e.g. ``"2x4"``
    """
    if spec == "host":
        return (1, n)
    if spec == "data":
        return (n, 1)
    try:
        d, m = (int(x) for x in spec.split("x"))
    except ValueError:
        raise ValueError(
            f"mesh spec {spec!r}: expected 'host', 'data', or 'AxB'")
    if d * m != n:
        raise ValueError(
            f"mesh spec {spec!r} wants {d * m} devices, have {n}")
    return (d, m)


def make_serve_mesh(spec: str = "host", device_type: str = "cuda"):
    """Serving mesh over the ranks of the initialized ``torch.distributed``
    world (``launch/serve.py --mesh``), shaped by
    :func:`serve_mesh_shape`. Dims are always ``("data", "model")``, so
    the serve rule tables resolve alike across specs (size-1 dims
    replicate)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape = serve_mesh_shape(spec, dist.get_world_size())
    return init_device_mesh(device_type, shape,
                            mesh_dim_names=("data", "model"))


__all__ = ["chips_in", "make_production_mesh", "make_serve_mesh",
           "serve_mesh_shape"]
