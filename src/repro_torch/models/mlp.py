"""Feed-forward blocks — the port of ``repro/models/mlp.py``: SwiGLU,
GeGLU and the biased plain GELU (the tanh approximation, as the
reference's ``jax.nn.gelu(approximate=True)``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import is_dtensor, on_shards, with_dims
from repro_torch.models.common import dense_init, zeros_init


def init_mlp(gen, cfg, *, device, d_model: int | None = None) -> dict:
    d = d_model or cfg.d_model
    f = cfg.d_ff
    if cfg.mlp_variant in ("swiglu", "geglu"):
        return {
            "w_gate": dense_init(gen, (d, f), ("embed", "ffn"), device=device),
            "w_up": dense_init(gen, (d, f), ("embed", "ffn"), device=device),
            "w_down": dense_init(gen, (f, d), ("ffn", "embed"),
                                 device=device, fan_in=f),
        }
    return {
        "w_up": dense_init(gen, (d, f), ("embed", "ffn"), device=device),
        "b_up": zeros_init((f,), ("ffn",), device=device),
        "w_down": dense_init(gen, (f, d), ("ffn", "embed"), device=device,
                             fan_in=f),
        "b_down": zeros_init((d,), ("embed_nomodel",), device=device),
    }


def apply_mlp(p, cfg, x: torch.Tensor) -> torch.Tensor:
    if is_dtensor(x) or is_dtensor(p["w_up"]):
        return _apply_mlp_sharded(p, cfg, x)
    y = _mlp(p, cfg, x)
    return y + p["b_down"].to(x.dtype) if "b_down" in p else y


def _mlp(p, cfg, x: torch.Tensor) -> torch.Tensor:
    """The block on whole tensors, or on one rank's ffn columns (then a
    partial sum), without the output bias."""
    dt = x.dtype
    if cfg.mlp_variant in ("swiglu", "geglu"):
        g = x @ p["w_gate"].to(dt)
        u = x @ p["w_up"].to(dt)
        act = F.silu(g) if cfg.mlp_variant == "swiglu" \
            else F.gelu(g, approximate="tanh")
        return (act * u) @ p["w_down"].to(dt)
    h = F.gelu(x @ p["w_up"].to(dt) + p["b_up"].to(dt), approximate="tanh")
    return h @ p["w_down"].to(dt)


def _apply_mlp_sharded(p, cfg, x: torch.Tensor) -> torch.Tensor:
    """Tensor parallelism over the ffn dim on DTensors: each rank
    multiplies its rows of ``x`` by its ffn columns of the up and gate
    weights (gathered over the mesh dims that shard their d_model rows)
    and its ffn rows of the down weight, and the partial sums over the
    ffn's ranks are reduced once."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    names = [k for k in ("w_gate", "w_up", "b_up", "w_down") if k in p]
    ffn_dim = {"w_gate": 1, "w_up": 1, "b_up": 0, "w_down": 0}
    w = p["w_up"]

    def where(mesh):
        ffn = [isinstance(pl, Shard) and pl.dim == 1 for pl in w.placements]
        rows = (x.placements if is_dtensor(x)
                else (Replicate(),) * mesh.ndim)
        x_in = tuple(Replicate() if f else
                     (pl if isinstance(pl, Shard) and pl.dim == 0
                      else Replicate()) for f, pl in zip(ffn, rows))
        out = tuple(Partial() if f else pl for f, pl in zip(ffn, x_in))
        ws = tuple(tuple(Shard(ffn_dim[n]) if f else Replicate()
                         for f in ffn) for n in names)
        return (x_in, *ws), out

    y = on_shards(lambda x_, *ws: _mlp(dict(zip(names, ws)), cfg, x_),
                  (x, *(p[n] for n in names)), where)
    y = y.redistribute(y.device_mesh, with_dims(y.placements, {}))
    return y + p["b_down"].to(y.dtype) if "b_down" in p else y


__all__ = ["apply_mlp", "init_mlp"]
