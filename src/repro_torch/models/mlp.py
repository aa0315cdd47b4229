"""Feed-forward blocks — the port of ``repro/models/mlp.py``: SwiGLU,
GeGLU and the biased plain GELU (the tanh approximation, as the
reference's ``jax.nn.gelu(approximate=True)``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

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
    dt = x.dtype
    if cfg.mlp_variant in ("swiglu", "geglu"):
        g = x @ p["w_gate"].to(dt)
        u = x @ p["w_up"].to(dt)
        act = F.silu(g) if cfg.mlp_variant == "swiglu" \
            else F.gelu(g, approximate="tanh")
        return (act * u) @ p["w_down"].to(dt)
    h = F.gelu(x @ p["w_up"].to(dt) + p["b_up"].to(dt), approximate="tanh")
    return h @ p["w_down"].to(dt) + p["b_down"].to(dt)


__all__ = ["apply_mlp", "init_mlp"]
