"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427) —
the port of ``repro/models/rglru.py``.

Griffin recurrent block:
  branch A: linear -> GeLU
  branch B: linear -> short causal conv -> RG-LRU
  merge: A * B -> out-proj

RG-LRU (per channel):
  r_t = sigmoid(W_a x_t + b_a)            recurrence gate
  i_t = sigmoid(W_x x_t + b_x)            input gate
  a_t = exp(c * softplus(Lambda) * (-r_t))     in (0,1),  c = 8
  h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The full-sequence recurrence ``h_t = a_t h_{t-1} + b_t`` runs as a
log-depth scan on tensors (:func:`linear_scan`): ceil(log2 T) doubling
steps, each elementwise over ``(B, T, w)`` — the reference's
``jax.lax.associative_scan`` in another tree of the same combine, so the
two sum in another order. Decode is the single-step update. The
reference's sharding hint in ``decode_rglru`` puts the recurrence
width over ``model`` under a mesh.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import hint
from repro_torch.models.common import Px, _normal, dense_init, zeros_init
from repro_torch.models.ssm import _causal_conv

RG_C = 8.0


def _width(cfg) -> int:
    return cfg.rglru_width or cfg.d_model


def init_rglru(gen, cfg, *, device) -> dict:
    d = cfg.d_model
    w = _width(cfg)
    conv_k = cfg.rglru_conv_width
    return {
        "w_gelu": dense_init(gen, (d, w), ("embed", "rnn_width"),
                             device=device),
        "w_rec": dense_init(gen, (d, w), ("embed", "rnn_width"),
                            device=device),
        "conv": Px(_normal(gen, (conv_k, w), device) * 0.1,
                   ("conv_k", "rnn_width")),
        "w_a": dense_init(gen, (w, w), ("rnn_width_in", "rnn_width"),
                          device=device),
        "b_a": zeros_init((w,), ("rnn_width",), device=device),
        "w_x": dense_init(gen, (w, w), ("rnn_width_in", "rnn_width"),
                          device=device),
        "b_x": zeros_init((w,), ("rnn_width",), device=device),
        # Lambda init so that a^c ~ U[0.9, 0.999] at r=1 (paper App. A)
        "lam": Px(torch.log(torch.expm1(-torch.log(torch.linspace(
            0.9, 0.999, w, device=device)) / RG_C)), ("rnn_width",)),
        "w_out": dense_init(gen, (w, d), ("rnn_width", "embed"), fan_in=w,
                            device=device),
    }


def _gates(p, xb: torch.Tensor):
    """xb: (..., w) -> (a, beta) float32: the decay and the input scale."""
    dt = xb.dtype
    r = torch.sigmoid(xb @ p["w_a"].to(dt) + p["b_a"].to(dt)).float()
    i = torch.sigmoid(xb @ p["w_x"].to(dt) + p["b_x"].to(dt)).float()
    a = torch.exp(-RG_C * F.softplus(p["lam"].float()) * r)
    scale = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12))
    return a, scale * i


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Every ``h_t = a_t h_{t-1} + b_t`` from h_{-1} = 0 along axis 1 of
    (B, T, w): at each doubling step d, element t takes in the partial
    product ending at t - d, ``(a, b)_t <- (a_{t-d} a_t, a_t b_{t-d} +
    b_t)`` — ceil(log2 T) steps, each a few elementwise ops. A carried
    state ``h_in`` is folded in by the caller: ``b_0 += a_0 h_in``."""
    T = a.shape[1]
    d = 1
    while d < T:
        b = torch.cat([b[:, :d], b[:, d:] + a[:, d:] * b[:, :-d]], dim=1)
        if 2 * d < T:
            a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def rglru_sequence(p, x: torch.Tensor, *, conv0=None, h0=None):
    """The recurrent block over a sequence, with what a cache needs of it.

    x: (B, T, d); conv0: the (B, K-1, w) trailing conv context to
    continue from (zeros if None); h0: (B, w) float32 inbound state,
    folded into the first scan element (zeros if None).

    Returns (out (B, T, d), hs (B, T, w) float32 — the state after every
    token, the conv input before the conv (B, T, w))."""
    dt = x.dtype
    ga = F.gelu(x @ p["w_gelu"].to(dt), approximate="tanh")
    pre = x @ p["w_rec"].to(dt)
    xb, _ = _causal_conv(pre, p["conv"], conv0)
    a, beta = _gates(p, xb)                          # (B, T, w) f32
    b = beta * xb.float()
    if h0 is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    hs = linear_scan(a, b)
    y = (ga.float() * hs).to(dt)
    return y @ p["w_out"].to(dt), hs, pre


def apply_rglru(p, cfg, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence Griffin recurrent block. x: (B, T, d)."""
    return rglru_sequence(p, x)[0]


def init_rglru_cache(cfg, batch: int, dtype=torch.float32, *,
                     device) -> dict:
    w = _width(cfg)
    K = cfg.rglru_conv_width
    return {"h": torch.zeros((batch, w), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, K - 1, w), dtype=dtype,
                                device=device)}


def rglru_cache_logical_axes(cfg) -> dict:
    """Logical axes of :func:`init_rglru_cache`'s leaves."""
    return {"h": ("cache_batch", "rnn_width"),
            "conv": ("cache_batch", None, "rnn_width")}


def decode_rglru(p, cfg, x: torch.Tensor, cache: dict):
    """x: (B, 1, d) -> (y, new_cache); O(1) state update; ``cache`` is
    read, not written."""
    dt = x.dtype
    ga = F.gelu(x @ p["w_gelu"].to(dt), approximate="tanh")
    xb = x @ p["w_rec"].to(dt)
    # tensor-parallel decode: recurrence width sharded over model
    # (shape-aware — a no-op off a mesh / on indivisible widths)
    xb = hint(xb, ("pod", "data"), None, "model")
    xb, conv_state = _causal_conv(xb, p["conv"], cache["conv"])
    a, beta = _gates(p, xb)                          # (B, 1, w)
    h = a[:, 0] * cache["h"] + beta[:, 0] * xb[:, 0].float()
    y = (ga[:, 0].float() * h).to(dt)[:, None]
    return y @ p["w_out"].to(dt), \
        {"h": h, "conv": conv_state.to(cache["conv"].dtype)}


__all__ = ["RG_C", "apply_rglru", "decode_rglru", "init_rglru",
           "init_rglru_cache", "linear_scan", "rglru_cache_logical_axes",
           "rglru_sequence"]
