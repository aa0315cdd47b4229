"""Mamba-2 block (SSD — state-space duality, arXiv:2405.21060) — the port
of ``repro/models/ssm.py``.

Layer: in_proj -> [z | x | B | C | dt] ; short causal conv on (x, B, C);
SSD scan  h_t = exp(dt*A) h_{t-1} + dt * B_t (x) x_t,  y_t = C_t h_t
+ D*x_t ; gate by silu(z); out_proj.

Two SSD execution paths, as in the reference:
* :func:`ssd_chunked` (the default): the chunked scan in torch ops,
  carrying the (H, S, P) state from chunk to chunk, from any initial
  state; it has a gradient.
* ``use_kernel=True`` (the reference's ``use_pallas``): the
  ``ssd_scan`` kernel of :mod:`repro_torch.kernels.ssd_scan`, forward
  only and from a zero state, through ``ssd_scan_heads``: the kernel
  reads the (b, T, H, ·) layout through strides and B and C as they are,
  shared by the heads (the reference repeats B and C for every head and
  transposes x, dt and loga into rows, as its TPU kernel needs).

Decode: the O(1) single-step state update (:func:`decode_ssm`), with
the reference's sharding hints: under a mesh the state goes over
``model`` by SSM heads. The scan of :func:`ssm_sequence`, kernel or
plain, runs on each rank's heads (and slots) under a mesh: the heads
scan independently.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import hint, hint_placements, on_shards
from repro_torch.kernels.ssd_scan import ssd_chunked, ssd_scan_heads
from repro_torch.models.common import Px, dense_init, ones_init, _normal


def _dims(cfg):
    d_in = cfg.ssm_expand * cfg.d_model
    H = cfg.ssm_num_heads
    P = cfg.ssm_head_dim
    S = cfg.ssm_state_dim
    assert H * P == d_in, (H, P, d_in)
    return d_in, H, P, S


def init_ssm(gen, cfg, *, device) -> dict:
    d = cfg.d_model
    d_in, H, P, S = _dims(cfg)
    K = cfg.ssm_conv_width
    return {
        "w_in": dense_init(gen, (d, 2 * d_in + 2 * S + H),
                           ("embed", "ssm_in"), device=device),
        "conv_x": Px(_normal(gen, (K, d_in), device) * 0.1,
                     ("conv_k", "ssm_in")),
        "conv_B": Px(_normal(gen, (K, S), device) * 0.1,
                     ("conv_k", "ssm_state")),
        "conv_C": Px(_normal(gen, (K, S), device) * 0.1,
                     ("conv_k", "ssm_state")),
        "A_log": Px(torch.log(torch.linspace(1.0, 16.0, H, device=device)),
                    ("ssm_heads",)),
        "D": ones_init((H,), ("ssm_heads",), device=device),
        "dt_bias": Px(torch.log(torch.expm1(
            torch.linspace(1e-3, 1e-1, H, device=device))), ("ssm_heads",)),
        "w_out": dense_init(gen, (d_in, d), ("ssm_in", "embed"),
                            fan_in=d_in, device=device),
    }


def _split_proj(cfg, proj: torch.Tensor):
    d_in, H, P, S = _dims(cfg)
    return torch.split(proj, [d_in, d_in, S, S, H], dim=-1)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, state=None):
    """Depthwise causal conv, the reference's sum of shifted products (not
    ``F.conv1d``, which cuDNN runs in TF32 by default). x: (B, T, D);
    w: (K, D); state: (B, K-1, D) trailing context (zeros if None).
    Returns (y, new_state)."""
    K = w.shape[0]
    pad = (torch.zeros_like(x[:, :K - 1]) if state is None
           else state.to(x.dtype))
    xp = torch.cat([pad, x], dim=1)                 # (B, T+K-1, D)
    T = x.shape[1]
    y = sum(xp[:, i:i + T] * w[i].to(x.dtype) for i in range(K))
    new_state = xp[:, xp.shape[1] - (K - 1):] if K > 1 else x[:, :0]
    return y, new_state


def ssm_sequence(p, cfg, x: torch.Tensor, *, conv0=None, keep=None,
                 h0=None, use_kernel: bool = False):
    """The SSD block over a sequence, with what a cache needs of it.

    x: (b, T, d). conv0: the (conv_x, conv_B, conv_C) trailing contexts
    to continue from (zeros if None); keep: (b, T, 1) bool — dt = 0
    where False freezes the recurrence (pad rows); h0: (b, H, S, P)
    initial state (zeros if None); use_kernel: the scan through the
    ``ssd_scan`` kernel, which starts from a zero state only.

    Returns (out (b, T, d), h_final (b, H, S, P) float32, the
    pre-activation conv inputs (xs, B, C))."""
    if use_kernel and h0 is not None:
        raise ValueError("the ssd_scan kernel starts from a zero state; a "
                         "scan from h0 takes ssd_chunked")
    b, T, _ = x.shape
    d_in, H, P, S = _dims(cfg)
    dt_model = x.dtype
    cx0, cB0, cC0 = conv0 if conv0 is not None else (None, None, None)

    # whole over ``model`` before the split: DTensor splits a sharded
    # dim by moving its shard onto the sequence
    proj = hint(x @ p["w_in"].to(dt_model), ("pod", "data"), None, None)
    z, xs, Bm, Cm, dt_raw = _split_proj(cfg, proj)
    pre = (xs, Bm, Cm)
    xs = F.silu(_causal_conv(xs, p["conv_x"], cx0)[0])
    Bm = F.silu(_causal_conv(Bm, p["conv_B"], cB0)[0])
    Cm = F.silu(_causal_conv(Cm, p["conv_C"], cC0)[0])

    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())   # (b, T, H)
    if keep is not None:
        dt = torch.where(keep, dt, 0.0)
    A = -torch.exp(p["A_log"].float())                       # (H,)
    loga = dt * A

    xh = xs.reshape(b, T, H, P)
    y, h_fin = _scan(xh, dt, loga, Bm, Cm, h0, chunk=cfg.ssm_chunk,
                     use_kernel=use_kernel)
    y = y + xh * p["D"].to(dt_model)[None, None, :, None]
    y = y.reshape(b, T, d_in) * F.silu(z)
    return y @ p["w_out"].to(dt_model), h_fin, pre


def _scan(xh, dt, loga, Bm, Cm, h0, *, chunk: int, use_kernel: bool):
    """The SSD scan, the ``ssd_scan`` kernel or the plain chunked one,
    -> (y (b, T, H, P), h_final (b, H, S, P)). On DTensors it runs on
    each rank's shard — its heads over ``model`` where H divides it, its
    rows over ``data`` where b does — so every rank launches the kernel
    on its own heads."""
    def scan(xh, dt, loga, Bm, Cm, h0):
        if use_kernel:
            return ssd_scan_heads(xh, dt, loga, Bm, Cm, chunk=chunk)
        return ssd_chunked(xh, dt, loga, Bm, Cm, h0=h0, chunk=chunk)

    def where(mesh):
        rows = ("pod", "data")
        heads = hint_placements(mesh, xh.shape, rows, None, "model", None)
        per_head = hint_placements(mesh, dt.shape, rows, None, "model")
        shared = hint_placements(mesh, Bm.shape, rows, None, None)
        state = hint_placements(mesh, (xh.shape[0], xh.shape[2],
                                       Bm.shape[2], xh.shape[3]),
                                rows, "model", None, None)
        return ((heads, per_head, per_head, shared, shared,
                 None if h0 is None else state), (heads, state))

    return on_shards(scan, (xh, dt, loga, Bm, Cm, h0), where)


def apply_ssm(p, cfg, x: torch.Tensor, *,
              use_kernel: bool = False) -> torch.Tensor:
    """Full-sequence SSD block. x: (B, T, d) -> (B, T, d). ``use_kernel``:
    the scan through the ``ssd_scan`` kernel (forward only)."""
    return ssm_sequence(p, cfg, x, use_kernel=use_kernel)[0]


# ---------------------------------------------------------------------------
# decode: O(1) recurrent step
# ---------------------------------------------------------------------------

def init_ssm_cache(cfg, batch: int, dtype=torch.float32, *,
                   device) -> dict:
    d_in, H, P, S = _dims(cfg)
    K = cfg.ssm_conv_width
    return {
        "h": torch.zeros((batch, H, S, P), dtype=torch.float32,
                         device=device),
        "conv_x": torch.zeros((batch, K - 1, d_in), dtype=dtype,
                              device=device),
        "conv_B": torch.zeros((batch, K - 1, S), dtype=dtype, device=device),
        "conv_C": torch.zeros((batch, K - 1, S), dtype=dtype, device=device),
    }


def ssm_cache_logical_axes(cfg) -> dict:
    """Logical axes of :func:`init_ssm_cache`'s leaves."""
    return {
        "h": ("cache_batch", "ssm_heads", "ssm_state", None),
        "conv_x": ("cache_batch", None, "ssm_in"),
        "conv_B": ("cache_batch", None, None),
        "conv_C": ("cache_batch", None, None),
    }


def decode_ssm(p, cfg, x: torch.Tensor, cache: dict):
    """x: (B, 1, d) -> (y, new_cache); ``cache`` is read, not written."""
    b = x.shape[0]
    d_in, H, P, S = _dims(cfg)
    dt_model = x.dtype

    # whole over ``model`` before the split: DTensor splits a sharded
    # dim by moving its shard onto the sequence
    proj = hint(x @ p["w_in"].to(dt_model), ("pod", "data"), None, None)
    z, xs, Bm, Cm, dt_raw = _split_proj(cfg, proj)
    xs, cx = _causal_conv(xs, p["conv_x"], cache["conv_x"])
    Bm, cB = _causal_conv(Bm, p["conv_B"], cache["conv_B"])
    Cm, cC = _causal_conv(Cm, p["conv_C"], cache["conv_C"])
    xs = F.silu(xs)[:, 0]                          # (b, d_in)
    Bm = F.silu(Bm)[:, 0]                          # (b, S)
    Cm = F.silu(Cm)[:, 0]

    dt = F.softplus(dt_raw[:, 0].float() + p["dt_bias"].float())   # (b, H)
    A = -torch.exp(p["A_log"].float())
    a = torch.exp(dt * A)                                          # (b, H)

    xh = xs.reshape(b, H, P).float()
    # tensor-parallel decode: recurrent state sharded over SSM heads
    # (shape-aware — a no-op off a mesh / on indivisible head counts)
    xh = hint(xh, ("pod", "data"), "model", None)
    h = a[..., None, None] * cache["h"] + \
        dt[..., None, None] * Bm[:, None, :, None] * xh[:, :, None, :]
    h = hint(h, ("pod", "data"), "model", None, None)
    y = torch.einsum("bs,bhsp->bhp", Cm.float(), h)                # (b, H, P)
    y = y + xh * p["D"].float()[None, :, None]
    y = y.reshape(b, 1, d_in).to(dt_model)
    y = y * F.silu(z)
    new_cache = {"h": h, "conv_x": cx.to(cache["conv_x"].dtype),
                 "conv_B": cB.to(cache["conv_B"].dtype),
                 "conv_C": cC.to(cache["conv_C"].dtype)}
    return y @ p["w_out"].to(dt_model), new_cache


__all__ = ["apply_ssm", "decode_ssm", "init_ssm", "init_ssm_cache",
           "ssd_chunked", "ssd_scan_heads", "ssm_cache_logical_axes",
           "ssm_sequence"]
