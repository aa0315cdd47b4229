"""Attention for the model zoo, training path — the port of the train/
prefill part of ``repro/models/attention.py``: GQA/MQA/MHA with RoPE,
QKV bias, causal / sliding-window / prefix-LM / full masks.

Layouts are the reference's: queries ``(B, T, K, G, hd)`` (K kv heads,
G = query heads per kv head), keys and values ``(B, T, K, hd)``, and
masked scores take ``NEG_INF``. Scores and the weighted sum accumulate
in float32 (the reference's ``preferred_element_type``).

Only the materialized path is ported: ``attention_block`` handles
``max(T, Tk) <= flash_threshold`` (2048). Longer sequences need the
chunked online-softmax ``flash_attention``, which comes with the other
families (ROADMAP.md, Queue 1 item 6); the KV-cache decode paths come
with serving (item 7).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.common import dense_init, rope, zeros_init

NEG_INF = -1e30


def init_attention(gen, cfg, *, device, d_model: int | None = None) -> dict:
    d = d_model or cfg.d_model
    hd, H, K = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    p = {
        "wq": dense_init(gen, (d, H * hd), ("embed", "q_proj"), device=device),
        "wk": dense_init(gen, (d, K * hd), ("embed", "kv_proj"),
                         device=device),
        "wv": dense_init(gen, (d, K * hd), ("embed", "kv_proj"),
                         device=device),
        "wo": dense_init(gen, (H * hd, d), ("q_proj", "embed"),
                         device=device, scale=1.0, fan_in=H * hd),
    }
    if cfg.qkv_bias:
        p["bq"] = zeros_init((H * hd,), ("q_proj",), device=device)
        p["bk"] = zeros_init((K * hd,), ("kv_proj",), device=device)
        p["bv"] = zeros_init((K * hd,), ("kv_proj",), device=device)
    return p


# ---------------------------------------------------------------------------
# mask logic
# ---------------------------------------------------------------------------

def _mask_block(q_pos: torch.Tensor, k_pos: torch.Tensor, mode: str,
                window: int, prefix_len) -> torch.Tensor:
    """Boolean keep-mask for a (Tq, Tk) tile given absolute positions.

    mode: 'causal' | 'sliding' | 'prefix' | 'full'
    """
    q = q_pos[:, None]
    k = k_pos[None, :]
    if mode == "full":
        return torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                          device=q_pos.device)
    causal = k <= q
    if mode == "causal":
        return causal
    if mode == "sliding":
        return causal & (k > q - window)
    if mode == "prefix":
        # bidirectional inside the prefix, causal after
        both_prefix = (q < prefix_len) & (k < prefix_len)
        return causal | both_prefix
    raise ValueError(mode)


# ---------------------------------------------------------------------------
# core attention
# ---------------------------------------------------------------------------

def simple_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     mode: str = "causal", window: int = 0,
                     prefix_len=None, q_offset: int = 0) -> torch.Tensor:
    """Materialized attention. q: (B,Tq,K,G,hd), k/v: (B,Tk,K,hd)."""
    Tq, Tk = q.shape[1], k.shape[1]
    scale = q.shape[-1] ** -0.5
    # float32 scores of the working-type inputs (preferred_element_type)
    scores = torch.einsum("btkgh,bskh->bkgts", (q * scale).float(),
                          k.float())
    q_pos = q_offset + torch.arange(Tq, device=q.device)
    k_pos = torch.arange(Tk, device=q.device)
    keep = _mask_block(q_pos, k_pos, mode, window,
                       prefix_len if prefix_len is not None else 0)
    scores = scores.masked_fill(~keep, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgts,bskh->btkgh", w, v.float())
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# the full attention block (projections)
# ---------------------------------------------------------------------------

def _project_q(p, cfg, x: torch.Tensor) -> torch.Tensor:
    B, T, _ = x.shape
    q = x @ p["wq"].to(x.dtype)
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
    return q.reshape(B, T, cfg.num_kv_heads, cfg.q_per_kv, cfg.head_dim)


def _project_kv(p, cfg, x: torch.Tensor):
    B, T, _ = x.shape
    k = x @ p["wk"].to(x.dtype)
    v = x @ p["wv"].to(x.dtype)
    if "bk" in p:
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    k = k.reshape(B, T, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(B, T, cfg.num_kv_heads, cfg.head_dim)
    return k, v


def attention_block(p, cfg, x: torch.Tensor, *, mode: str = "causal",
                    window: int = 0, prefix_len=None,
                    positions: Optional[torch.Tensor] = None,
                    flash_threshold: int = 2048) -> torch.Tensor:
    """Self-attention over a full sequence (training). x: (B, T, d) ->
    (B, T, d)."""
    B, T, _ = x.shape
    if T > flash_threshold:
        raise NotImplementedError(
            f"sequence length {T} > {flash_threshold} needs the chunked "
            "flash_attention, which is not ported yet (ROADMAP.md Queue 1 "
            "item 6)")
    q = _project_q(p, cfg, x)
    k, v = _project_kv(p, cfg, x)
    if cfg.rope:
        pos = positions if positions is not None \
            else torch.arange(T, device=x.device)
        q = rope(q.reshape(B, T, -1, cfg.head_dim), pos,
                 cfg.rope_theta).reshape(q.shape)
        k = rope(k, pos, cfg.rope_theta)
    out = simple_attention(q, k, v, mode=mode, window=window,
                           prefix_len=prefix_len)
    out = out.reshape(B, T, cfg.num_heads * cfg.head_dim)
    return out @ p["wo"].to(x.dtype)


__all__ = ["NEG_INF", "attention_block", "init_attention",
           "simple_attention"]
