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
families (ROADMAP.md, Queue 1 item 6b).

The decode paths of serving are here too: the ring cache
(:func:`init_cache`, :func:`decode_attention`) and the paged cache
(:func:`init_paged_cache`, :func:`paged_decode_attention`, whose
attention runs in the ``paged_decode`` kernel or its plain version).
Unlike the reference, which returns new caches, the port writes K/V
into the cache tensors it is given, in place, and returns them.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.paged_decode import paged_decode, paged_decode_plain
from repro_torch.models.common import (
    apply_rope, dense_init, rope, rope_angles, zeros_init)

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
                     prefix_len=None, q_offset: int = 0,
                     k_len=None) -> torch.Tensor:
    """Materialized attention. q: (B,Tq,K,G,hd), k/v: (B,Tk,K,hd).
    ``k_len`` (an int) masks the keys at positions >= k_len (the
    valid length of a cache)."""
    Tq, Tk = q.shape[1], k.shape[1]
    scale = q.shape[-1] ** -0.5
    # float32 scores of the working-type inputs (preferred_element_type)
    scores = torch.einsum("btkgh,bskh->bkgts", (q * scale).float(),
                          k.float())
    q_pos = q_offset + torch.arange(Tq, device=q.device)
    k_pos = torch.arange(Tk, device=q.device)
    keep = _mask_block(q_pos, k_pos, mode, window,
                       prefix_len if prefix_len is not None else 0)
    if k_len is not None:                            # cache validity limit
        keep = keep & (k_pos[None, :] < k_len)
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
            "item 6b)")
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


# ---------------------------------------------------------------------------
# decode path: single-token step against a KV cache
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, cache_len: int, dtype=torch.bfloat16, *,
               device) -> dict:
    """Ring-cache leaves for ONE layer (the engine stacks the layers).
    A ring buffer when the serving window is set and cache_len equals
    it."""
    K, hd = cfg.num_kv_heads, cfg.head_dim
    return {"k": torch.zeros((batch, cache_len, K, hd), dtype=dtype,
                             device=device),
            "v": torch.zeros((batch, cache_len, K, hd), dtype=dtype,
                             device=device)}


def init_paged_cache(cfg, num_pages: int, page_size: int,
                     dtype=torch.bfloat16, *, device) -> dict:
    """Paged-cache leaves for ONE layer: a pool of fixed-size pages
    shared by every slot (page 0 is the reserved dummy page)."""
    K, hd = cfg.num_kv_heads, cfg.head_dim
    shape = (num_pages, page_size, K, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def page_flat_index(page_map: torch.Tensor, pos: torch.Tensor,
                    page_size: int) -> torch.Tensor:
    """Each slot's write offset in the flattened pool, (B,) int64: the
    page that holds position ``pos`` (its index clipped into the row, so
    a retired slot's growing ``pos`` stays on its all-dummy row), times
    the page size, plus the offset in the page."""
    P = page_map.shape[1]
    pos = pos.long()
    idx = torch.clamp(torch.div(pos, page_size, rounding_mode="floor"),
                      0, P - 1)
    pg = page_map.gather(1, idx[:, None])[:, 0].long()
    return pg * page_size + pos % page_size


def _paged_scatter(kv: dict, k_new: torch.Tensor, v_new: torch.Tensor,
                   flat: torch.Tensor) -> None:
    """Write per-row K/V (R, K, hd) at flat page offsets (R,) int64 into
    the (num_pages, page_size, K, hd) pools, in place. Rows routed to the
    dummy page may share an offset; ``index_copy_`` then keeps no fixed
    winner (on CUDA), which is harmless: nobody reads page 0 unmasked."""
    for name, new in (("k", k_new), ("v", v_new)):
        pool = kv[name]
        N, ps = pool.shape[:2]
        pool.view(N * ps, *pool.shape[2:]).index_copy_(
            0, flat, new.to(pool.dtype))


def rotary_angles(cfg, positions: torch.Tensor):
    """The model's RoPE angles at ``positions`` (..., T) — made once per
    step or chunk for every layer; None without RoPE. A decode step
    passes ``pos[:, None]``, one new token per slot."""
    if not cfg.rope:
        return None
    return rope_angles(positions, cfg.head_dim, cfg.rope_theta)


def _rotate_new_token(cfg, q, k_new, rotary):
    """RoPE on one new token per slot with the angles of
    :func:`rotary_angles`."""
    if rotary is None:
        return q, k_new
    B = q.shape[0]
    q = apply_rope(q.reshape(B, 1, -1, cfg.head_dim), *rotary)
    return q.reshape(B, 1, cfg.num_kv_heads, cfg.q_per_kv, cfg.head_dim), \
        apply_rope(k_new, *rotary)


def paged_decode_attention(p, cfg, x: torch.Tensor, cache: dict,
                           pos: torch.Tensor, page_map: torch.Tensor, *,
                           flat: torch.Tensor, rotary, window: int = 0,
                           use_kernel: bool = False):
    """One-token attention step against a PAGED cache.

    x: (B, 1, d); cache: {'k','v'} (num_pages, page_size, K, hd), updated
    in place; pos: (B,) int32 absolute positions; page_map: (B,
    pages_per_slot) int32 — each slot's logical pages in position order
    (dummy page 0 for unallocated entries); ``flat``: the write offsets
    of :func:`page_flat_index` and ``rotary``: the angles of
    :func:`rotary_angles`, both made once per step for every layer. The
    paged cache stores FULL positions and masks a [pos-window, pos]
    band, so sliding archs need no ring arithmetic.

    Returns (out, cache). With ``use_kernel`` the attention goes through
    the ``paged_decode`` wrapper (the CUDA kernel on a CUDA tensor, its
    plain version on a CPU tensor); without, through the plain gather
    path in the compute dtype.
    """
    B = x.shape[0]
    k_new, v_new = _project_kv(p, cfg, x)
    q, k_new = _rotate_new_token(cfg, _project_q(p, cfg, x), k_new, rotary)
    # slots mid-prefill or retired carry an all-dummy page-map row, so
    # their write lands in the page-0 sink
    _paged_scatter(cache, k_new[:, 0], v_new[:, 0], flat)
    if use_kernel:
        out = paged_decode(q[:, 0].float().contiguous(), cache["k"],
                           cache["v"], page_map, pos, window=window)
    else:
        out = paged_decode_plain(q[:, 0], cache["k"], cache["v"], page_map,
                                 pos, window=window)
    out = out.to(x.dtype).reshape(B, 1, cfg.num_heads * cfg.head_dim)
    return out @ p["wo"].to(x.dtype), cache


def decode_attention(p, cfg, x: torch.Tensor, cache: dict,
                     pos: torch.Tensor, *, rotary, window: int = 0):
    """One-token attention step against a ring cache.

    x: (B, 1, d); cache: {'k','v'} (B, S, K, hd), updated in place; pos:
    int32 ``(B,)`` — the absolute position of each slot's new token;
    ``rotary``: the angles of :func:`rotary_angles` at ``pos``. Returns
    (out, cache).

    Ring-buffer semantics when window > 0 and S == window: slot =
    pos % window and all cache entries are valid once pos >= window.
    Keys are stored post-RoPE (absolute rotation).
    """
    B = x.shape[0]
    k_new, v_new = _project_kv(p, cfg, x)
    q, k_new = _rotate_new_token(cfg, _project_q(p, cfg, x), k_new, rotary)

    S = cache["k"].shape[1]
    slot = pos % max(S, 1) if window > 0 else pos
    slot = torch.clamp(slot, max=S - 1).long()       # (B,)
    rows = torch.arange(B, device=x.device)
    k, v = cache["k"], cache["v"]
    k[rows, slot] = k_new[:, 0].to(k.dtype)
    v[rows, slot] = v_new[:, 0].to(v.dtype)

    scale = cfg.head_dim ** -0.5
    s = torch.einsum("btkgh,bskh->bkgts", (q * scale).float(),
                     k.to(q.dtype).float())         # (B,K,G,1,S)
    k_pos = torch.arange(S, device=x.device)
    if window > 0:
        # ring: all valid once a slot's position wraps past the window
        valid = (k_pos[None, :] <= slot[:, None]) | (pos[:, None] >= S)
    else:
        valid = k_pos[None, :] <= pos[:, None]       # (B, S)
    s = s.masked_fill(~valid[:, None, None, None, :], NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgts,bskh->btkgh", w,
                       v.to(q.dtype).float()).to(x.dtype)
    out = out.reshape(B, 1, cfg.num_heads * cfg.head_dim)
    return out @ p["wo"].to(x.dtype), cache


__all__ = ["NEG_INF", "attention_block", "decode_attention", "init_attention",
           "init_cache", "init_paged_cache", "page_flat_index",
           "paged_decode_attention", "rotary_angles", "simple_attention"]
