"""Attention for the model zoo, training path — the port of the train/
prefill part of ``repro/models/attention.py``: GQA/MQA/MHA with RoPE,
QKV bias, causal / sliding-window / prefix-LM / full masks, and
cross-attention (``attention_block(kv_source=)``).

Layouts are the reference's: queries ``(B, T, K, G, hd)`` (K kv heads,
G = query heads per kv head), keys and values ``(B, T, K, hd)``, and
masked scores take ``NEG_INF``. Scores and the weighted sum accumulate
in float32 (the reference's ``preferred_element_type``).

``attention_block`` materializes the scores up to ``max(T, Tk) ==
flash_threshold`` (2048) and runs the chunked online-softmax
:func:`flash_attention` past it: plain torch over (q_chunk, k_chunk)
tiles, with the reference's flash-style backward (a
``torch.autograd.Function`` that recomputes each tile's probabilities
from the saved log-sum-exp, so the residuals are O(T)). The reference's
pair-scheduled variant (``flash_attention_pairs``), which only its
dry-run switches on, is not ported (ROADMAP.md Queue 1 item 8).

The decode paths of serving are here too: the ring cache
(:func:`init_cache`, :func:`decode_attention`; the cross-attention step
of the encdec and audio kinds, :func:`decode_cross_attention`, over the
encoder's cached K/V) and the paged cache
(:func:`init_paged_cache`, :func:`paged_decode_attention`, whose
attention runs in the ``paged_decode`` kernel or its plain version).
Unlike the reference, which returns new caches, the port writes K/V
into the cache tensors it is given, in place, and returns them.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

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
# chunked online-softmax attention with a flash-style backward
# ---------------------------------------------------------------------------

def _tile_scores(qi, ki, q_pos, k_pos, *, scale, mode, window, prefix_len,
                 k_len) -> torch.Tensor:
    """Masked float32 scores of one (q_chunk, k_chunk) tile,
    (B, K, G, qc, kc)."""
    s = torch.einsum("btkgh,bskh->bkgts", (qi * scale).float(), ki.float())
    keep = _mask_block(q_pos, k_pos, mode, window, prefix_len)
    if k_len is not None:
        keep = keep & (k_pos[None, :] < k_len)
    return s.masked_fill(~keep, NEG_INF)


def _flash_fwd(q, k, v, mode, window, prefix_len, q_offset, q_chunk,
               k_chunk, k_len):
    """-> (out (B, Tq, K, G, hd) in q's dtype, lse (B, Tq, K, G) f32)."""
    B, Tq, K, G, hd = q.shape
    Tk = k.shape[1]
    assert Tq % q_chunk == 0 and Tk % k_chunk == 0, (Tq, Tk)
    scale = hd ** -0.5
    dev = q.device
    outs, lses = [], []
    for q0 in range(0, Tq, q_chunk):
        qi = q[:, q0:q0 + q_chunk]
        q_pos = q_offset + q0 + torch.arange(q_chunk, device=dev)
        acc = torch.zeros((B, K, G, q_chunk, hd), dtype=torch.float32,
                          device=dev)
        m = torch.full((B, K, G, q_chunk), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, K, G, q_chunk), dtype=torch.float32, device=dev)
        for k0 in range(0, Tk, k_chunk):
            k_pos = k0 + torch.arange(k_chunk, device=dev)
            s = _tile_scores(qi, k[:, k0:k0 + k_chunk], q_pos, k_pos,
                             scale=scale, mode=mode, window=window,
                             prefix_len=prefix_len, k_len=k_len)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgts,bskh->bkgth", p, v[:, k0:k0 + k_chunk].float())
            m = m_new
        l_safe = torch.clamp(l, min=1e-30)
        outs.append((acc / l_safe[..., None]).to(q.dtype))
        lses.append(m + torch.log(l_safe))             # (B, K, G, qc)
    out = torch.cat(outs, dim=3).permute(0, 3, 1, 2, 4)
    lse = torch.cat(lses, dim=3).permute(0, 3, 1, 2)
    return out.contiguous(), lse.contiguous()


def _flash_bwd(q, k, v, out, lse, dout, mode, window, prefix_len, q_offset,
               q_chunk, k_chunk, k_len):
    """The reference's ``_flash_bwd``: for each k chunk, every q chunk's
    probabilities recomputed from ``lse``; dK and dV summed over the q
    chunks, dQ over the k chunks, in the reference's order."""
    B, Tq, K, G, hd = q.shape
    Tk = k.shape[1]
    scale = hd ** -0.5
    dev = q.device
    delta = torch.sum(dout.float() * out.float(), dim=-1)   # (B, Tq, K, G)
    dq = torch.zeros((B, Tq, K, G, hd), dtype=torch.float32, device=dev)
    dks, dvs = [], []
    for k0 in range(0, Tk, k_chunk):
        ki = k[:, k0:k0 + k_chunk]
        vi = v[:, k0:k0 + k_chunk].float()
        k_pos = k0 + torch.arange(k_chunk, device=dev)
        dki = torch.zeros((B, k_chunk, K, hd), dtype=torch.float32,
                          device=dev)
        dvi = torch.zeros_like(dki)
        for q0 in range(0, Tq, q_chunk):
            rows = slice(q0, q0 + q_chunk)
            qi = q[:, rows]
            q_pos = q_offset + q0 + torch.arange(q_chunk, device=dev)
            s = _tile_scores(qi, ki, q_pos, k_pos, scale=scale, mode=mode,
                             window=window, prefix_len=prefix_len,
                             k_len=k_len)
            lse_a = lse[:, rows].permute(0, 2, 3, 1)       # (B, K, G, qc)
            del_a = delta[:, rows].permute(0, 2, 3, 1)
            p = torch.exp(s - lse_a[..., None])
            do_b = dout[:, rows].permute(0, 2, 3, 1, 4).float()
            dvi = dvi + torch.einsum("bkgts,bkgth->bskh", p, do_b)
            dp = torch.einsum("bkgth,bskh->bkgts", do_b, vi)
            ds = p * (dp - del_a[..., None]) * scale
            dq_blk = torch.einsum("bkgts,bskh->bkgth", ds, ki.float())
            q_b = qi.permute(0, 2, 3, 1, 4).float()
            dki = dki + torch.einsum("bkgts,bkgth->bskh", ds, q_b)
            dq[:, rows] += dq_blk.permute(0, 3, 1, 2, 4)
        dks.append(dki)
        dvs.append(dvi)
    return (dq.to(q.dtype), torch.cat(dks, dim=1).to(k.dtype),
            torch.cat(dvs, dim=1).to(v.dtype))


class _Flash(torch.autograd.Function):
    """The reference's ``jax.custom_vjp`` of ``_flash``: the residuals
    are q, k, v, the output and the log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, opts):
        out, lse = _flash_fwd(q, k, v, *opts)
        ctx.opts = opts
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        return (*_flash_bwd(*ctx.saved_tensors, dout, *ctx.opts), None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    mode: str = "causal", window: int = 0, prefix_len=None,
                    q_offset: int = 0, q_chunk: int = 512,
                    k_chunk: int = 1024, k_len=None) -> torch.Tensor:
    """Chunked online-softmax attention with a flash-style backward.

    q: (B, Tq, K, G, hd); k, v: (B, Tk, K, hd). Tq % q_chunk == 0 and
    Tk % k_chunk == 0 (the caller pads; ``k_len`` masks the key
    padding). Every (q_chunk, k_chunk) tile is computed, masked or not,
    as in the reference; the backward recomputes each tile's scores, so
    no more than one tile of probabilities is ever held."""
    return _Flash.apply(q, k, v, (mode, window, prefix_len, q_offset,
                                  q_chunk, k_chunk, k_len))


def sequence_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       mode: str = "causal", window: int = 0,
                       prefix_len=None,
                       flash_threshold: int = 2048) -> torch.Tensor:
    """Attention over a whole sequence (training, prefill): the
    materialized :func:`simple_attention` up to ``max(Tq, Tk) ==
    flash_threshold``, else :func:`flash_attention` with the reference's
    chunks (``q_chunk = min(512, Tq)``, ``k_chunk = min(1024, Tk)``),
    q, k and v zero-padded to chunk multiples and the key padding masked
    by ``k_len``."""
    T, Tk = q.shape[1], k.shape[1]
    if max(T, Tk) <= flash_threshold:
        return simple_attention(q, k, v, mode=mode, window=window,
                                prefix_len=prefix_len)
    qc, kc = min(512, T), min(1024, Tk)
    pq, pk = (-T) % qc, (-Tk) % kc
    if pq:
        q = F.pad(q, (0, 0, 0, 0, 0, 0, 0, pq))
    if pk:
        k = F.pad(k, (0, 0, 0, 0, 0, pk))
        v = F.pad(v, (0, 0, 0, 0, 0, pk))
    out = flash_attention(q, k, v, mode=mode, window=window,
                          prefix_len=prefix_len, q_chunk=qc, k_chunk=kc,
                          k_len=Tk if pk else None)
    return out[:, :T]


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
                    kv_source: Optional[torch.Tensor] = None,
                    flash_threshold: int = 2048) -> torch.Tensor:
    """Self- (or cross-) attention over a full sequence (training,
    prefill). x: (B, T, d) -> (B, T, d); ``kv_source`` (B, S, d): the
    keys and values are projected from it, without RoPE (the
    cross-attention of the encdec and audio kinds, mode ``full``). Past
    ``flash_threshold`` queries or keys through :func:`flash_attention`."""
    B, T, _ = x.shape
    q = _project_q(p, cfg, x)
    k, v = _project_kv(p, cfg, x if kv_source is None else kv_source)
    if cfg.rope and kv_source is None:
        pos = positions if positions is not None \
            else torch.arange(T, device=x.device)
        q = rope(q.reshape(B, T, -1, cfg.head_dim), pos,
                 cfg.rope_theta).reshape(q.shape)
        k = rope(k, pos, cfg.rope_theta)
    out = sequence_attention(q, k, v, mode=mode, window=window,
                             prefix_len=prefix_len,
                             flash_threshold=flash_threshold)
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


def last_writers(flat: torch.Tensor) -> torch.Tensor:
    """For each row of a write at page offsets ``flat`` (R,), the last
    row that writes the same offset (the row itself where no later one
    does), (R,) int64: the source rows of :func:`_paged_scatter`."""
    rows = torch.arange(flat.shape[0], device=flat.device)
    return torch.where(flat[:, None] == flat[None, :], rows[None, :],
                       -1).amax(1)


def _paged_scatter(kv: dict, k_new: torch.Tensor, v_new: torch.Tensor,
                   flat: torch.Tensor, src: torch.Tensor) -> None:
    """Write per-row K/V (R, K, hd) at flat page offsets (R,) int64 into
    the (num_pages, page_size, K, hd) pools, in place. Rows routed to the
    dummy page may share an offset; the last such row wins, as in the
    reference's serial scatter: ``index_copy_`` keeps no fixed winner
    (on CUDA, and on the CPU's threads), so every row writes the values
    of its offset's last row, ``src`` (:func:`last_writers` of
    ``flat``). Page 0 must be deterministic: a slot mid-prefill or
    retired attends to it in a decode step, and where an MoE FFN routes
    every slot as one group, that slot's token takes expert capacity
    from the live ones."""
    for name, new in (("k", k_new), ("v", v_new)):
        pool = kv[name]
        N, ps = pool.shape[:2]
        pool.view(N * ps, *pool.shape[2:]).index_copy_(
            0, flat, new[src].to(pool.dtype))


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
                           flat: torch.Tensor, src: torch.Tensor, rotary,
                           window: int = 0, use_kernel: bool = False):
    """One-token attention step against a PAGED cache.

    x: (B, 1, d); cache: {'k','v'} (num_pages, page_size, K, hd), updated
    in place; pos: (B,) int32 absolute positions; page_map: (B,
    pages_per_slot) int32 — each slot's logical pages in position order
    (dummy page 0 for unallocated entries); ``flat``: the write offsets
    of :func:`page_flat_index`, ``src``: their :func:`last_writers`, and
    ``rotary``: the angles of :func:`rotary_angles`, all made once per
    step for every layer. The paged cache stores FULL positions and
    masks a [pos-window, pos] band, so sliding archs need no ring
    arithmetic.

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
    _paged_scatter(cache, k_new[:, 0], v_new[:, 0], flat, src)
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


def decode_cross_attention(p, cfg, x: torch.Tensor, cross_k: torch.Tensor,
                           cross_v: torch.Tensor) -> torch.Tensor:
    """One-token cross-attention step: x (B, 1, d) attends, unmasked, to
    the encoder's cached keys and values ``cross_k``/``cross_v`` (B, S,
    K, hd), projected once at prefill; the cache is only read."""
    B = x.shape[0]
    q = _project_q(p, cfg, x)
    scale = cfg.head_dim ** -0.5
    s = torch.einsum("btkgh,bskh->bkgts", (q * scale).float(),
                     cross_k.to(q.dtype).float())    # (B,K,G,1,S)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgts,bskh->btkgh", w,
                       cross_v.to(q.dtype).float()).to(x.dtype)
    out = out.reshape(B, 1, cfg.num_heads * cfg.head_dim)
    return out @ p["wo"].to(x.dtype)


__all__ = ["NEG_INF", "attention_block", "decode_attention",
           "decode_cross_attention",
           "flash_attention", "init_attention", "init_cache",
           "init_paged_cache", "last_writers", "page_flat_index",
           "paged_decode_attention",
           "rotary_angles", "sequence_attention", "simple_attention"]
