"""Serving runtime for the dense kind — the port of
``repro/serving/engine.py``: KV caches, prefill, single-token decode,
and the paged cache's chunked prefill and page-map decode.

Cache layout: one dict per model whose leaves carry a leading ``layers``
axis, as in the reference. Sliding-window archs (and the serving-window
variant of full-attention archs) keep a **ring buffer** of ``window``
positions in the ring cache: slot = pos % window, keys stored post-RoPE.
The paged cache stores attention K/V as a page pool ``(layers,
num_pages, page_size, K, hd)`` shared by every slot (page 0 is the dummy
sink) and masks a [pos - window, pos] band instead.

The reference threads the cache through ``lax.scan`` and returns a new
one from every step. The port walks the layers with a Python loop over
views (``unbind``) of the stacked cache and writes each layer's K/V in
place: a restack would copy the whole cache in every decode step and
every prefill chunk. Every function that takes a cache updates it in
place and returns it. Chunk offsets, valid counts and slot indices are
Python ints (the reference traced them for one jit signature; eager
torch needs none, and a host int costs no device sync).

Only the dense kind is ported; the other kinds raise
``NotImplementedError`` naming ROADMAP.md Queue 1 item 6. Prefill up to
2048 tokens (the materialized attention; the chunked flash path comes
with item 6).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.runtime import DeviceLike, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlpm
from repro_torch.models.common import apply_norm, apply_rope
from repro_torch.models.transformer import _embed_tokens, _unembed, _unstack

# the kinds the paged design serves (the reference's); the port runs dense
PAGED_KINDS = ("dense", "moe", "ssm", "hybrid")
_MAX_PREFILL = 2048            # the materialized attention's limit


def _require_dense(cfg) -> None:
    if cfg.kind != "dense":
        raise NotImplementedError(
            f"{cfg.name}: the port serves the dense kind only; the "
            f"{cfg.kind!r} kind is not ported yet (ROADMAP.md Queue 1 "
            "item 6)")


def _require_paged(cfg) -> None:
    if cfg.kind not in PAGED_KINDS:
        raise ValueError(
            f"paged serving is token-only; arch kind {cfg.kind!r} is "
            "not served by the request schedulers")
    _require_dense(cfg)


def _mode_window(cfg, serve_window: int) -> tuple[str, int]:
    if cfg.sliding_window:
        return "sliding", cfg.sliding_window
    if serve_window:
        return "sliding", serve_window
    return "causal", 0


def _layers(cfg, p, cache) -> zip:
    """(layer params, layer cache) views, layer by layer."""
    n = cfg.num_layers
    return zip(_unstack(p["layers"], n), _unstack(cache["layers"], n))


def _stacked(one: dict, n: int) -> dict:
    """One layer's cache leaves stacked on a leading ``layers`` axis."""
    return {"layers": {k: v[None].expand((n,) + v.shape).contiguous()
                       for k, v in one.items()}}


# ---------------------------------------------------------------------------
# cache construction
# ---------------------------------------------------------------------------

def effective_window(cfg, serve_window: int = 0) -> int:
    """The serving attention window: the arch's own sliding window, the
    hybrid local-attention window, or a serving-variant override."""
    if cfg.kind == "hybrid":
        return cfg.attention_window
    if cfg.sliding_window:
        return cfg.sliding_window
    return serve_window


def cache_len_for(cfg, seq_len: int, serve_window: int = 0) -> int:
    w = effective_window(cfg, serve_window)
    return min(seq_len, w) if w else seq_len


def init_cache_tree(cfg, batch: int, seq_len: int, dtype=torch.bfloat16,
                    serve_window: int = 0, *, device: DeviceLike = None
                    ) -> dict:
    """Ring-cache tree for the whole model, every layer stacked:
    ``{"layers": {"k", "v"}}`` of ``(layers, batch, S, K, hd)``, on
    ``device`` (default: the CUDA device)."""
    _require_dense(cfg)
    S = cache_len_for(cfg, seq_len, serve_window)
    return _stacked(attn.init_cache(cfg, batch, S, dtype,
                                    device=resolve_device(device)),
                    cfg.num_layers)


# ---------------------------------------------------------------------------
# prefill (ring cache)
# ---------------------------------------------------------------------------

def _ring_fill(k_all: torch.Tensor, v_all: torch.Tensor, S: int, dtype,
               lengths=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Place the last S tokens of (B, T, K, hd) into ring slots t % S.

    With per-request ``lengths`` (B,), each row i keeps the last S of its
    own ``lengths[i]`` valid (right-aligned) tokens; ring slots that no
    valid token maps to are zeroed, so padded prefixes never enter the
    cache.
    """
    B, T = k_all.shape[:2]
    if lengths is None:
        if T <= S:
            pad = (0, 0, 0, 0, 0, S - T)
            return (torch.nn.functional.pad(k_all, pad).to(dtype),
                    torch.nn.functional.pad(v_all, pad).to(dtype))
        idx = T - S + torch.arange(S, device=k_all.device)
        slots = idx % S
        k = torch.zeros((B, S) + k_all.shape[2:], dtype=dtype,
                        device=k_all.device)
        v = torch.zeros_like(k)
        k[:, slots] = k_all[:, idx].to(dtype)
        v[:, slots] = v_all[:, idx].to(dtype)
        return k, v
    # largest valid token index t with t = s (mod S), per row
    s = torch.arange(S, device=k_all.device)[None, :]        # (1, S)
    t = s + S * torch.div(lengths.long()[:, None] - 1 - s, S,
                          rounding_mode="floor")             # (B, S)
    valid = (t >= 0)[..., None, None]
    rows = torch.arange(B, device=k_all.device)[:, None]
    idx = torch.clamp(t, 0, T - 1)
    k = torch.where(valid, k_all[rows, idx], 0)
    v = torch.where(valid, v_all[rows, idx], 0)
    return k.to(dtype), v.to(dtype)


def _rotate(q: torch.Tensor, k: torch.Tensor, rotary):
    """RoPE on a sequence's queries (B, T, K, G, hd) and keys (B, T, K,
    hd) with precomputed angles."""
    if rotary is None:
        return q, k
    B, T = q.shape[:2]
    qr = apply_rope(q.reshape(B, T, -1, q.shape[-1]), *rotary)
    return qr.reshape(q.shape), apply_rope(k, *rotary)


def _prefill_attn_layer(lp, cfg, x: torch.Tensor, c: dict, *, mode: str,
                        window: int, rotary, lengths=None) -> torch.Tensor:
    """Dense layer forward that also writes its KV ring-cache slice
    ``c`` in place."""
    B, T, _ = x.shape
    h = apply_norm(cfg, lp["ln_attn"], x)
    k, v = attn._project_kv(lp["attn"], cfg, h)
    q, k = _rotate(attn._project_q(lp["attn"], cfg, h), k, rotary)
    out = attn.simple_attention(q, k, v, mode=mode, window=window)
    out = out.reshape(B, T, cfg.num_heads * cfg.head_dim)
    x = x + out @ lp["attn"]["wo"].to(x.dtype)
    h = apply_norm(cfg, lp["ln_mlp"], x)
    x = x + mlpm.apply_mlp(lp["mlp"], cfg, h)
    ck, cv = _ring_fill(k, v, c["k"].shape[1], c["k"].dtype, lengths)
    c["k"].copy_(ck)
    c["v"].copy_(cv)
    return x


def prefill(p, cfg, batch, *, dtype=torch.bfloat16,
            cache_dtype=torch.bfloat16, serve_window: int = 0,
            cache_len: int | None = None, lengths=None):
    """Process the full prompt; return (last-token logits, cache, pos).

    batch: {"tokens": (B, T) int tensor on the parameters' device}.
    ``cache_len``: total cache capacity to allocate (>= prompt length;
    defaults to the prompt length — pass the generation horizon).

    ``lengths``: optional (B,) per-request prompt lengths for
    mixed-length batches. Prompts must then be RIGHT-padded: real
    queries never attend to pad keys under the causal/sliding masks, and
    pad positions never enter the KV cache. The returned logits are
    taken at each row's last valid token and ``pos`` is a per-slot (B,)
    int32 vector (a 0-d int32 tensor when ``lengths`` is None).
    """
    _require_dense(cfg)
    tokens = batch["tokens"]
    B, T = tokens.shape
    if T > _MAX_PREFILL:
        raise NotImplementedError(
            f"a {T}-token prefill needs the chunked flash_attention, which "
            "is not ported yet (ROADMAP.md Queue 1 item 6)")
    device = tokens.device
    if lengths is not None:
        lengths = torch.as_tensor(lengths, dtype=torch.int32,
                                  device=device).reshape(B)
    x = _embed_tokens(p, cfg, tokens, dtype)
    mode, window = _mode_window(cfg, serve_window)
    cache = init_cache_tree(cfg, B, max(cache_len or 0, T), cache_dtype,
                            serve_window, device=device)
    rotary = attn.rotary_angles(cfg, torch.arange(T, device=device))
    for lp, c in _layers(cfg, p, cache):
        x = _prefill_attn_layer(lp, cfg, x, c, mode=mode, window=window,
                                rotary=rotary, lengths=lengths)
    x = apply_norm(cfg, p["ln_final"], x)
    if lengths is None:
        logits = _unembed(p, cfg, x[:, -1:])
        return logits, cache, torch.full((), T, dtype=torch.int32,
                                          device=device)
    # per-slot: logits at each row's last valid token, (B,) positions
    last = torch.clamp(lengths.long() - 1, min=0)
    x_last = x[torch.arange(B, device=device), last][:, None]
    return _unembed(p, cfg, x_last), cache, lengths


# ---------------------------------------------------------------------------
# decode step (ring cache)
# ---------------------------------------------------------------------------

def _decode_layers(p, cfg, x: torch.Tensor, cache: dict, attend):
    """The dense decode stack: ``attend(layer attn params, normed x,
    layer cache)`` -> attention output; then the MLP; then the logits."""
    for lp, c in _layers(cfg, p, cache):
        h = apply_norm(cfg, lp["ln_attn"], x)
        x = x + attend(lp["attn"], h, c)
        h = apply_norm(cfg, lp["ln_mlp"], x)
        x = x + mlpm.apply_mlp(lp["mlp"], cfg, h)
    x = apply_norm(cfg, p["ln_final"], x)
    return _unembed(p, cfg, x)


def decode_step(p, cfg, token: torch.Tensor, cache: dict, pos, *,
                dtype=torch.bfloat16, serve_window: int = 0):
    """One-token generation step.

    token: (B, 1) int; cache: tree from init_cache_tree/prefill, updated
    in place; pos: int32 absolute position — a 0-d tensor (all slots
    aligned) or a ``(B,)`` vector of per-slot positions (continuous
    batching). Returns (logits, cache).
    """
    _require_dense(cfg)
    x = _embed_tokens(p, cfg, token, dtype)
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    pos = pos.reshape(-1).expand(token.shape[0])
    w = effective_window(cfg, serve_window)
    rotary = attn.rotary_angles(cfg, pos[:, None])

    def attend(ap, h, c):
        ring = w if (c["k"].shape[1] == w and w) else 0
        return attn.decode_attention(ap, cfg, h, c, pos, window=ring,
                                     rotary=rotary)[0]

    return _decode_layers(p, cfg, x, cache, attend), cache


# ---------------------------------------------------------------------------
# slot-indexed cache writes (continuous batching)
# ---------------------------------------------------------------------------

def write_cache_slot(cfg, cache: dict, one_cache: dict, slot: int, *,
                     pos=None, one_pos=None):
    """Write a single-request cache into slot ``slot`` of a live batch,
    in place.

    ``one_cache`` comes from a batch-1 :func:`prefill` with the same
    ``cache_len``/``serve_window`` as the live ``cache``; every leaf is
    copied along its batch axis (axis 1, after ``layers``). Optionally
    also writes ``one_pos`` (0-d or (1,)) into the per-slot ``pos``
    vector, in place. Returns ``cache`` (and ``pos`` when given).
    """
    _require_dense(cfg)
    for name, dst in cache["layers"].items():
        dst[:, slot:slot + 1].copy_(one_cache["layers"][name])
    if pos is None:
        return cache
    pos[slot] = torch.as_tensor(one_pos).reshape(())
    return cache, pos


# ---------------------------------------------------------------------------
# paged cache: attention K/V in a shared page pool; chunked prefill +
# page-map decode
# ---------------------------------------------------------------------------

def init_paged_cache_tree(cfg, slots: int, num_pages: int, page_size: int,
                          dtype=torch.bfloat16, *,
                          device: DeviceLike = None) -> dict:
    """Paged-cache tree: attention K/V leaves become a page pool
    ``(layers, num_pages, page_size, K, hd)`` shared by all slots (page 0
    reserved as the dummy sink), on ``device`` (default: the CUDA
    device). ``slots`` sizes the per-slot recurrent state of the kinds
    that have one, none of which is ported yet."""
    _require_paged(cfg)
    return _stacked(attn.init_paged_cache(cfg, num_pages, page_size, dtype,
                                          device=resolve_device(device)),
                    cfg.num_layers)


def _chunk_attn_layer(lp, cfg, x: torch.Tensor, kv: dict, *, mode: str,
                      window: int, start: int, valid: int,
                      flat: torch.Tensor, row: torch.Tensor,
                      rotary) -> torch.Tensor:
    """One attn layer over a prefill chunk, writing K/V into pages.

    x: (1, C, d); kv: {'k','v'} page pools of this layer, updated in
    place; start/valid: the chunk offset and its number of real tokens;
    flat: (C,) pool offsets of the chunk's rows (rows >= valid point
    into the dummy page); row: (pages_per_slot,) this slot's pages.
    """
    B, C, _ = x.shape
    h = apply_norm(cfg, lp["ln_attn"], x)
    k, v = attn._project_kv(lp["attn"], cfg, h)
    q, k = _rotate(attn._project_q(lp["attn"], cfg, h), k, rotary)
    attn._paged_scatter(kv, k[0], v[0], flat)
    ps, P = kv["k"].shape[1], row.shape[0]
    kg = kv["k"][row].reshape(1, P * ps, *kv["k"].shape[2:])
    vg = kv["v"][row].reshape(1, P * ps, *kv["v"].shape[2:])
    out = attn.simple_attention(q, kg.to(q.dtype), vg.to(q.dtype),
                                mode=mode, window=window, q_offset=start,
                                k_len=start + valid)
    out = out.reshape(B, C, cfg.num_heads * cfg.head_dim)
    x = x + out @ lp["attn"]["wo"].to(x.dtype)
    h = apply_norm(cfg, lp["ln_mlp"], x)
    return x + mlpm.apply_mlp(lp["mlp"], cfg, h)


def prefill_chunk(p, cfg, cache: dict, tokens: torch.Tensor, start: int,
                  valid: int, page_row, slot: int, *, dtype=torch.float32,
                  serve_window: int = 0):
    """Process ONE page_size-multiple chunk of a prompt into the paged
    cache (chunked prefill), in place.

    tokens: (1, C) right-padded chunk on the cache's device; start: the
    chunk's absolute offset (a page_size multiple — or the shared-prefix
    length when earlier pages came from the prefix trie); valid: the
    number of real tokens in the chunk; page_row: (pages_per_slot,) the
    slot's page ids, a host array; slot: the recurrent-state lane (no
    ported kind has one). One function serves single-shot prefill
    (C >= prompt length) and streamed long prompts alike.

    Returns (cache, logits at token ``start + valid - 1``). The caller
    flips the slot live only after the LAST chunk — until then the
    decode-visible page-map row stays all-dummy, so interleaved decode
    ticks cannot observe a half-written prefix.
    """
    _require_paged(cfg)
    start, valid = int(start), int(valid)
    C = tokens.shape[1]
    device = cache["layers"]["k"].device
    ps = cache["layers"]["k"].shape[2]
    row = np.asarray(torch.as_tensor(page_row).cpu(), dtype=np.int64)
    P = row.shape[0]
    j = np.arange(C)
    tgt = start + j                                  # absolute positions
    pg = row[np.clip(tgt // ps, 0, P - 1)]
    flat = np.where(j < valid, pg * ps + tgt % ps, j % ps)
    # one host-to-device copy for both index vectors
    idx = torch.as_tensor(np.concatenate([flat, row]), device=device)
    flat_t, row_t = idx[:C], idx[C:]
    x = _embed_tokens(p, cfg, torch.as_tensor(tokens, device=device), dtype)
    mode, window = _mode_window(cfg, serve_window)
    rotary = attn.rotary_angles(cfg, start + torch.arange(C, device=device))
    for lp, c in _layers(cfg, p, cache):
        x = _chunk_attn_layer(lp, cfg, x, c, mode=mode, window=window,
                              start=start, valid=valid, flat=flat_t,
                              row=row_t, rotary=rotary)
    x = apply_norm(cfg, p["ln_final"], x)
    last = max(valid - 1, 0)
    return cache, _unembed(p, cfg, x[:, last:last + 1])


def decode_step_paged(p, cfg, token: torch.Tensor, cache: dict,
                      pos: torch.Tensor, page_map: torch.Tensor,
                      live: torch.Tensor, *, dtype=torch.bfloat16,
                      serve_window: int = 0, use_kernel: bool = False):
    """One-token generation step against the PAGED cache, in place.

    token: (B, 1); cache: tree from init_paged_cache_tree; pos: (B,)
    int32; page_map: (B, pages_per_slot) int32 (dummy rows for inactive
    slots), all on the cache's device; live: (B,) bool — it gates the
    recurrent-state updates of the kinds that have them (none ported);
    a non-live lane's attention write lands in the dummy page through
    its page-map row. ``use_kernel``: attention through the
    ``paged_decode`` wrapper, one launch per layer. Returns (logits,
    cache).
    """
    _require_paged(cfg)
    x = _embed_tokens(p, cfg, token, dtype)
    pos = pos.reshape(-1).expand(token.shape[0])
    w = effective_window(cfg, serve_window)
    # the write offsets and the RoPE angles, once for all layers
    flat = attn.page_flat_index(page_map, pos, cache["layers"]["k"].shape[2])
    rotary = attn.rotary_angles(cfg, pos[:, None])

    def attend(ap, h, c):
        return attn.paged_decode_attention(
            ap, cfg, h, c, pos, page_map, window=w, use_kernel=use_kernel,
            flat=flat, rotary=rotary)[0]

    return _decode_layers(p, cfg, x, cache, attend), cache


__all__ = ["PAGED_KINDS", "cache_len_for", "decode_step",
           "decode_step_paged", "effective_window", "init_cache_tree",
           "init_paged_cache_tree", "prefill", "prefill_chunk",
           "write_cache_slot"]
