"""Serving runtime for the dense, moe, ssm and hybrid kinds — the port
of ``repro/serving/engine.py``: KV and recurrent-state caches, prefill,
single-token decode, and the paged cache's chunked prefill and page-map
decode.

Cache layout: one dict per model in the stack layout of the parameters
(``layers``; the hybrid kind's ``groups`` of ``{rec_0, rec_1, attn}``
and ``tail``; the moe kind's ``groups`` of ``{dense_0, ..., moe}`` where
``moe_every > 1``), every leaf with the stack's leading axis, as in the
reference. Sliding-window archs (the hybrid kind's local attention, and
the serving-window variant of full-attention archs) keep a **ring
buffer** of ``window`` positions in the ring cache: slot = pos % window,
keys stored post-RoPE. The paged cache stores attention K/V as a page
pool ``(layers, num_pages, page_size, K, hd)`` shared by every slot
(page 0 is the dummy sink) and masks a [pos - window, pos] band instead.
Recurrent layers keep per-slot state in both caches and no pages: the
ssm kind's ``h`` (slots, H, S, P) float32 and conv contexts
``conv_x``/``conv_B``/``conv_C``, an RG-LRU layer's ``h`` (slots, w)
float32 and ``conv``.

The reference threads the cache through ``lax.scan`` and returns a new
one from every step. The port walks the layers with a Python loop over
views (``unbind``) of the stacked cache and writes each layer's K/V in
place: a restack would copy the whole cache in every decode step and
every prefill chunk. Every function that takes a cache updates it in
place and returns it. Chunk offsets, valid counts and slot indices are
Python ints (the reference traced them for one jit signature; eager
torch needs none, and a host int costs no device sync).

The moe kind routes as the reference does: a one-shot prefill with
``lengths`` and a paged chunk mask their pad tokens out of the MoE
routing (each row its own group, so a request routes as it would
alone), while both decodes route every slot of the batch, live or not,
as one group at the config's capacity factor. The dense, moe, ssm and
hybrid kinds are ported; the other kinds raise ``NotImplementedError``
naming ROADMAP.md Queue 1 item 6c. A
one-shot prefill past 2048 tokens attends through the chunked
``flash_attention`` (the reference's branch); a paged chunk attends to
its slot's gathered pages, materialized. ``use_kernel`` on
:func:`prefill` and :func:`prefill_chunk` sends every SSD scan that starts from a zero state (a one-shot prefill, a prompt's
first chunk) through the ``ssd_scan`` kernel; a later chunk carries its
slot's state and takes the plain ``ssd_chunked``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.runtime import DeviceLike, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlpm
from repro_torch.models import rglru as rgm
from repro_torch.models import ssm as ssmm
from repro_torch.models.common import (
    apply_norm, apply_rope, tree_items, tree_leaves)
from repro_torch.models.transformer import (
    _embed_tokens, _unembed, apply_ffn, attention_mode, group_layout,
    require_ported, walk_layers)

# the kinds the paged design serves (the reference's, every one ported)
PAGED_KINDS = ("dense", "moe", "ssm", "hybrid")
_CONV_LEAVES = ("conv_x", "conv_B", "conv_C")


def _require_paged(cfg) -> None:
    if cfg.kind not in PAGED_KINDS:
        raise ValueError(
            f"paged serving is token-only; arch kind {cfg.kind!r} is "
            "not served by the request schedulers")
    require_ported(cfg)


def _stack_leaves(one: dict, n: int) -> dict:
    """One layer's (or group's) cache leaves stacked on a leading axis."""
    return {k: (_stack_leaves(v, n) if isinstance(v, dict)
                else v[None].expand((n,) + v.shape).contiguous())
            for k, v in one.items()}


def _cache_tree(cfg, make: dict) -> dict:
    """The whole model's cache in the stack layout of the parameters:
    ``make[kind]()`` gives one layer's leaves for each layer kind
    ("attn", "ssm", "rec"), stacked as :func:`walk_layers` walks them."""
    layout = group_layout(cfg)
    if layout is None:
        kind = "ssm" if cfg.kind == "ssm" else "attn"
        return {"layers": _stack_leaves(make[kind](), cfg.num_layers)}
    members, n_groups, rem = layout
    tree = {}
    if n_groups:
        group = {name: make[kind]() for name, kind in members}
        tree["groups"] = _stack_leaves(group, n_groups)
    if rem:
        tree["tail"] = _stack_leaves(make["rec"](), rem)
    return tree


def _kv_pool(cfg, cache: dict):
    """The first attention stack's K leaf (its page size or ring length
    is every attention layer's), or None when the model has no
    attention layer."""
    layout = group_layout(cfg)
    if layout is None:
        return None if cfg.kind == "ssm" else cache["layers"]["k"]
    if "groups" not in cache:
        return None
    name = next(name for name, kind in layout[0] if kind == "attn")
    return cache["groups"][name]["k"]


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
    ``{"layers": {"k", "v"}}`` of ``(layers, batch, S, K, hd)`` (ssm:
    ``{"layers": {"h", "conv_x", "conv_B", "conv_C"}}``, the state;
    hybrid: ``{"groups": {"rec_0", "rec_1": {"h", "conv"}, "attn":
    {"k", "v"}}, "tail": {"h", "conv"}}``; moe with ``moe_every > 1``:
    ``{"groups": {"dense_0", ..., "moe": {"k", "v"}}}``), on ``device``
    (default: the CUDA device)."""
    require_ported(cfg)
    device = resolve_device(device)
    S = cache_len_for(cfg, seq_len, serve_window)
    return _cache_tree(cfg, {
        "attn": lambda: attn.init_cache(cfg, batch, S, dtype, device=device),
        "ssm": lambda: ssmm.init_ssm_cache(cfg, batch, dtype, device=device),
        "rec": lambda: rgm.init_rglru_cache(cfg, batch, dtype,
                                            device=device)})


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
    """Dense (or MoE) layer forward that also writes its KV ring-cache
    slice ``c`` in place; with ``lengths`` the pad tokens take no part in
    the MoE routing."""
    B, T, _ = x.shape
    h = apply_norm(cfg, lp["ln_attn"], x)
    k, v = attn._project_kv(lp["attn"], cfg, h)
    q, k = _rotate(attn._project_q(lp["attn"], cfg, h), k, rotary)
    out = attn.sequence_attention(q, k, v, mode=mode, window=window)
    out = out.reshape(B, T, cfg.num_heads * cfg.head_dim)
    x = x + out @ lp["attn"]["wo"].to(x.dtype)
    tmask = None if lengths is None else (
        torch.arange(T, device=x.device)[None, :] < lengths[:, None])
    y, _ = apply_ffn(lp, cfg, apply_norm(cfg, lp["ln_mlp"], x), tmask)
    x = x + y
    ck, cv = _ring_fill(k, v, c["k"].shape[1], c["k"].dtype, lengths)
    c["k"].copy_(ck)
    c["v"].copy_(cv)
    return x


def _conv_context(pre: torch.Tensor, n, K: int, state0=None
                  ) -> torch.Tensor:
    """The K-1 conv inputs ending before position ``n`` of the sequence
    ``[state0 | pre]`` (zeros for ``state0`` if None): the trailing
    context a causal conv continues from after ``n`` of ``pre``'s tokens.
    ``n``: a Python int, or a (B,) tensor of per-row lengths."""
    B, _, D = pre.shape
    head = (torch.zeros((B, K - 1, D), dtype=pre.dtype, device=pre.device)
            if state0 is None else state0.to(pre.dtype))
    xp = torch.cat([head, pre], dim=1)
    if isinstance(n, int):
        return xp[:, n:n + K - 1]
    idx = n.long()[:, None] + torch.arange(K - 1, device=pre.device)
    return torch.gather(xp, 1, idx[..., None].expand(B, K - 1, D))


def _prefill_ssm_layer(lp, cfg, x: torch.Tensor, c: dict, *, lengths=None,
                       use_kernel: bool = False) -> torch.Tensor:
    """SSM layer forward that also writes its state slice ``c`` in place:
    the SSD state at each row's last valid token (dt = 0 on the
    right-padded rows freezes it) and the conv contexts there."""
    B, T, _ = x.shape
    keep = None
    if lengths is not None:
        keep = (torch.arange(T, device=x.device)[None, :]
                < lengths[:, None])[..., None]
    out, h_fin, pre = ssmm.ssm_sequence(
        lp["ssm"], cfg, apply_norm(cfg, lp["ln"], x), keep=keep,
        use_kernel=use_kernel)
    n = T if lengths is None else lengths
    c["h"].copy_(h_fin)
    for name, v in zip(_CONV_LEAVES, pre):
        c[name].copy_(_conv_context(v, n, cfg.ssm_conv_width))
    return x + out


def _prefill_rec_layer(lp, cfg, x: torch.Tensor, c: dict, *,
                       lengths=None) -> torch.Tensor:
    """RG-LRU layer forward that also writes its state slice ``c`` in
    place: the state at each row's last valid token and the conv
    context there."""
    B, T, _ = x.shape
    out, hs, pre = rgm.rglru_sequence(lp["rec"],
                                      apply_norm(cfg, lp["ln_rec"], x))
    x = x + out
    x = x + mlpm.apply_mlp(lp["mlp"], cfg, apply_norm(cfg, lp["ln_mlp"], x))
    if lengths is None:
        c["h"].copy_(hs[:, -1])
        n = T
    else:
        last = torch.clamp(lengths.long() - 1, min=0)
        c["h"].copy_(hs[torch.arange(B, device=x.device), last])
        n = lengths
    c["conv"].copy_(_conv_context(pre, n, cfg.rglru_conv_width))
    return x


def prefill(p, cfg, batch, *, dtype=torch.bfloat16,
            cache_dtype=torch.bfloat16, serve_window: int = 0,
            cache_len: int | None = None, lengths=None,
            use_kernel: bool = False):
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

    ``use_kernel`` (ssm kind): the SSD scans through the ``ssd_scan``
    kernel, one launch per layer. Past 2048 tokens the attention layers
    attend through ``flash_attention``.
    """
    require_ported(cfg)
    tokens = batch["tokens"]
    B, T = tokens.shape
    device = tokens.device
    if lengths is not None:
        lengths = torch.as_tensor(lengths, dtype=torch.int32,
                                  device=device).reshape(B)
    x = _embed_tokens(p, cfg, tokens, dtype)
    cache = init_cache_tree(cfg, B, max(cache_len or 0, T), cache_dtype,
                            serve_window, device=device)
    mode, window = attention_mode(cfg, serve_window)
    rotary = (None if cfg.kind == "ssm" else
              attn.rotary_angles(cfg, torch.arange(T, device=device)))
    for kind, lp, c in walk_layers(cfg, p, cache):
        if kind == "ssm":
            x = _prefill_ssm_layer(lp, cfg, x, c, lengths=lengths,
                                   use_kernel=use_kernel)
        elif kind == "rec":
            x = _prefill_rec_layer(lp, cfg, x, c, lengths=lengths)
        else:
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

def _write_state(c: dict, new: dict, live=None) -> None:
    """A recurrent layer's new state into its cache slice, in place; with
    ``live`` (B,) bool, lanes that are not live keep their state (a slot
    mid-prefill or retired must not have its carried state trampled)."""
    for name, v in new.items():
        if live is not None:
            v = torch.where(live.reshape((-1,) + (1,) * (v.ndim - 1)), v,
                            c[name])
        c[name].copy_(v)


def _decode_layers(p, cfg, x: torch.Tensor, cache: dict, attend,
                   live=None):
    """The decode stack, every layer's cache updated in place:
    ``attend(layer attn params, normed x, layer cache)`` -> the attention
    output of an attention layer; an ssm or RG-LRU layer's state through
    :func:`_write_state`; then the logits. An MoE FFN routes all B lanes
    as one group, with no mask, as the reference does."""
    for kind, lp, c in walk_layers(cfg, p, cache):
        if kind == "ssm":
            y, new = ssmm.decode_ssm(lp["ssm"], cfg,
                                     apply_norm(cfg, lp["ln"], x), c)
            _write_state(c, new, live)
            x = x + y
            continue
        if kind == "rec":
            y, new = rgm.decode_rglru(lp["rec"], cfg,
                                      apply_norm(cfg, lp["ln_rec"], x), c)
            _write_state(c, new, live)
            x = x + y
        else:
            h = apply_norm(cfg, lp["ln_attn"], x)
            x = x + attend(lp["attn"], h, c)
        y, _ = apply_ffn(lp, cfg, apply_norm(cfg, lp["ln_mlp"], x))
        x = x + y
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
    require_ported(cfg)
    x = _embed_tokens(p, cfg, token, dtype)
    if _kv_pool(cfg, cache) is None:
        return _decode_layers(p, cfg, x, cache, None), cache
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
    ``cache_len``/``serve_window`` as the live ``cache``; every leaf
    (K/V, or the recurrent state and conv contexts) is copied along its
    batch axis (axis 1, after the stack's), cast to the live leaf's
    dtype. Optionally also writes ``one_pos`` (0-d or (1,)) into the
    per-slot ``pos`` vector, in place. Returns ``cache`` (and ``pos``
    when given).
    """
    require_ported(cfg)
    for (path, dst), (src_path, src) in zip(tree_items(cache),
                                            tree_items(one_cache)):
        assert path == src_path, (path, src_path)
        dst[:, slot:slot + 1].copy_(src)
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
    device). ``slots`` sizes the per-slot recurrent state, which has no
    pages: the ssm kind's ``{"layers": {"h", "conv_x", "conv_B",
    "conv_C"}}``, an RG-LRU layer's ``{"h", "conv"}``, each with
    ``slots`` lanes."""
    _require_paged(cfg)
    device = resolve_device(device)
    return _cache_tree(cfg, {
        "attn": lambda: attn.init_paged_cache(cfg, num_pages, page_size,
                                              dtype, device=device),
        "ssm": lambda: ssmm.init_ssm_cache(cfg, slots, dtype, device=device),
        "rec": lambda: rgm.init_rglru_cache(cfg, slots, dtype,
                                            device=device)})


def _chunk_attn_layer(lp, cfg, x: torch.Tensor, kv: dict, *, mode: str,
                      window: int, start: int, valid: int,
                      flat: torch.Tensor, src: torch.Tensor,
                      row: torch.Tensor, rotary) -> torch.Tensor:
    """One attn layer over a prefill chunk, writing K/V into pages; the
    chunk's pad rows (>= valid) take no part in the MoE routing.

    x: (1, C, d); kv: {'k','v'} page pools of this layer, updated in
    place; start/valid: the chunk offset and its number of real tokens;
    flat: (C,) pool offsets of the chunk's rows (rows >= valid point
    into the dummy page), src: each row's last writer of its offset;
    row: (pages_per_slot,) this slot's pages.
    """
    B, C, _ = x.shape
    h = apply_norm(cfg, lp["ln_attn"], x)
    k, v = attn._project_kv(lp["attn"], cfg, h)
    q, k = _rotate(attn._project_q(lp["attn"], cfg, h), k, rotary)
    attn._paged_scatter(kv, k[0], v[0], flat, src)
    ps, P = kv["k"].shape[1], row.shape[0]
    kg = kv["k"][row].reshape(1, P * ps, *kv["k"].shape[2:])
    vg = kv["v"][row].reshape(1, P * ps, *kv["v"].shape[2:])
    out = attn.simple_attention(q, kg.to(q.dtype), vg.to(q.dtype),
                                mode=mode, window=window, q_offset=start,
                                k_len=start + valid)
    out = out.reshape(B, C, cfg.num_heads * cfg.head_dim)
    x = x + out @ lp["attn"]["wo"].to(x.dtype)
    y, _ = apply_ffn(lp, cfg, apply_norm(cfg, lp["ln_mlp"], x),
                     (torch.arange(C, device=x.device) < valid)[None, :])
    return x + y


def _chunk_ssm_layer(lp, cfg, x: torch.Tensor, c: dict, *, slot: int,
                     start: int, valid: int,
                     use_kernel: bool = False) -> torch.Tensor:
    """One SSM layer over a prefill chunk, carrying the slot's state
    across chunks: the conv contexts and the SSD ``h0`` are read from (and
    written back to) lane ``slot`` of the cache leaves; ``start == 0``
    starts fresh, and only a fresh chunk's scan can take the kernel."""
    C = x.shape[1]
    lane = slice(slot, slot + 1)
    fresh = start == 0
    conv0 = None if fresh else tuple(c[k][lane] for k in _CONV_LEAVES)
    # dt = 0 freezes the recurrence on pad rows (the same trick as the
    # mixed-length one-shot prefill), so h_fin is the state at valid-1
    keep = (torch.arange(C, device=x.device) < valid)[None, :, None]
    out, h_fin, pre = ssmm.ssm_sequence(
        lp["ssm"], cfg, apply_norm(cfg, lp["ln"], x), conv0=conv0,
        keep=keep, h0=None if fresh else c["h"][lane],
        use_kernel=use_kernel and fresh)
    c["h"][lane].copy_(h_fin)
    for name, v, v0 in zip(_CONV_LEAVES, pre, conv0 or (None,) * 3):
        c[name][lane].copy_(_conv_context(v, valid, cfg.ssm_conv_width, v0))
    return x + out


def _chunk_rec_layer(lp, cfg, x: torch.Tensor, c: dict, *, slot: int,
                     start: int, valid: int) -> torch.Tensor:
    """One RG-LRU layer over a prefill chunk with the slot's carried
    (h, conv) state: the inbound state is folded into the first scan
    element (h_0 = a_0 h_in + b_0), which continues the recurrence
    exactly; ``start == 0`` starts fresh. Pad rows (>= valid) run on, and
    the state written back is the one at row valid - 1."""
    lane = slice(slot, slot + 1)
    fresh = start == 0
    conv0 = None if fresh else c["conv"][lane]
    out, hs, pre = rgm.rglru_sequence(
        lp["rec"], apply_norm(cfg, lp["ln_rec"], x), conv0=conv0,
        h0=None if fresh else c["h"][lane])
    x = x + out
    x = x + mlpm.apply_mlp(lp["mlp"], cfg, apply_norm(cfg, lp["ln_mlp"], x))
    conv1 = _conv_context(pre, valid, cfg.rglru_conv_width, conv0)
    c["h"][lane].copy_(hs[:, max(valid - 1, 0)])
    c["conv"][lane].copy_(conv1)
    return x


def prefill_chunk(p, cfg, cache: dict, tokens: torch.Tensor, start: int,
                  valid: int, page_row, slot: int, *, dtype=torch.float32,
                  serve_window: int = 0, use_kernel: bool = False):
    """Process ONE page_size-multiple chunk of a prompt into the paged
    cache (chunked prefill), in place.

    tokens: (1, C) right-padded chunk on the cache's device; start: the
    chunk's absolute offset (a page_size multiple — or the shared-prefix
    length when earlier pages came from the prefix trie); valid: the
    number of real tokens in the chunk; page_row: (pages_per_slot,) the
    slot's page ids, a host array (unused by the ssm kind, which has no
    pages); slot: the recurrent-state lane of the ssm and RG-LRU
    layers. One function
    serves single-shot prefill (C >= prompt length) and streamed long
    prompts alike. ``use_kernel`` (ssm kind): a chunk at ``start == 0``
    scans through the ``ssd_scan`` kernel, one launch per layer.

    Returns (cache, logits at token ``start + valid - 1``). The caller
    flips the slot live only after the LAST chunk — until then the
    decode-visible page-map row stays all-dummy, so interleaved decode
    ticks cannot observe a half-written prefix.
    """
    _require_paged(cfg)
    start, valid, slot = int(start), int(valid), int(slot)
    C = tokens.shape[1]
    device = tree_leaves(cache)[0].device
    pool = _kv_pool(cfg, cache)
    if pool is not None:
        ps = pool.shape[2]
        row = np.asarray(torch.as_tensor(page_row).cpu(), dtype=np.int64)
        P = row.shape[0]
        j = np.arange(C)
        tgt = start + j                              # absolute positions
        pg = row[np.clip(tgt // ps, 0, P - 1)]
        flat = np.where(j < valid, pg * ps + tgt % ps, j % ps)
        # one host-to-device copy for both index vectors
        idx = torch.as_tensor(np.concatenate([flat, row]), device=device)
        flat_t, row_t = idx[:C], idx[C:]
        src_t = attn.last_writers(flat_t)
        rotary = attn.rotary_angles(cfg,
                                    start + torch.arange(C, device=device))
    x = _embed_tokens(p, cfg, torch.as_tensor(tokens, device=device), dtype)
    mode, window = attention_mode(cfg, serve_window)
    for kind, lp, c in walk_layers(cfg, p, cache):
        if kind == "ssm":
            x = _chunk_ssm_layer(lp, cfg, x, c, slot=slot, start=start,
                                 valid=valid, use_kernel=use_kernel)
        elif kind == "rec":
            x = _chunk_rec_layer(lp, cfg, x, c, slot=slot, start=start,
                                 valid=valid)
        else:
            x = _chunk_attn_layer(lp, cfg, x, c, mode=mode, window=window,
                                  start=start, valid=valid, flat=flat_t,
                                  src=src_t, row=row_t, rotary=rotary)
    return cache, _last_logits(p, cfg, x, valid)


def _last_logits(p, cfg, x: torch.Tensor, valid: int) -> torch.Tensor:
    """The logits at a chunk's last real token."""
    x = apply_norm(cfg, p["ln_final"], x)
    last = max(valid - 1, 0)
    return _unembed(p, cfg, x[:, last:last + 1])


def decode_step_paged(p, cfg, token: torch.Tensor, cache: dict,
                      pos: torch.Tensor, page_map: torch.Tensor,
                      live: torch.Tensor, *, dtype=torch.bfloat16,
                      serve_window: int = 0, use_kernel: bool = False):
    """One-token generation step against the PAGED cache, in place.

    token: (B, 1); cache: tree from init_paged_cache_tree; pos: (B,)
    int32; page_map: (B, pages_per_slot) int32 (dummy rows for inactive
    slots), all on the cache's device; live: (B,) bool — it gates the
    recurrent-state updates (ssm and RG-LRU layers); a non-live lane's
    attention write lands in the dummy page through its page-map row.
    ``use_kernel``: attention through the ``paged_decode`` wrapper, one
    launch per attention layer (the ssm kind has no attention and
    ignores it; the hybrid kind's attention layers mask the window band
    of ``attention_window``).
    Returns (logits, cache).
    """
    _require_paged(cfg)
    x = _embed_tokens(p, cfg, token, dtype)
    pool = _kv_pool(cfg, cache)
    if pool is None:
        return _decode_layers(p, cfg, x, cache, None, live=live), cache
    pos = pos.reshape(-1).expand(token.shape[0])
    w = effective_window(cfg, serve_window)
    # the write offsets, their source rows and the RoPE angles, once for
    # all layers
    flat = attn.page_flat_index(page_map, pos, pool.shape[2])
    src = attn.last_writers(flat)
    rotary = attn.rotary_angles(cfg, pos[:, None])

    def attend(ap, h, c):
        return attn.paged_decode_attention(
            ap, cfg, h, c, pos, page_map, window=w, use_kernel=use_kernel,
            flat=flat, src=src, rotary=rotary)[0]

    return _decode_layers(p, cfg, x, cache, attend, live=live), cache


__all__ = ["PAGED_KINDS", "cache_len_for", "decode_step",
           "decode_step_paged", "effective_window", "init_cache_tree",
           "init_paged_cache_tree", "prefill", "prefill_chunk",
           "write_cache_slot"]
