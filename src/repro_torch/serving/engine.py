"""Serving runtime for every arch kind — the port of
``repro/serving/engine.py``: KV and recurrent-state caches, prefill,
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
float32 and ``conv``. A decoder layer of the encdec and audio kinds
adds ``cross_k``/``cross_v`` (B, enc_seq_len, K, hd) to its ring cache:
the encoder output's keys and values, written once by the prefill and
only read by the decode's cross-attention step.

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
as one group at the config's capacity factor. The vlm kind's prefill
puts the stub patch embeddings (``batch["patches"]``) before the
prompt under the prefix mask, so its cache, RoPE positions and ``pos``
count the prefix; the encdec and audio kinds' prefill runs the encoder
over ``batch["frames"]`` once, and their decode adds each slot's
sinusoidal position. Under ``serve_window`` both keep the reference's
prefill masks (the vlm prefix mask and the audio causal mask, at window
0) while the ring decode slides. The paged cache and the request
schedulers serve tokens only and refuse these three kinds, as the
reference's do. A
one-shot prefill past 2048 tokens attends through the chunked
``flash_attention`` (the reference's branch); a paged chunk attends to
its slot's gathered pages, materialized. ``use_kernel`` on
:func:`prefill` and :func:`prefill_chunk` sends every SSD scan that starts from a zero state (a one-shot prefill, a prompt's
first chunk) through the ``ssd_scan`` kernel; a later chunk carries its
slot's state and takes the plain ``ssd_chunked``.

Under a mesh (:func:`repro_torch.dist.use_mesh`, the params DTensors
from ``serving.sharding.shard_params``) the same functions serve
sharded: caches are made as DTensors placed by the serve cache rules,
the reference's ``hint`` calls redistribute the activations, and what
DTensor has no strategy for runs on each rank's shard
(:func:`repro_torch.dist.sharding.on_shards`): the ring fill, the
attention steps with their in-place cache writes, the paged scatter and
``paged_decode``, the SSD scan, per-row gathers. A slot write keeps the
live placement (only the ranks holding the slot write;
:func:`~repro_torch.dist.sharding.write_rows`), and a chunk reads a
data-sharded slot's state from the rank that holds it
(:func:`~repro_torch.dist.sharding.read_rows`), never the whole leaf.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.dist.sharding import (
    ambient_mesh, hint, is_dtensor, keep_dims, local, on_shards, placements,
    read_rows, with_dims, write_rows)
from repro_torch.kernels.runtime import DeviceLike, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlpm
from repro_torch.models import rglru as rgm
from repro_torch.models import ssm as ssmm
from repro_torch.models.common import (
    apply_norm, apply_rope, tree_from_items, tree_items, tree_leaves)
from repro_torch.models.transformer import (
    ENCODER_KINDS, _embed_tokens, _unembed, apply_cross, apply_ffn,
    attention_mode, embed_inputs, group_layout, walk_layers)

# the kinds the paged design serves (the reference's, every one ported)
PAGED_KINDS = ("dense", "moe", "ssm", "hybrid")
_CONV_LEAVES = ("conv_x", "conv_B", "conv_C")


def _require_paged(cfg) -> None:
    if cfg.kind not in PAGED_KINDS:
        raise ValueError(
            f"paged serving is token-only; arch kind {cfg.kind!r} is "
            "not served by the request schedulers")


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


def _axes_tree(cfg, make: dict) -> dict:
    """Logical axes in the layout of :func:`_cache_tree`: each leaf's
    axes from ``make[kind]()`` behind the stack's ``layers`` axis."""
    def stacked(d):
        return {k: stacked(v) if isinstance(v, dict)
                else ("layers",) + tuple(v) for k, v in d.items()}

    layout = group_layout(cfg)
    if layout is None:
        kind = "ssm" if cfg.kind == "ssm" else "attn"
        return {"layers": stacked(make[kind]())}
    members, n_groups, rem = layout
    tree = {}
    if n_groups:
        tree["groups"] = stacked({name: make[kind]()
                                  for name, kind in members})
    if rem:
        tree["tail"] = stacked(make["rec"]())
    return tree


def _placed(tree: dict, axes: dict, mesh, cache_rules) -> dict:
    """A tree of ``meta`` leaves as zero DTensors on ``mesh``, each leaf
    placed by ``spec_for_shape`` of its logical axes under
    ``cache_rules`` (default ``SERVE_CACHE_RULES``): every rank allocates
    its own shard only."""
    from torch.distributed.tensor import zeros

    from repro_torch.serving.sharding import SERVE_CACHE_RULES
    rules = cache_rules or SERVE_CACHE_RULES
    out = []
    for (path, leaf), (apath, ax) in zip(tree_items(tree),
                                         tree_items(axes)):
        assert path == apath, (path, apath)
        pl = placements(rules.spec_for_shape(tuple(ax), tuple(leaf.shape),
                                             mesh), mesh)
        out.append((path, zeros(tuple(leaf.shape), dtype=leaf.dtype,
                                device_mesh=mesh, placements=pl)))
    return tree_from_items(out)


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
                    serve_window: int = 0, *, device: DeviceLike = None,
                    mesh=None, cache_rules=None) -> dict:
    """Ring-cache tree for the whole model, every layer stacked:
    ``{"layers": {"k", "v"}}`` of ``(layers, batch, S, K, hd)`` (ssm:
    ``{"layers": {"h", "conv_x", "conv_B", "conv_C"}}``, the state;
    hybrid: ``{"groups": {"rec_0", "rec_1": {"h", "conv"}, "attn":
    {"k", "v"}}, "tail": {"h", "conv"}}``; moe with ``moe_every > 1``:
    ``{"groups": {"dense_0", ..., "moe": {"k", "v"}}}``; encdec and
    audio: ``{"layers": {"k", "v", "cross_k", "cross_v"}}``, the cross
    leaves ``(layers, batch, enc_seq_len, K, hd)``), on ``device``
    (default: the CUDA device).

    With ``mesh``, every leaf is a DTensor placed by its
    :func:`cache_logical_axes_tree` axes under ``cache_rules`` (default
    ``SERVE_CACHE_RULES`` — heads over ``model``, the sequence as the
    fallback, slots over the replica axes), so the live batch starts
    sharded and every later write keeps that placement."""
    if mesh is not None:
        return _placed(init_cache_tree(cfg, batch, seq_len, dtype,
                                       serve_window, device="meta"),
                       cache_logical_axes_tree(cfg), mesh, cache_rules)
    device = resolve_device(device)
    S = cache_len_for(cfg, seq_len, serve_window)

    def attn_cache():
        c = attn.init_cache(cfg, batch, S, dtype, device=device)
        if cfg.kind in ENCODER_KINDS:
            cross = attn.init_cache(cfg, batch, cfg.enc_seq_len, dtype,
                                    device=device)
            c["cross_k"], c["cross_v"] = cross["k"], cross["v"]
        return c

    return _cache_tree(cfg, {
        "attn": attn_cache,
        "ssm": lambda: ssmm.init_ssm_cache(cfg, batch, dtype, device=device),
        "rec": lambda: rgm.init_rglru_cache(cfg, batch, dtype,
                                            device=device)})


def cache_logical_axes_tree(cfg) -> dict:
    """Logical axes matching :func:`init_cache_tree`'s structure."""
    def attn_axes():
        d = attn.cache_logical_axes()
        if cfg.kind in ENCODER_KINDS:
            d["cross_k"] = ("cache_batch", None, "cache_kv_heads",
                            "head_dim")
            d["cross_v"] = ("cache_batch", None, "cache_kv_heads",
                            "head_dim")
        return d

    return _axes_tree(cfg, {
        "attn": attn_axes,
        "ssm": lambda: ssmm.ssm_cache_logical_axes(cfg),
        "rec": lambda: rgm.rglru_cache_logical_axes(cfg)})


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


def _ring_fill_sharded(k_all, v_all, S: int, dtype, lengths=None):
    """:func:`_ring_fill` on each rank's slots and heads (T unsharded)."""
    def where(_):
        pl = with_dims(k_all.placements, {1: None})
        return (pl, pl, None if lengths is None
                else keep_dims(pl, (0,))), (pl, pl)

    return on_shards(lambda k, v, n: _ring_fill(k, v, S, dtype, n),
                     (k_all, v_all, lengths), where)


def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[b, idx[b]]`` for every row b: (B, T, ...) -> (B, ...)."""
    def take(x, idx):
        return x[torch.arange(x.shape[0], device=x.device), idx.long()]

    def where(_):
        pl = with_dims(x.placements, {1: None})
        return ((pl, keep_dims(pl, (0,))),
                with_dims(pl, {d: d - 1 for d in range(2, x.ndim)}))

    return on_shards(take, (x, idx), where)


def _rotate(q: torch.Tensor, k: torch.Tensor, rotary):
    """RoPE on a sequence's queries (B, T, K, G, hd) and keys (B, T, K,
    hd) with precomputed angles."""
    if rotary is None:
        return q, k
    B, T = q.shape[:2]
    qr = apply_rope(q.reshape(B, T, -1, q.shape[-1]), *rotary)
    return qr.reshape(q.shape), apply_rope(k, *rotary)


def _prefill_attn_layer(lp, cfg, x: torch.Tensor, c: dict, *, mode: str,
                        window: int, rotary, lengths=None, prefix_len=None,
                        enc_out=None) -> torch.Tensor:
    """Dense (or MoE) layer forward that also writes its KV ring-cache
    slice ``c`` in place; with ``lengths`` the pad tokens take no part in
    the MoE routing. A decoder layer with ``cross`` attends to
    ``enc_out`` and writes the encoder's keys and values into
    ``cross_k``/``cross_v``."""
    x = hint(x, ("pod", "data"), None, None)    # as the model's layers
    B, T, _ = x.shape
    h = apply_norm(cfg, lp["ln_attn"], x)
    k, v = attn._project_kv(lp["attn"], cfg, h)
    q = attn._project_q(lp["attn"], cfg, h)
    q = hint(q, ("pod", "data"), None, "model", None, None)
    k = hint(k, ("pod", "data"), None, "model", None)
    v = hint(v, ("pod", "data"), None, "model", None)
    q, k = _rotate(q, k, rotary)
    # pin the attention inputs AFTER rope: otherwise the cache output's
    # placement propagates backwards into the attention
    q = hint(q, ("pod", "data"), None, "model", None, None)
    k = hint(k, ("pod", "data"), None, "model", None)
    v = hint(v, ("pod", "data"), None, "model", None)
    out = attn.sequence_attention(q, k, v, mode=mode, window=window,
                                  prefix_len=prefix_len)
    out = out.reshape(B, T, cfg.num_heads * cfg.head_dim)
    x = apply_cross(lp, cfg, x + out @ lp["attn"]["wo"].to(x.dtype),
                    enc_out)
    if "cross" in lp:
        ek, ev = attn._project_kv(lp["cross"], cfg, enc_out)
        c["cross_k"].copy_(ek)
        c["cross_v"].copy_(ev)
    tmask = None if lengths is None else (
        torch.arange(T, device=x.device)[None, :] < lengths[:, None])
    y, _ = apply_ffn(lp, cfg, apply_norm(cfg, lp["ln_mlp"], x), tmask)
    x = x + y
    ck, cv = _ring_fill_sharded(k, v, c["k"].shape[1], c["k"].dtype,
                                lengths)
    c["k"].copy_(ck)
    c["v"].copy_(cv)
    return x


def _conv_context(pre: torch.Tensor, n, K: int, state0=None
                  ) -> torch.Tensor:
    """The K-1 conv inputs ending before position ``n`` of the sequence
    ``[state0 | pre]`` (zeros for ``state0`` if None): the trailing
    context a causal conv continues from after ``n`` of ``pre``'s tokens.
    ``n``: a Python int, or a (B,) tensor of per-row lengths."""
    if is_dtensor(pre) and not isinstance(n, int):
        pl = with_dims(pre.placements, {1: None})
        return on_shards(lambda x, n, s0: _conv_context(x, n, K, s0),
                         (pre, n, state0),
                         lambda _: ((pl, keep_dims(pl, (0,)),
                                     None if state0 is None else pl), pl))
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
    x = hint(x, ("pod", "data"), None, None)    # as the model's layers
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
    x = hint(x, ("pod", "data"), None, None)    # as the model's layers
    B, T, _ = x.shape
    out, hs, pre = rgm.rglru_sequence(lp["rec"],
                                      apply_norm(cfg, lp["ln_rec"], x))
    x = x + out
    x = x + mlpm.apply_mlp(lp["mlp"], cfg, apply_norm(cfg, lp["ln_mlp"], x))
    if lengths is None:
        c["h"].copy_(hs[:, -1])
        n = T
    else:
        c["h"].copy_(_take_rows(hs, torch.clamp(lengths.long() - 1, min=0)))
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
    kernel, one launch per layer. Past 2048 positions (the vlm kind's
    patches counted) the attention layers attend through
    ``flash_attention``.

    The frontends, as the reference's: the vlm kind's ``patches`` (B,
    enc_seq_len, d) go before the prompt under the prefix mask; the
    cache holds ``max(cache_len, enc_seq_len + T)`` positions, the RoPE
    angles run over patches and prompt, ``lengths`` are shifted by the
    prefix and the returned ``pos`` is ``enc_seq_len + T`` (a slot's
    ``enc_seq_len + lengths``). The encdec and audio kinds' ``frames``
    (B, enc_seq_len, d) run through the encoder once; the prompt gets
    its sinusoidal positions and every decoder layer's ``cross_k``/
    ``cross_v`` are written in ``cache_dtype``.
    """
    tokens = batch["tokens"]
    B, T = tokens.shape
    device = tokens.device
    # the frontends' masks keep window 0 under serve_window, as the
    # reference's do (only the ring decode slides)
    x, mask, enc_out = embed_inputs(p, cfg, batch, dtype)
    mode, window, prefix_len = mask or (*attention_mode(cfg, serve_window),
                                        None)
    L = x.shape[1]                           # T plus the vlm prefix
    if lengths is not None:
        lengths = torch.as_tensor(lengths, dtype=torch.int32,
                                  device=device).reshape(B) + (L - T)
    cache = init_cache_tree(cfg, B, max(cache_len or 0, L), cache_dtype,
                            serve_window, device=device, mesh=ambient_mesh())
    rotary = (None if cfg.kind == "ssm" else
              attn.rotary_angles(cfg, torch.arange(L, device=device)))
    for kind, lp, c in walk_layers(cfg, p, cache):
        if kind == "ssm":
            x = _prefill_ssm_layer(lp, cfg, x, c, lengths=lengths,
                                   use_kernel=use_kernel)
        elif kind == "rec":
            x = _prefill_rec_layer(lp, cfg, x, c, lengths=lengths)
        else:
            x = _prefill_attn_layer(lp, cfg, x, c, mode=mode, window=window,
                                    rotary=rotary, lengths=lengths,
                                    prefix_len=prefix_len, enc_out=enc_out)
    x = apply_norm(cfg, p["ln_final"], x)
    if lengths is None:
        logits = _unembed(p, cfg, x[:, -1:])
        return logits, cache, torch.full((), L, dtype=torch.int32,
                                          device=device)
    # per-slot: logits at each row's last valid token, (B,) positions
    x_last = _take_rows(x, torch.clamp(lengths.long() - 1, min=0))[:, None]
    return _unembed(p, cfg, x_last), cache, lengths


# ---------------------------------------------------------------------------
# decode step (ring cache)
# ---------------------------------------------------------------------------

def _slot_sinusoid(d: int, pos: torch.Tensor) -> torch.Tensor:
    """Each slot's sinusoidal decoder position (B, 1, d), float32, as the
    reference's decode step builds it: its ``log(10000)`` taken in
    float32 (the forward's :func:`~repro_torch.models.common.
    sinusoidal_positions` rounds it from float64)."""
    half = d // 2
    c = -torch.log(torch.tensor(10_000.0, dtype=torch.float32,
                                device=pos.device))
    freq = torch.exp(c * torch.arange(half, dtype=torch.float32,
                                      device=pos.device) / max(half - 1, 1))
    ang = pos.float()[:, None] * freq                    # (B, half)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)[:, None]


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
    output of an attention layer, followed, in a decoder layer with
    ``cross``, by the cross-attention step over its cached ``cross_k``/
    ``cross_v``; an ssm or RG-LRU layer's state through
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
            if "cross" in lp:
                h = apply_norm(cfg, lp["ln_cross"], x)
                x = x + attn.decode_cross_attention(
                    lp["cross"], cfg, h, c["cross_k"], c["cross_v"])
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
    batching); the vlm kind's count its patch prefix. The encdec and
    audio kinds add each slot's sinusoidal position to its token.
    Returns (logits, cache).
    """
    x = _embed_tokens(p, cfg, token, dtype)
    if _kv_pool(cfg, cache) is None:
        return _decode_layers(p, cfg, x, cache, None), cache
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    pos = pos.reshape(-1).expand(token.shape[0])
    if cfg.kind in ENCODER_KINDS and not cfg.rope:
        x = x + _slot_sinusoid(cfg.d_model, pos).to(dtype)
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
    (K/V, the recurrent state and conv contexts, the cross leaves of
    the encdec and audio kinds) is copied along its ``cache_batch``
    axis, found through :func:`cache_logical_axes_tree` as the reference
    does, cast to the live leaf's dtype. Optionally also writes
    ``one_pos`` (0-d or (1,)) into the per-slot ``pos`` vector, in place.
    Returns ``cache`` (and ``pos`` when given).

    On a DTensor cache the write keeps the live placement: only the
    rank(s) holding ``slot`` write it, and the batch-1 source is taken
    into the live heads layout first (the live cache never moves).
    """
    axes = tree_items(cache_logical_axes_tree(cfg))
    for (path, dst), (src_path, src), (ax_path, ax) in zip(
            tree_items(cache), tree_items(one_cache), axes):
        assert path == src_path == ax_path, (path, src_path, ax_path)
        write_rows(dst, src.to(dst.dtype), slot, ax.index("cache_batch"))
    if pos is None:
        return cache
    pos[slot] = torch.as_tensor(local(one_pos)).reshape(())
    return cache, pos


# ---------------------------------------------------------------------------
# paged cache: attention K/V in a shared page pool; chunked prefill +
# page-map decode
# ---------------------------------------------------------------------------

def init_paged_cache_tree(cfg, slots: int, num_pages: int, page_size: int,
                          dtype=torch.bfloat16, *,
                          device: DeviceLike = None, mesh=None,
                          cache_rules=None) -> dict:
    """Paged-cache tree: attention K/V leaves become a page pool
    ``(layers, num_pages, page_size, K, hd)`` shared by all slots (page 0
    reserved as the dummy sink), on ``device`` (default: the CUDA
    device). ``slots`` sizes the per-slot recurrent state, which has no
    pages: the ssm kind's ``{"layers": {"h", "conv_x", "conv_B",
    "conv_C"}}``, an RG-LRU layer's ``{"h", "conv"}``, each with
    ``slots`` lanes. With ``mesh``, every leaf is a DTensor placed as in
    :func:`init_cache_tree` (the page and in-page offset dims stay
    replicated)."""
    _require_paged(cfg)
    if mesh is not None:
        return _placed(init_paged_cache_tree(cfg, slots, num_pages,
                                             page_size, dtype,
                                             device="meta"),
                       paged_cache_logical_axes_tree(cfg), mesh,
                       cache_rules)
    device = resolve_device(device)
    return _cache_tree(cfg, {
        "attn": lambda: attn.init_paged_cache(cfg, num_pages, page_size,
                                              dtype, device=device),
        "ssm": lambda: ssmm.init_ssm_cache(cfg, slots, dtype, device=device),
        "rec": lambda: rgm.init_rglru_cache(cfg, slots, dtype,
                                            device=device)})


def paged_cache_logical_axes_tree(cfg) -> dict:
    """Logical axes matching :func:`init_paged_cache_tree`'s structure."""
    _require_paged(cfg)
    return _axes_tree(cfg, {
        "attn": attn.paged_cache_logical_axes,
        "ssm": lambda: ssmm.ssm_cache_logical_axes(cfg),
        "rec": lambda: rgm.rglru_cache_logical_axes(cfg)})


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
    q = attn._project_q(lp["attn"], cfg, h)
    q = hint(q, ("pod", "data"), None, "model", None, None)
    k = hint(k, ("pod", "data"), None, "model", None)
    v = hint(v, ("pod", "data"), None, "model", None)
    q, k = _rotate(q, k, rotary)
    q = hint(q, ("pod", "data"), None, "model", None, None)
    k = hint(k, ("pod", "data"), None, "model", None)
    v = hint(v, ("pod", "data"), None, "model", None)

    def attend(q, k, v, k_pages, v_pages, flat, src, row):
        attn._paged_scatter({"k": k_pages, "v": v_pages}, k[0], v[0], flat,
                            src)
        ps, P = k_pages.shape[1], row.shape[0]
        kg = k_pages[row].reshape(1, P * ps, *k_pages.shape[2:])
        vg = v_pages[row].reshape(1, P * ps, *v_pages.shape[2:])
        return attn.simple_attention(q, kg.to(q.dtype), vg.to(q.dtype),
                                     mode=mode, window=window,
                                     q_offset=start, k_len=start + valid)

    def where(_):
        # each rank's heads; the one chunk and the pools are whole over
        # ``data``, so every data rank writes the same rows
        qp, kvp = attn.heads_placements(q), attn.heads_placements(k)
        idx = keep_dims(qp, ())
        return (qp, kvp, kvp, kv["k"].placements, kv["v"].placements,
                idx, idx, idx), qp

    out = on_shards(attend, (q, k, v, kv["k"], kv["v"], flat, src, row),
                    where)
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
    fresh = start == 0
    conv0 = None if fresh else tuple(read_rows(c[k], slot, 1, 0)
                                     for k in _CONV_LEAVES)
    # dt = 0 freezes the recurrence on pad rows (the same trick as the
    # mixed-length one-shot prefill), so h_fin is the state at valid-1
    keep = (torch.arange(C, device=x.device) < valid)[None, :, None]
    out, h_fin, pre = ssmm.ssm_sequence(
        lp["ssm"], cfg, apply_norm(cfg, lp["ln"], x), conv0=conv0,
        keep=keep, h0=None if fresh else read_rows(c["h"], slot, 1, 0),
        use_kernel=use_kernel and fresh)
    write_rows(c["h"], h_fin, slot, 0)
    for name, v, v0 in zip(_CONV_LEAVES, pre, conv0 or (None,) * 3):
        write_rows(c[name], _conv_context(v, valid, cfg.ssm_conv_width, v0),
                   slot, 0)
    return x + out


def _chunk_rec_layer(lp, cfg, x: torch.Tensor, c: dict, *, slot: int,
                     start: int, valid: int) -> torch.Tensor:
    """One RG-LRU layer over a prefill chunk with the slot's carried
    (h, conv) state: the inbound state is folded into the first scan
    element (h_0 = a_0 h_in + b_0), which continues the recurrence
    exactly; ``start == 0`` starts fresh. Pad rows (>= valid) run on, and
    the state written back is the one at row valid - 1."""
    fresh = start == 0
    conv0 = None if fresh else read_rows(c["conv"], slot, 1, 0)
    out, hs, pre = rgm.rglru_sequence(
        lp["rec"], apply_norm(cfg, lp["ln_rec"], x), conv0=conv0,
        h0=None if fresh else read_rows(c["h"], slot, 1, 0))
    x = x + out
    x = x + mlpm.apply_mlp(lp["mlp"], cfg, apply_norm(cfg, lp["ln_mlp"], x))
    conv1 = _conv_context(pre, valid, cfg.rglru_conv_width, conv0)
    write_rows(c["h"], hs[:, max(valid - 1, 0)], slot, 0)
    write_rows(c["conv"], conv1, slot, 0)
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
        row = np.asarray(page_row.cpu() if torch.is_tensor(page_row)
                         else page_row, dtype=np.int64)
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


__all__ = ["PAGED_KINDS", "cache_len_for", "cache_logical_axes_tree",
           "decode_step",
           "decode_step_paged", "effective_window", "init_cache_tree",
           "init_paged_cache_tree", "paged_cache_logical_axes_tree", "prefill",
           "prefill_chunk",
           "write_cache_slot"]
