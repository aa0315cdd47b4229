"""The model stack — the port of ``repro/models/transformer.py``, every
arch kind: ``dense``, ``moe``, ``ssm``, ``hybrid``, ``vlm``, ``encdec``
and ``audio``.

Per-layer parameters stay stacked on a leading ``layers`` axis, as in
the reference, so the leaves, their order and a flat buffer's offsets
match the reference column for column; the layer loop is a Python loop
over that axis (the reference's ``lax.scan``). Heterogeneous stacks
stack ``groups``, the smallest repeating unit, as the reference does:
the hybrid kind (RecurrentGemma: RG-LRU blocks and local attention 2:1)
``groups`` of ``{rec_0, rec_1, attn}`` and a ``tail`` of the remaining
recurrent layers; the moe kind with an MoE FFN every ``moe_every > 1``
layers (llama4-maverick) ``groups`` of ``{dense_0, ..., moe}``, and with
one in every layer (llama4-scout) a plain ``layers`` stack. The vlm kind
(PaliGemma) stacks plain ``layers`` and runs a prefix LM over the stub
vision frontend's patch embeddings (``batch["patches"]``, (B,
enc_seq_len, d)) put before the scaled text embeddings; only the text
positions are unembedded. The encdec and audio kinds (Whisper) stack an
encoder, ``enc_layers`` and ``enc_ln_final``, over the stub frontend's
frames (``batch["frames"]``) plus sinusoidal positions, and a decoder,
``layers``, whose layers carry a cross-attention block (``ln_cross``,
``cross``) over the encoder's output.
:func:`walk_layers` walks any of these layouts in the model's order.

``remat`` (default True, as in the reference) rematerializes the
activations of the training forward: each unit of the reference's
scanned layer body (a layer of ``layers``, ``enc_layers`` and ``tail``;
a whole group of ``groups``) runs under a non-reentrant
``torch.utils.checkpoint``, which keeps the unit's input for the
backward and runs the unit again there to rebuild the rest, up to the
last tensor the backward needs (the final projection is not run
again). The numbers are the same either way; what moves is the peak
memory of a training step and its FLOPs. Where no gradient is being
recorded (serving, evaluation) the units run as they are.

The moe kind's forward returns the load-balance and router z-losses,
each the mean over the MoE layers, and :func:`loss_fn` adds them with
the reference's weights. The ssm kind (Mamba-2,
:mod:`repro_torch.models.ssm`) takes ``use_kernel``, the reference's
``use_pallas``: its scans through the forward-only ``ssd_scan`` kernel.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator

import torch
import torch.nn.functional as F
from torch.utils._pytree import tree_flatten
from torch.utils.checkpoint import checkpoint

from repro_torch.dist.sharding import hint, hint_scope
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlpm
from repro_torch.models import moe as moem
from repro_torch.models import rglru as rgm
from repro_torch.models import ssm as ssmm
from repro_torch.models.common import (
    Px, vocab_sharded, apply_norm, embed_init, norm_init,
    sinusoidal_positions, softmax_cross_entropy, split_tree,
    tree_from_items, tree_items, vocab_parallel_embedding)

# the kinds with an encoder and cross-attention decoder layers
ENCODER_KINDS = ("encdec", "audio")
# the kinds fed a stub frontend's embeddings beside the tokens
FRONTEND_KINDS = ("vlm",) + ENCODER_KINDS


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------

def init_dense_layer(gen, cfg, *, device, use_moe: bool = False,
                     cross: bool = False) -> dict:
    p = {
        "ln_attn": norm_init(cfg, cfg.d_model, device=device),
        "attn": attn.init_attention(gen, cfg, device=device),
        "ln_mlp": norm_init(cfg, cfg.d_model, device=device),
    }
    p["moe" if use_moe else "mlp"] = (
        moem.init_moe(gen, cfg, device=device) if use_moe
        else mlpm.init_mlp(gen, cfg, device=device))
    if cross:
        p["ln_cross"] = norm_init(cfg, cfg.d_model, device=device)
        p["cross"] = attn.init_attention(gen, cfg, device=device)
    return p


def apply_ffn(p, cfg, h: torch.Tensor, token_mask=None):
    """A layer's feed-forward block on its normed input: the MoE FFN
    where the layer has one (its aux beside it; ``token_mask``, (B, T)
    bool, keeps pad tokens out of the routing), else the MLP (aux None)."""
    if "moe" in p:
        return moem.apply_moe(p["moe"], cfg, h, token_mask=token_mask)
    return mlpm.apply_mlp(p["mlp"], cfg, h), None


def apply_cross(p, cfg, x: torch.Tensor, enc_out) -> torch.Tensor:
    """A decoder layer's cross-attention block, where it has one: x plus
    the unmasked attention of its normed input over ``enc_out``."""
    if "cross" not in p:
        return x
    h = apply_norm(cfg, p["ln_cross"], x)
    return x + attn.attention_block(p["cross"], cfg, h, mode="full",
                                    kv_source=enc_out)


def apply_dense_layer(p, cfg, x: torch.Tensor, *, mode: str = "causal",
                      window: int = 0, prefix_len=None, positions=None,
                      enc_out=None):
    """-> (x, the MoE FFN's aux, or None for an MLP layer). A layer with
    ``cross`` attends to ``enc_out`` between its self-attention and its
    FFN."""
    x = hint(x, ("pod", "data"), None, None)   # batch stays data-sharded
    h = apply_norm(cfg, p["ln_attn"], x)
    h = attn.attention_block(p["attn"], cfg, h, mode=mode, window=window,
                             prefix_len=prefix_len, positions=positions)
    x = apply_cross(p, cfg, x + h, enc_out)
    y, aux = apply_ffn(p, cfg, apply_norm(cfg, p["ln_mlp"], x))
    return x + y, aux


def init_ssm_layer(gen, cfg, *, device) -> dict:
    return {"ln": norm_init(cfg, cfg.d_model, device=device),
            "ssm": ssmm.init_ssm(gen, cfg, device=device)}


def apply_ssm_layer(p, cfg, x: torch.Tensor, *,
                    use_kernel: bool = False) -> torch.Tensor:
    x = hint(x, ("pod", "data"), None, None)
    return x + ssmm.apply_ssm(p["ssm"], cfg, apply_norm(cfg, p["ln"], x),
                              use_kernel=use_kernel)


def init_rec_layer(gen, cfg, *, device) -> dict:
    return {"ln_rec": norm_init(cfg, cfg.d_model, device=device),
            "rec": rgm.init_rglru(gen, cfg, device=device),
            "ln_mlp": norm_init(cfg, cfg.d_model, device=device),
            "mlp": mlpm.init_mlp(gen, cfg, device=device)}


def apply_rec_layer(p, cfg, x: torch.Tensor) -> torch.Tensor:
    x = hint(x, ("pod", "data"), None, None)
    x = x + rgm.apply_rglru(p["rec"], cfg, apply_norm(cfg, p["ln_rec"], x))
    return x + mlpm.apply_mlp(p["mlp"], cfg, apply_norm(cfg, p["ln_mlp"], x))


def hybrid_layout(cfg) -> tuple[int, int, int]:
    """(period, groups, tail layers) of the hybrid stack: 38 layers of
    period 3 are 12 groups of (rec, rec, attn) and a tail of 2."""
    period = cfg.local_attn_every or 3
    n_groups = cfg.num_layers // period
    return period, n_groups, cfg.num_layers - n_groups * period


def group_layout(cfg):
    """The stack's ``groups`` layout, or None where the layers stack
    plainly on ``layers``: ((member name, layer kind) of a group, in the
    model's order; groups; layers in the recurrent ``tail``). The hybrid
    kind's group is (rec_0, rec_1, attn); the moe kind's, where
    ``moe_every > 1``, is (dense_0, ..., moe), every member an attention
    layer, and ``num_layers // moe_every`` groups drop any remainder, as
    the reference does."""
    if cfg.kind == "hybrid":
        period, n_groups, rem = hybrid_layout(cfg)
        return ((*((f"rec_{i}", "rec") for i in range(period - 1)),
                 ("attn", "attn")), n_groups, rem)
    if cfg.kind == "moe" and cfg.moe_every > 1:
        return ((*((f"dense_{i}", "attn") for i in range(cfg.moe_every - 1)),
                 ("moe", "attn")), cfg.num_layers // cfg.moe_every, 0)
    return None


# ---------------------------------------------------------------------------
# stack init
# ---------------------------------------------------------------------------

def _stack(init_one: Callable[[], dict], n: int) -> dict:
    """n layer inits stacked on a leading ``layers`` axis (Px leaves),
    each layer written into the stack as it is drawn: the stack and one
    layer are alive at once, not the stack and every layer."""
    first = init_one()

    def alloc(tree):
        return {k: alloc(v) if isinstance(v, dict) else Px(
                    torch.empty((n,) + tuple(v.value.shape),
                                dtype=v.value.dtype, device=v.value.device),
                    ("layers",) + tuple(v.axes))
                for k, v in tree.items()}

    def write(dst, src, i):
        for k, v in src.items():
            if isinstance(v, dict):
                write(dst[k], v, i)
            else:
                dst[k].value[i].copy_(v.value)

    stacked = alloc(first)
    write(stacked, first, 0)
    del first
    for i in range(1, n):
        write(stacked, init_one(), i)
    return stacked


def init_model(gen, cfg, *, device) -> dict:
    """Full parameter tree (Px leaves), float32."""
    V = cfg.padded_vocab
    p: dict[str, Any] = {
        "embed": embed_init(gen, V, cfg.d_model, ("vocab", "embed_nomodel"),
                            device=device),
        "ln_final": norm_init(cfg, cfg.d_model, device=device),
    }
    if not cfg.tie_embeddings:
        p["unembed"] = embed_init(gen, V, cfg.d_model,
                                  ("vocab", "embed_nomodel"), device=device)
    if cfg.kind in ENCODER_KINDS:
        p["enc_layers"] = _stack(
            lambda: init_dense_layer(gen, cfg, device=device),
            cfg.enc_num_layers)
        p["enc_ln_final"] = norm_init(cfg, cfg.d_model, device=device)
        p["layers"] = _stack(
            lambda: init_dense_layer(gen, cfg, device=device, cross=True),
            cfg.num_layers)
        return p
    layout = group_layout(cfg)
    if layout is None:
        if cfg.kind == "ssm":
            p["layers"] = _stack(
                lambda: init_ssm_layer(gen, cfg, device=device),
                cfg.num_layers)
        else:
            p["layers"] = _stack(lambda: init_dense_layer(
                gen, cfg, device=device, use_moe=cfg.kind == "moe"),
                cfg.num_layers)
        return p
    members, n_groups, rem = layout

    def group():
        return {name: init_rec_layer(gen, cfg, device=device)
                if kind == "rec" else
                init_dense_layer(gen, cfg, device=device,
                                 use_moe=name == "moe")
                for name, kind in members}
    if n_groups:
        p["groups"] = _stack(group, n_groups)
    if rem:
        p["tail"] = _stack(lambda: init_rec_layer(gen, cfg, device=device),
                           rem)
    return p


# ---------------------------------------------------------------------------
# forward (training)
# ---------------------------------------------------------------------------

def _embed_tokens(p, cfg, tokens: torch.Tensor, dtype) -> torch.Tensor:
    table = p["embed"].to(dtype)
    if vocab_sharded(table, 0):
        x = vocab_parallel_embedding(table, tokens)
    else:
        x = F.embedding(tokens.long(), table)
    if cfg.scale_embed:
        # the factor rounded to the compute dtype, as the reference's
        # jnp.asarray(sqrt(d), dtype); torch.full launches no host copy
        x = x * torch.full((), cfg.d_model ** 0.5, dtype=dtype,
                           device=x.device)
    return hint(x, ("pod", "data"), None, None)


def _unembed(p, cfg, x: torch.Tensor) -> torch.Tensor:
    w = p["unembed"] if "unembed" in p else p["embed"]
    logits = x @ w.to(x.dtype).T
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = torch.tanh(logits / c) * c
    # keep the vocab dim model-sharded through the loss — replicated
    # (B, T, V) logits are a multi-GB temporary per rank
    return hint(logits, ("pod", "data"), None, "model")


def _unstack(stacked: dict, n: int) -> list[dict]:
    """The n per-layer trees of a stacked tree, as views. ``unbind``
    keeps the backward to one stack of the per-layer gradients, where
    indexing each layer would add n full-size zero-padded gradients."""
    items = tree_items(stacked)
    slices = [v.unbind(0) for _, v in items]
    return [tree_from_items((path, sl[i]) for (path, _), sl in
                            zip(items, slices)) for i in range(n)]


def walk_units(cfg, *trees: dict) -> Iterator[list]:
    """The model's layers in order, in the units of the reference's
    scanned layer bodies: each unit a list of ``(layer kind, the layer's
    view of each tree)``, one layer of ``layers`` or ``tail``, or every
    member of one group of ``groups``. See :func:`walk_layers`."""
    layout = group_layout(cfg)
    if layout is None:
        kind = "ssm" if cfg.kind == "ssm" else "attn"
        for views in zip(*(_unstack(t["layers"], cfg.num_layers)
                           for t in trees)):
            yield [(kind, *views)]
        return
    members, n_groups, rem = layout
    if n_groups:
        for views in zip(*(_unstack(t["groups"], n_groups) for t in trees)):
            yield [(kind, *(v[name] for v in views))
                   for name, kind in members]
    if rem:
        for views in zip(*(_unstack(t["tail"], rem) for t in trees)):
            yield [("rec", *views)]


def walk_layers(cfg, *trees: dict) -> Iterator[tuple]:
    """The model's layers in order, as ``(layer kind, the layer's view of
    each tree)`` with kind "attn", "ssm" or "rec" (an MoE layer is an
    "attn" layer whose FFN is ``moe``; a decoder layer of the encdec and
    audio kinds an "attn" layer with ``cross``). ``trees`` share the
    stack layout of :func:`init_model` (the parameters, a cache):
    ``layers``, or the ``groups`` of :func:`group_layout` and then a
    ``tail``; the encoder's ``enc_layers`` are not walked (see
    :func:`encode`). The views write through to the stacks."""
    for unit in walk_units(cfg, *trees):
        yield from unit


def remat_unit(fn: Callable, x: torch.Tensor, params, *extra,
               remat: bool = True):
    """``fn(x, params, *extra)``, its activations rematerialized in the
    backward (non-reentrant checkpoint) with ``remat`` where a gradient
    is being recorded through ``x``, ``params`` or ``extra``; else
    ``fn`` as it is. The hint state of the forward is set again for the
    recompute, and no RNG state is kept (the model draws none)."""
    if not (remat and torch.is_grad_enabled()
            and any(isinstance(t, torch.Tensor) and t.requires_grad
                    for t in tree_flatten((x, params, extra))[0])):
        return fn(x, params, *extra)
    scope = hint_scope()

    def body(*args):
        with scope():
            return fn(*args)

    return checkpoint(body, x, params, *extra, use_reentrant=False,
                      preserve_rng_state=False)


def attention_mode(cfg, serve_window: int = 0) -> tuple[str, int]:
    """(mask mode, window) of the model's attention layers: the hybrid
    kind's local window, an arch's sliding window, a serving window, or
    causal."""
    if cfg.kind == "hybrid":
        return "sliding", cfg.attention_window
    if cfg.sliding_window:
        return "sliding", cfg.sliding_window
    if serve_window and cfg.kind != "ssm":
        return "sliding", serve_window
    return "causal", 0


def _enc_layer(h, lp, cfg):
    return apply_dense_layer(lp, cfg, h, mode="full")[0]


def encode(p, cfg, frames: torch.Tensor, dtype,
           remat: bool = True) -> torch.Tensor:
    """The encoder of the encdec and audio kinds: the stub frontend's
    frames (B, S, d) plus sinusoidal positions, through ``enc_layers``
    (unmasked self-attention; each layer rematerialized with ``remat``)
    and ``enc_ln_final``."""
    S = frames.shape[1]
    h = frames.to(dtype) + sinusoidal_positions(
        S, cfg.d_model, device=frames.device).to(dtype)[None]
    for lp in _unstack(p["enc_layers"], cfg.enc_num_layers):
        h = remat_unit(_enc_layer, h, lp, cfg, remat=remat)
    return apply_norm(cfg, p["enc_ln_final"], h)


def decoder_positions(cfg, x: torch.Tensor) -> torch.Tensor:
    """x (B, T, d) of the encdec and audio kinds' decoder plus its
    sinusoidal positions where the arch has no RoPE."""
    if cfg.rope:
        return x
    return x + sinusoidal_positions(x.shape[1], cfg.d_model,
                                    device=x.device).to(x.dtype)[None]


def embed_inputs(p, cfg, batch, dtype, remat: bool = True):
    """The first layer's input and what the frontends change, as the
    reference's forward and prefill do: -> (x, mask, enc_out). x is the
    embedded tokens (B, T, d); for the vlm kind the stub patches
    (``batch["patches"]``, (B, enc_seq_len, d)) go before them, after
    ``scale_embed``, and mask is ("prefix", 0, enc_seq_len); for the
    encdec and audio kinds ``enc_out`` is the encoder's output over
    ``batch["frames"]``, x gets its sinusoidal positions and mask is
    ("causal", 0, None). Otherwise mask and enc_out are None (the kind's
    own :func:`attention_mode`)."""
    x = _embed_tokens(p, cfg, batch["tokens"], dtype)
    if cfg.kind == "vlm":
        patches = batch["patches"].to(device=x.device, dtype=dtype)
        return (torch.cat([patches, x], dim=1),
                ("prefix", 0, cfg.enc_seq_len), None)
    if cfg.kind in ENCODER_KINDS:
        enc_out = encode(p, cfg, batch["frames"].to(x.device), dtype,
                         remat=remat)
        return decoder_positions(cfg, x), ("causal", 0, None), enc_out
    return x, None, None


def _apply_unit(x, unit, cfg, mode, window, prefix_len, enc_out,
                use_kernel):
    """One unit of :func:`walk_units` on x -> (x, the MoE layers' aux
    dicts)."""
    auxs = []
    for kind, lp in unit:
        if kind == "ssm":
            x = apply_ssm_layer(lp, cfg, x, use_kernel=use_kernel)
        elif kind == "rec":
            x = apply_rec_layer(lp, cfg, x)
        else:
            x, aux = apply_dense_layer(lp, cfg, x, mode=mode, window=window,
                                       prefix_len=prefix_len,
                                       enc_out=enc_out)
            if aux is not None:
                auxs.append(aux)
    return x, auxs


def forward(p, cfg, batch, *, dtype=torch.bfloat16, remat: bool = True,
            use_kernel: bool = False):
    """Full-sequence forward -> (logits, aux_losses).
    batch: {"tokens": (B, T) int}, and the stub frontends' embeddings:
    ``patches`` (B, enc_seq_len, d) for the vlm kind, ``frames`` (B,
    enc_seq_len, d) for the encdec and audio kinds. The logits are the
    text positions' (B, T, V). ``aux_losses``: the moe kind's
    ``load_balance`` and ``router_z``, each the mean over the MoE layers;
    empty for the other kinds. ``remat``: each unit of
    :func:`walk_units` (and of the encoder) rematerialized in the
    backward. ``use_kernel`` (ssm kind): the scans through the
    forward-only ``ssd_scan`` kernel."""
    x, mask, enc_out = embed_inputs(p, cfg, batch, dtype, remat=remat)
    mode, window, prefix_len = mask or (*attention_mode(cfg), None)
    auxs = []
    extra = () if enc_out is None else (enc_out,)

    def unit_fn(x_, unit, *enc):
        return _apply_unit(x_, unit, cfg, mode, window, prefix_len,
                           enc[0] if enc else None, use_kernel)

    for unit in walk_units(cfg, p):
        x, a = remat_unit(unit_fn, x, unit, *extra, remat=remat)
        auxs += a
    # the residual stream whole over ``model`` (a layer's last product
    # leaves a pending sum) before the text positions are cut out
    x = apply_norm(cfg, p["ln_final"], hint(x, ("pod", "data"), None, None))
    if prefix_len:
        x = x[:, prefix_len:]                # the text positions only
    aux_losses = {k: torch.stack([a[k] for a in auxs]).mean()
                  for k in ("load_balance", "router_z")} if auxs else {}
    return _unembed(p, cfg, x), aux_losses


def loss_fn(p, cfg, batch, *, dtype=torch.bfloat16, remat: bool = True,
            use_kernel: bool = False):
    """Mean token NLL, plus the moe kind's aux losses:
    ``moe_aux_loss_weight * load_balance + 1e-3 * router_z``."""
    logits, aux = forward(p, cfg, batch, dtype=dtype, remat=remat,
                          use_kernel=use_kernel)
    loss = softmax_cross_entropy(logits, batch["labels"])
    if "load_balance" in aux:
        loss = loss + cfg.moe_aux_loss_weight * aux["load_balance"] \
            + 1e-3 * aux["router_z"]
    return loss


def init_tree(gen, cfg, *, device) -> tuple[dict, dict]:
    """(params, logical axes) of :func:`init_model`."""
    return split_tree(init_model(gen, cfg, device=device))


__all__ = ["ENCODER_KINDS", "FRONTEND_KINDS", "apply_cross",
           "apply_dense_layer", "apply_ffn", "apply_rec_layer",
           "apply_ssm_layer", "attention_mode", "decoder_positions",
           "embed_inputs", "encode", "forward", "group_layout", "hybrid_layout",
           "init_dense_layer", "init_model", "init_rec_layer",
           "init_ssm_layer", "init_tree", "loss_fn", "remat_unit",
           "walk_layers", "walk_units"]
