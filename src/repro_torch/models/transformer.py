"""The model stack — the port of the ``dense`` and ``ssm`` kinds of
``repro/models/transformer.py``.

Per-layer parameters stay stacked on a leading ``layers`` axis, as in
the reference, so the leaves, their order and a flat buffer's offsets
match the reference column for column; the layer loop is a Python loop
over that axis (the reference's ``lax.scan``). The reference's
activation rematerialization (``remat``) changes no number; the port
leaves it out and takes no ``remat`` option (ROADMAP.md Queue 1 item 6b).

The ssm kind (Mamba-2, :mod:`repro_torch.models.ssm`) takes
``use_kernel``, the reference's ``use_pallas``: its scans through the
forward-only ``ssd_scan`` kernel. The other kinds (moe, hybrid, vlm,
encdec, audio) raise ``NotImplementedError``: they come with ROADMAP.md
Queue 1 item 6b.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.nn.functional as F

from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlpm
from repro_torch.models import ssm as ssmm
from repro_torch.models.common import (
    Px, apply_norm, embed_init, norm_init, softmax_cross_entropy,
    split_tree, tree_from_items, tree_items)


PORTED_KINDS = ("dense", "ssm")


def require_ported(cfg) -> None:
    if cfg.kind not in PORTED_KINDS:
        raise NotImplementedError(
            f"{cfg.name}: the port runs the {' and '.join(PORTED_KINDS)} "
            f"kinds; the {cfg.kind!r} kind is not ported yet (ROADMAP.md "
            "Queue 1 item 6b)")


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------

def init_dense_layer(gen, cfg, *, device) -> dict:
    return {
        "ln_attn": norm_init(cfg, cfg.d_model, device=device),
        "attn": attn.init_attention(gen, cfg, device=device),
        "ln_mlp": norm_init(cfg, cfg.d_model, device=device),
        "mlp": mlpm.init_mlp(gen, cfg, device=device),
    }


def apply_dense_layer(p, cfg, x: torch.Tensor, *, mode: str = "causal",
                      window: int = 0, prefix_len=None,
                      positions=None) -> torch.Tensor:
    h = apply_norm(cfg, p["ln_attn"], x)
    h = attn.attention_block(p["attn"], cfg, h, mode=mode, window=window,
                             prefix_len=prefix_len, positions=positions)
    x = x + h
    h = apply_norm(cfg, p["ln_mlp"], x)
    return x + mlpm.apply_mlp(p["mlp"], cfg, h)


def init_ssm_layer(gen, cfg, *, device) -> dict:
    return {"ln": norm_init(cfg, cfg.d_model, device=device),
            "ssm": ssmm.init_ssm(gen, cfg, device=device)}


def apply_ssm_layer(p, cfg, x: torch.Tensor, *,
                    use_kernel: bool = False) -> torch.Tensor:
    return x + ssmm.apply_ssm(p["ssm"], cfg, apply_norm(cfg, p["ln"], x),
                              use_kernel=use_kernel)


# ---------------------------------------------------------------------------
# stack init
# ---------------------------------------------------------------------------

def _stack(init_one: Callable[[], dict], n: int) -> dict:
    """n layer inits stacked on a leading ``layers`` axis (Px leaves)."""
    layers = [init_one() for _ in range(n)]

    def stack(*leaves: Px) -> Px:
        return Px(torch.stack([l.value for l in leaves]),
                  ("layers",) + tuple(leaves[0].axes))

    def walk(nodes):
        return {k: (walk([nd[k] for nd in nodes])
                    if isinstance(nodes[0][k], dict)
                    else stack(*(nd[k] for nd in nodes)))
                for k in nodes[0]}
    return walk(layers)


def init_model(gen, cfg, *, device) -> dict:
    """Full parameter tree (Px leaves), float32."""
    require_ported(cfg)
    V = cfg.padded_vocab
    p: dict[str, Any] = {
        "embed": embed_init(gen, V, cfg.d_model, ("vocab", "embed_nomodel"),
                            device=device),
        "ln_final": norm_init(cfg, cfg.d_model, device=device),
    }
    if not cfg.tie_embeddings:
        p["unembed"] = embed_init(gen, V, cfg.d_model,
                                  ("vocab", "embed_nomodel"), device=device)
    init_layer = init_ssm_layer if cfg.kind == "ssm" else init_dense_layer
    p["layers"] = _stack(lambda: init_layer(gen, cfg, device=device),
                         cfg.num_layers)
    return p


# ---------------------------------------------------------------------------
# forward (training)
# ---------------------------------------------------------------------------

def _embed_tokens(p, cfg, tokens: torch.Tensor, dtype) -> torch.Tensor:
    x = F.embedding(tokens.long(), p["embed"].to(dtype))
    if cfg.scale_embed:
        # the factor rounded to the compute dtype, as the reference's
        # jnp.asarray(sqrt(d), dtype); torch.full launches no host copy
        x = x * torch.full((), cfg.d_model ** 0.5, dtype=dtype,
                           device=x.device)
    return x


def _unembed(p, cfg, x: torch.Tensor) -> torch.Tensor:
    w = p["unembed"] if "unembed" in p else p["embed"]
    logits = x @ w.to(x.dtype).T
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = torch.tanh(logits / c) * c
    return logits


def _unstack(stacked: dict, n: int) -> list[dict]:
    """The n per-layer trees of a stacked tree, as views. ``unbind``
    keeps the backward to one stack of the per-layer gradients, where
    indexing each layer would add n full-size zero-padded gradients."""
    items = tree_items(stacked)
    slices = [v.unbind(0) for _, v in items]
    return [tree_from_items((path, sl[i]) for (path, _), sl in
                            zip(items, slices)) for i in range(n)]


def forward(p, cfg, batch, *, dtype=torch.bfloat16, use_kernel: bool = False):
    """Full-sequence forward -> (logits, aux_losses).
    batch: {"tokens": (B, T) int}. ``use_kernel`` (ssm kind): the scans
    through the forward-only ``ssd_scan`` kernel."""
    require_ported(cfg)
    x = _embed_tokens(p, cfg, batch["tokens"], dtype)
    mode, window = "causal", 0
    if cfg.sliding_window:
        mode, window = "sliding", cfg.sliding_window
    for lp in _unstack(p["layers"], cfg.num_layers):
        if cfg.kind == "ssm":
            x = apply_ssm_layer(lp, cfg, x, use_kernel=use_kernel)
        else:
            x = apply_dense_layer(lp, cfg, x, mode=mode, window=window)
    x = apply_norm(cfg, p["ln_final"], x)
    return _unembed(p, cfg, x), {}


def loss_fn(p, cfg, batch, *, dtype=torch.bfloat16, use_kernel: bool = False):
    logits, _ = forward(p, cfg, batch, dtype=dtype, use_kernel=use_kernel)
    return softmax_cross_entropy(logits, batch["labels"])


def init_tree(gen, cfg, *, device) -> tuple[dict, dict]:
    """(params, logical axes) of :func:`init_model`."""
    return split_tree(init_model(gen, cfg, device=device))


__all__ = ["PORTED_KINDS", "apply_dense_layer", "apply_ssm_layer",
           "forward", "init_dense_layer", "init_model", "init_ssm_layer",
           "init_tree", "loss_fn", "require_ported"]
