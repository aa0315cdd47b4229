"""Top-1 (Switch-style) Mixture-of-Experts FFN — the port of
``repro/models/moe.py``.

Tokens are routed in groups: the router's argmax picks each token's
expert, and an expert takes at most ``c = round(s * capacity_factor /
E)`` tokens of a group of ``s``, in token order; a token past its
expert's capacity is dropped (its FFN output is 0, so only the residual
passes). Dispatch and combine are the reference's one-hot products over
the groups, ``torch.einsum`` here: ``(n, s, E, c)`` one-hots against the
tokens, so no ``(n, s, E, c, D)`` tensor is made. The router's logits,
softmax and logsumexp are float32 whatever the compute dtype.

Aux losses, returned for the trainer to weigh: the Switch load-balance
loss ``E * sum_e f_e * p_e``, the router z-loss ``mean(logsumexp^2)``,
and ``drop_frac``, the share of (real) tokens dropped.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import hint, on_shards, with_dims
from repro_torch.models.common import dense_init


def init_moe(gen, cfg, *, device) -> dict:
    """The router ``(d, E)`` and the experts' ``w_up``/``w_gate`` ``(E,
    d, f)`` and ``w_down`` ``(E, f, d)`` (``w_gate`` for the gated MLP
    variants), with the reference's logical axes."""
    d, f, E = cfg.d_model, cfg.d_ff, cfg.moe_num_experts
    ffn_in = ("experts", "embed_fsdp", "expert_ffn")
    p = {
        "router": dense_init(gen, (d, E), ("embed", "experts_router"),
                             device=device),
        "w_up": dense_init(gen, (E, d, f), ffn_in, device=device),
        "w_down": dense_init(gen, (E, f, d),
                             ("experts", "expert_ffn", "embed_fsdp"),
                             device=device, fan_in=f),
    }
    if cfg.mlp_variant in ("swiglu", "geglu"):
        p["w_gate"] = dense_init(gen, (E, d, f), ffn_in, device=device)
    return p


def _group_size(G: int, target: int = 2048) -> int:
    """Largest divisor of G that is <= target (dispatch tile size)."""
    if G <= target:
        return G
    n = -(-G // target)           # ceil
    while G % n:
        n += 1
    return G // n


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """float32 one-hot of ``idx`` over ``n`` classes; an index outside
    [0, n) gives a zero row, as ``jax.nn.one_hot``."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def _route_local(logits: torch.Tensor, token_mask, c: int, dt):
    """Top-1 routing of float32 router logits (n, s, E): -> (probs,
    gate (n, s), the expert one-hot (n, s, E), keep (n, s), the dispatch
    one-hots (n, s, E, c) in ``dt``)."""
    n, s, E = logits.shape
    probs = torch.softmax(logits, dim=-1)
    eid = torch.argmax(logits, dim=-1)                        # first max
    gate = torch.amax(probs, dim=-1)                          # (n, s)
    onehot_e = _one_hot(eid, E)                               # (n, s, E)
    if token_mask is not None:
        onehot_e = onehot_e * token_mask.reshape(n, s).float()[..., None]
    pos_in_e = torch.cumsum(onehot_e, dim=1) - onehot_e
    pos = torch.sum(pos_in_e * onehot_e, dim=-1)              # (n, s) f32
    keep = pos < c
    onehot_c = _one_hot(pos.long(), c)                        # (n, s, c)
    disp = (onehot_e[..., None] * onehot_c[:, :, None, :]
            * keep[..., None, None]).to(dt)                   # (n, s, E, c)
    return probs, gate, onehot_e, keep, disp


def _route(logits: torch.Tensor, token_mask, c: int, dt):
    """:func:`_route_local`; on a DTensor, on each rank's groups with
    every group whole: the routing of a group (its argmax, its
    capacity count down the tokens) needs all of its tokens, so a group
    split over ``data`` is gathered first, and every rank routes it the
    same way."""
    def where(_):
        groups = with_dims(logits.placements, {1: None, 2: None})
        # with a token mask a group is a row: the mask's rows go as groups
        return ((groups, None if token_mask is None else groups),
                (groups,) * 5)

    return on_shards(lambda lg, m: _route_local(lg, m, c, dt),
                     (logits, token_mask), where)


def apply_moe(p, cfg, x: torch.Tensor, capacity_factor: float | None = None,
              token_mask: torch.Tensor | None = None):
    """x: (B, T, D) -> (y (B, T, D), aux).

    The B * T tokens form groups of ``_group_size(B * T)``. With
    ``token_mask`` (B, T) bool each row is a group, and a False token
    (serving pad) takes no capacity, adds nothing to the aux statistics
    and gets y = 0: a row routes as it would alone.
    """
    B, T, D = x.shape
    E = cfg.moe_num_experts
    if capacity_factor is None:
        capacity_factor = cfg.moe_capacity_factor
    dt = x.dtype
    if token_mask is not None:
        s, n = T, B
    else:
        s = _group_size(B * T)
        n = B * T // s
    c = int(max(1, round(s * capacity_factor / E)))
    xg = hint(x.reshape(n, s, D), ("pod", "data"), None, None)

    logits = (xg @ p["router"].to(dt)).float()                # (n, s, E)
    probs, gate, onehot_e, keep, disp = _route(logits, token_mask, c, dt)
    disp = hint(disp, ("pod", "data"), None, "model", None)

    buf = torch.einsum("nsec,nsd->necd", disp, xg)            # (n, E, c, D)
    buf = hint(buf, ("pod", "data"), "model", None, None)
    up = torch.einsum("necd,edf->necf", buf, p["w_up"].to(dt))
    up = hint(up, ("pod", "data"), "model", None, None)
    if "w_gate" in p:
        g = torch.einsum("necd,edf->necf", buf, p["w_gate"].to(dt))
        g = hint(g, ("pod", "data"), "model", None, None)
        act = F.silu(g) if cfg.mlp_variant == "swiglu" \
            else F.gelu(g, approximate="tanh")
        h = act * up
    else:
        h = F.gelu(up, approximate="tanh")
    out = torch.einsum("necf,efd->necd", h, p["w_down"].to(dt))
    out = hint(out, ("pod", "data"), "model", None, None)
    y = torch.einsum("nsec,necd->nsd", disp, out)             # (n, s, D)
    y = hint(y, ("pod", "data"), None, None)
    y = y * gate[..., None].to(dt)
    if token_mask is not None:
        keep_tok = token_mask.reshape(n, s).float()

    # aux: over the real tokens only when a token_mask is given
    lse2 = torch.logsumexp(logits, dim=-1) ** 2
    if token_mask is None:
        frac_tokens = torch.mean(onehot_e, dim=(0, 1))        # f_e
        frac_probs = torch.mean(probs, dim=(0, 1))            # p_e
        z_loss = torch.mean(lse2)
        drop_frac = 1.0 - torch.mean(keep.float())
    else:
        n_real = torch.clamp(torch.sum(keep_tok), min=1.0)
        frac_tokens = torch.sum(onehot_e, dim=(0, 1)) / n_real
        frac_probs = torch.sum(probs * keep_tok[..., None],
                               dim=(0, 1)) / n_real
        z_loss = torch.sum(lse2 * keep_tok) / n_real
        drop_frac = 1.0 - torch.sum(keep.float() * keep_tok) / n_real
    aux = {"load_balance": E * torch.sum(frac_tokens * frac_probs),
           "router_z": z_loss, "drop_frac": drop_frac}
    return y.reshape(B, T, D), aux


__all__ = ["apply_moe", "init_moe"]
