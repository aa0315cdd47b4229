"""Minimal optimizers — the port of ``repro/optim/optimizers.py``.

The reference's optax-like API on dicts of tensors: ``opt.init(params)
-> state``; ``opt.update(grads, state, params, lr) -> (updates, state)``
where ``updates`` are to be *added* to the params (``apply_updates``).
``lr`` (a float or a 0-d tensor) is passed per call so that a schedule
stays outside the optimizer state; it is taken as a float32 value, as
the reference's is. Every update keeps the reference's order of
operations, so float32 agrees with it to rounding. AdamW's ``count`` is
a 0-d int32 tensor on the params' device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.models.common import tree_leaves, tree_map


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[..., tuple[Any, Any]]
    name: str = "opt"


def _zeros_like_tree(params):
    return tree_map(torch.zeros_like, params)


def _f32(lr) -> float:
    """``lr`` rounded to float32, as a Python float (exact)."""
    return float(torch.as_tensor(lr, dtype=torch.float32))


def sgd(weight_decay: float = 0.0) -> Optimizer:
    """Plain SGD — the paper's optimizer (eq. 9)."""
    def init(params):
        return ()

    def update(grads, state, params, lr):
        neg = -_f32(lr)

        def u(g, p):
            g = g.to(p.dtype)
            if weight_decay:
                g = g + torch.as_tensor(weight_decay, dtype=p.dtype,
                                        device=p.device) * p
            # lr cast to the param dtype first, as the reference does
            return torch.as_tensor(neg, dtype=p.dtype, device=p.device) * g
        return tree_map(u, grads, params), state

    return Optimizer(init, update, "sgd")


def momentum(beta: float = 0.9, weight_decay: float = 0.0,
             nesterov: bool = False) -> Optimizer:
    def init(params):
        return {"m": _zeros_like_tree(params)}

    def update(grads, state, params, lr):
        neg = -_f32(lr)

        def step(g, m, p):
            g = g + weight_decay * p if weight_decay else g
            m_new = beta * m + g
            d = g + beta * m_new if nesterov else m_new
            return (neg * d).to(p.dtype), m_new

        out = tree_map(step, grads, state["m"], params)
        return (tree_map(lambda t: t[0], out),
                {"m": tree_map(lambda t: t[1], out)})

    return Optimizer(init, update, "momentum")


def adamw(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return {"m": _zeros_like_tree(params),
                "v": _zeros_like_tree(params),
                "count": torch.zeros((), dtype=torch.int32,
                                     device=tree_leaves(params)[0].device)}

    def update(grads, state, params, lr):
        neg = -_f32(lr)
        count = state["count"] + 1
        c1 = 1 - b1 ** count.float()
        c2 = 1 - b2 ** count.float()

        def step(g, m_, v_, p):
            g32 = g.float()
            m_new = b1 * m_ + (1 - b1) * g32
            v_new = b2 * v_ + (1 - b2) * (g32 * g32)
            upd = (m_new / c1) / (torch.sqrt(v_new / c2) + eps)
            if weight_decay:
                upd = upd + weight_decay * p.float()
            return (neg * upd).to(p.dtype), m_new, v_new

        out = tree_map(step, grads, state["m"], state["v"], params)
        return (tree_map(lambda t: t[0], out),
                {"m": tree_map(lambda t: t[1], out),
                 "v": tree_map(lambda t: t[2], out), "count": count})

    return Optimizer(init, update, "adamw")


def make_optimizer(name: str, *, momentum_beta: float = 0.9,
                   weight_decay: float = 0.0) -> Optimizer:
    if name == "sgd":
        return sgd(weight_decay)
    if name == "momentum":
        return momentum(momentum_beta, weight_decay)
    if name == "adamw":
        return adamw(weight_decay=weight_decay)
    raise ValueError(f"unknown optimizer {name!r}")


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u, params, updates)


__all__ = ["Optimizer", "adamw", "apply_updates", "make_optimizer",
           "momentum", "sgd"]
