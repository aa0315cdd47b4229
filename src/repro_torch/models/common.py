"""Shared model-zoo building blocks — the port of ``repro/models/
common.py``: params-with-logical-axes, norms, rotary embeddings,
initializers and the cross-entropy loss.

Parameters are plain nested dicts of tensors. Sharding is expressed by a
*parallel* nested dict of logical-axis tuples made at init time: every
init function returns ``Px(tensor, logical_axes)`` leaves and
:func:`split_tree` separates them into (params, axes), so the axes live
beside the parameters, never inside them.

Leaf order is the reference's: JAX flattens a dict in sorted key order,
and :func:`tree_items` walks a nested dict the same way, so a flat
buffer built from it (``core.distributed.FlatParamSpec``) has the
reference's offsets column for column.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

Tree = dict
Path = tuple[str, ...]


class Px(NamedTuple):
    """A parameter leaf bundled with its logical sharding axes."""
    value: Any
    axes: tuple


# ---------------------------------------------------------------------------
# nested-dict trees (the reference's pytrees of dicts)
# ---------------------------------------------------------------------------

def tree_items(tree: Tree, prefix: Path = ()) -> list[tuple[Path, Any]]:
    """(key path, leaf) pairs in JAX's flatten order (sorted keys,
    depth first)."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.extend(tree_items(v, prefix + (k,)))
        else:
            out.append((prefix + (k,), v))
    return out


def tree_leaves(tree: Tree) -> list:
    return [v for _, v in tree_items(tree)]


def tree_from_items(items) -> Tree:
    """(key path, leaf) pairs -> a nested dict with sorted keys."""
    tree: Tree = {}
    for path, leaf in items:
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return _sorted(tree)


def _sorted(tree: Tree) -> Tree:
    return {k: _sorted(tree[k]) if isinstance(tree[k], dict) else tree[k]
            for k in sorted(tree)}


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over matching leaves of trees of one structure."""
    return {k: (tree_map(fn, v, *(r[k] for r in rest))
                if isinstance(v, dict) else fn(v, *(r[k] for r in rest)))
            for k, v in sorted(tree.items())}


def params_from_jax(tree: Tree, device) -> Tree:
    """The reference's parameters, as numpy arrays (a dict, nested or
    not), -> the port's dict of tensors on ``device`` with sorted keys
    (the reference's leaf order), dtypes kept."""
    return tree_map(
        lambda v: torch.from_numpy(np.array(v, copy=True)).to(device), tree)


def split_tree(tree: Tree) -> tuple[Tree, Tree]:
    """Tree of Px -> (params, logical_axes) with identical structure."""
    params, axes = {}, {}
    for k in sorted(tree):
        v = tree[k]
        params[k], axes[k] = (split_tree(v) if isinstance(v, dict)
                              else (v.value, tuple(v.axes)))
    return params, axes


# ---------------------------------------------------------------------------
# initializers (take an explicit generator, produce Px)
# ---------------------------------------------------------------------------

def _normal(gen: Optional[torch.Generator], shape, device) -> torch.Tensor:
    # the meta device allocates nothing and takes no generator
    if torch.device(device).type == "meta":
        gen = None
    return torch.randn(shape, generator=gen, device=device,
                       dtype=torch.float32)


def dense_init(gen, shape, axes, *, device, scale: float = 1.0,
               fan_in: Optional[int] = None) -> Px:
    fan = fan_in if fan_in is not None else shape[0]
    std = scale / math.sqrt(max(fan, 1))
    return Px(_normal(gen, shape, device) * std, axes)


def embed_init(gen, vocab: int, dim: int, axes, *, device) -> Px:
    return Px(_normal(gen, (vocab, dim), device) * 0.02, axes)


def zeros_init(shape, axes, *, device) -> Px:
    return Px(torch.zeros(shape, device=device), axes)


def ones_init(shape, axes, *, device) -> Px:
    return Px(torch.ones(shape, device=device), axes)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    # gemma convention: multiply by (1 + scale)
    return (y * (1.0 + scale.float())).to(dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
    y = (x - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dtype)


def norm_init(cfg, dim: int, *, device) -> dict:
    if cfg.norm == "rmsnorm":
        return {"scale": zeros_init((dim,), ("embed_nomodel",),
                                    device=device)}
    return {"scale": ones_init((dim,), ("embed_nomodel",), device=device),
            "bias": zeros_init((dim,), ("embed_nomodel",), device=device)}


def apply_norm(cfg, p: dict, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "rmsnorm":
        return rmsnorm(x, p["scale"])
    return layernorm(x, p["scale"], p["bias"])


# ---------------------------------------------------------------------------
# positions
# ---------------------------------------------------------------------------

def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float = 10_000.0
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The float32 (cos, sin) of :func:`rope` at ``positions`` (..., T),
    each (..., T, 1, head_dim // 2): a caller that rotates several
    tensors at the same positions (every layer of a decode step) makes
    them once."""
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32,
                         device=positions.device) / half
    freq = torch.pow(theta, exps)
    ang = positions[..., :, None].float() * freq         # (..., T, half)
    return torch.cos(ang)[..., :, None, :], torch.sin(ang)[..., :, None, :]


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotate x: (..., T, n, hd) by the angles of :func:`rope_angles`."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10_000.0) -> torch.Tensor:
    """Rotary embeddings, half-split layout with float32 angles.
    x: (..., T, n, hd); positions: (..., T)."""
    return apply_rope(x, *rope_angles(positions, x.shape[-1], theta))


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def softmax_cross_entropy(logits: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """Mean token NLL; logits (..., V), labels int (...). The
    logsumexp runs in float32 over every column, padded vocab rows
    included."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - ll)


__all__ = [
    "Px", "apply_norm", "dense_init", "embed_init", "layernorm",
    "apply_rope", "norm_init", "ones_init", "params_from_jax", "rmsnorm",
    "rope", "rope_angles",
    "softmax_cross_entropy",
    "split_tree", "tree_from_items", "tree_items", "tree_leaves",
    "tree_map", "zeros_init",
]
