"""Pytree checkpoints in the reference's file format — the port of
``repro/checkpoint/ckpt.py``.

One ``.npz`` holds the leaves as ``leaf_0 .. leaf_{n-1}`` and the tree's
structure as ``__index__``: the JSON of the tree with each leaf replaced
by its number, dicts as ``{"__d__": {...}}`` and lists/tuples as
``{"__l__": [...], "__t__": is_tuple}``. Trees are dicts, lists and
tuples of tensors, numpy arrays or numbers; dict keys are walked in
sorted order, as ``jax.tree`` flattens them, so ``leaf_i`` names the
same leaf in both packages' files and a checkpoint written by either
restores in the other.

Tensors are copied to the host (``.detach().cpu()``, then copied again
where that is a view of a CPU tensor the caller may update in place);
restore returns numpy leaves, which the caller places on its device
(``ScaleTrainer.restore`` does, in its carrier).
"""
from __future__ import annotations

import json
from typing import Any, Optional

import numpy as np
import torch


def _npz_path(path: str) -> str:
    """The path np.savez actually writes: it silently appends ``.npz``
    when the suffix is missing. Save and restore both normalize through
    here, so an extensionless path round-trips."""
    return path if str(path).endswith(".npz") else str(path) + ".npz"


def _to_numpy(x: Any) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        host = x.cpu()
        # a CPU tensor's .cpu() is itself: copy, so that the file holds
        # the value at save time even if the trainer updates it in place
        return (host.clone() if host is x else host).numpy()
    return np.asarray(x)


def _flatten(tree, leaves: list):
    """The index tree of ``tree`` (leaves replaced by their numbers, in
    ``jax.tree``'s order), appending the leaves to ``leaves``."""
    if isinstance(tree, dict):
        return {"__d__": {k: _flatten(tree[k], leaves)
                          for k in sorted(tree)}}
    if isinstance(tree, (list, tuple)):
        return {"__l__": [_flatten(v, leaves) for v in tree],
                "__t__": isinstance(tree, tuple)}
    leaves.append(_to_numpy(tree))
    return len(leaves) - 1


def _unflatten(t, leaves):
    if isinstance(t, dict) and "__d__" in t:
        return {k: _unflatten(v, leaves) for k, v in t["__d__"].items()}
    if isinstance(t, dict) and "__l__" in t:
        seq = [_unflatten(v, leaves) for v in t["__l__"]]
        return tuple(seq) if t.get("__t__") else seq
    return leaves[t]


def save_pytree(path: str, tree) -> None:
    leaves: list = []
    index = _flatten(tree, leaves)
    arrays = {f"leaf_{i}": x for i, x in enumerate(leaves)}
    arrays["__index__"] = np.frombuffer(json.dumps(index).encode(),
                                        dtype=np.uint8)
    np.savez(_npz_path(path), **arrays)


def restore_pytree(path: str):
    """The saved tree, its leaves as numpy arrays."""
    with np.load(_npz_path(path), allow_pickle=False) as data:
        idx = json.loads(bytes(data["__index__"].tobytes()).decode())
        leaves = {int(k[5:]): data[k] for k in data.files
                  if k.startswith("leaf_")}
    return _unflatten(idx, leaves)


def save_train_state(path: str, params, opt_state, step: int,
                     extra: Optional[dict] = None) -> None:
    save_pytree(path, {"params": params, "opt_state": opt_state,
                       "step": np.asarray(step),
                       "extra": extra or {}})


def restore_train_state(path: str):
    t = restore_pytree(path)
    return t["params"], t["opt_state"], int(t["step"]), t.get("extra", {})


__all__ = ["restore_pytree", "restore_train_state", "save_pytree",
           "save_train_state"]
