"""Model registry — the port of ``repro/models/registry.py``, training
part.

``build_model(cfg)`` returns a :class:`ModelApi`. Parameters are nested
dicts of tensors; ``abstract_params`` gives their shapes (on the
``meta`` device, so nothing is allocated) beside the logical-axes tree.
The serving methods (prefill, decode, caches) come with ROADMAP.md
Queue 1 item 7.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tfm
from repro_torch.models.common import params_from_jax, tree_map


@dataclass(frozen=True)
class ModelApi:
    cfg: ModelConfig

    # -- params ---------------------------------------------------------
    def init(self, generator: torch.Generator, device,
             dtype=torch.float32) -> dict:
        """A fresh parameter tree on ``device`` from ``generator`` (the
        reference's distributions: normal weights scaled by
        1/sqrt(fan-in), 0.02 embeddings, zero biases and RMSNorm
        scales)."""
        params, _ = tfm.init_tree(generator, self.cfg, device=device)
        if dtype != torch.float32:
            params = tree_map(lambda x: x.to(dtype), params)
        return params

    def abstract_params(self, dtype=torch.float32) -> tuple[dict, dict]:
        """(tree of ``meta`` tensors, logical-axes tree) — no allocation."""
        params, axes = tfm.init_tree(None, self.cfg, device="meta")
        return tree_map(lambda x: x.to(dtype), params), axes

    # -- training -------------------------------------------------------
    def loss(self, params, batch, *, dtype=torch.bfloat16):
        return tfm.loss_fn(params, self.cfg, batch, dtype=dtype)

    def forward(self, params, batch, *, dtype=torch.bfloat16):
        return tfm.forward(params, self.cfg, batch, dtype=dtype)


def build_model(cfg: ModelConfig) -> ModelApi:
    return ModelApi(cfg)


__all__ = ["ModelApi", "build_model", "params_from_jax"]
