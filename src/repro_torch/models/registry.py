"""Model registry — the port of ``repro/models/registry.py``.

``build_model(cfg)`` returns a :class:`ModelApi`. Parameters are nested
dicts of tensors; ``abstract_params`` gives their shapes (on the
``meta`` device, so nothing is allocated) beside the logical-axes tree.
The serving methods (prefill, decode, ring and paged caches) call
:mod:`repro_torch.serving.engine`, every kind (the paged cache and
chunked prefill are token-only: the vlm, encdec and audio kinds raise);
they update the caches they are given in place. ``batch`` passes
through as given, so the vlm kind's ``patches`` and the encdec and
audio kinds' ``frames`` reach the forward, the loss and the prefill.
The moe kind's ``loss`` adds the routers' aux losses. ``remat`` on
``loss`` and ``forward`` (default True, as in the reference)
rematerializes the layers' activations in the backward (see
:mod:`repro_torch.models.transformer`). ``use_kernel``
on ``forward``, ``loss``, ``prefill`` and ``prefill_chunk`` sends the
ssm kind's scans from a zero state through the ``ssd_scan`` kernel
(forward only). Under a mesh the caches are DTensors placed by the
serve cache rules (``init_cache(mesh=)``, ``init_paged_cache(mesh=)``);
``cache_axes``, ``paged_cache_axes``, ``abstract_cache`` and
``abstract_paged_cache`` give their logical axes and ``meta`` shapes,
as the reference's do. ``input_specs`` gives the dry run's stand-ins
for a step's inputs, as ``meta`` tensors.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models import transformer as tfm
from repro_torch.models.common import params_from_jax, tree_map
from repro_torch.serving import engine as serve


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
    def loss(self, params, batch, *, dtype=torch.bfloat16, remat=True,
             use_kernel=False):
        return tfm.loss_fn(params, self.cfg, batch, dtype=dtype,
                           remat=remat, use_kernel=use_kernel)

    def forward(self, params, batch, *, dtype=torch.bfloat16, remat=True,
                use_kernel=False):
        return tfm.forward(params, self.cfg, batch, dtype=dtype,
                           remat=remat, use_kernel=use_kernel)

    # -- serving --------------------------------------------------------
    def prefill(self, params, batch, *, dtype=torch.bfloat16,
                cache_dtype=torch.bfloat16, serve_window=0, cache_len=None,
                lengths=None, use_kernel=False):
        return serve.prefill(params, self.cfg, batch, dtype=dtype,
                             cache_dtype=cache_dtype,
                             serve_window=serve_window, cache_len=cache_len,
                             lengths=lengths, use_kernel=use_kernel)

    def write_cache_slot(self, cache, one_cache, slot, *, pos=None,
                         one_pos=None):
        return serve.write_cache_slot(self.cfg, cache, one_cache, slot,
                                      pos=pos, one_pos=one_pos)

    def decode_step(self, params, token, cache, pos, *, dtype=torch.bfloat16,
                    serve_window=0):
        return serve.decode_step(params, self.cfg, token, cache, pos,
                                 dtype=dtype, serve_window=serve_window)

    def init_cache(self, batch, seq_len, dtype=torch.bfloat16,
                   serve_window=0, *, device=None, mesh=None,
                   cache_rules=None):
        return serve.init_cache_tree(self.cfg, batch, seq_len, dtype,
                                     serve_window=serve_window, device=device,
                                     mesh=mesh, cache_rules=cache_rules)

    def abstract_cache(self, batch, seq_len, dtype=torch.bfloat16,
                       serve_window=0):
        """The ring-cache tree as ``meta`` tensors — no allocation."""
        return serve.init_cache_tree(self.cfg, batch, seq_len, dtype,
                                     serve_window=serve_window,
                                     device="meta")

    def cache_axes(self, long_context: bool = False):
        """The ring cache's logical axes. ``long_context`` is the
        reference's flag: the axes are the same, and the long-context
        layout comes from the table they resolve under
        (``launch.steps.CACHE_RULES_LONG``)."""
        return serve.cache_logical_axes_tree(self.cfg)

    # -- paged serving --------------------------------------------------
    def prefill_chunk(self, params, cache, tokens, start, valid, page_row,
                      slot, *, dtype=torch.float32, serve_window=0,
                      use_kernel=False):
        return serve.prefill_chunk(params, self.cfg, cache, tokens, start,
                                   valid, page_row, slot, dtype=dtype,
                                   serve_window=serve_window,
                                   use_kernel=use_kernel)

    def decode_step_paged(self, params, token, cache, pos, page_map, live,
                          *, dtype=torch.bfloat16, serve_window=0,
                          use_kernel=False):
        return serve.decode_step_paged(params, self.cfg, token, cache, pos,
                                       page_map, live, dtype=dtype,
                                       serve_window=serve_window,
                                       use_kernel=use_kernel)

    def init_paged_cache(self, slots, num_pages, page_size,
                         dtype=torch.bfloat16, *, device=None, mesh=None,
                         cache_rules=None):
        return serve.init_paged_cache_tree(self.cfg, slots, num_pages,
                                           page_size, dtype, device=device,
                                           mesh=mesh,
                                           cache_rules=cache_rules)

    def abstract_paged_cache(self, slots, num_pages, page_size,
                             dtype=torch.bfloat16):
        """The paged-cache tree as ``meta`` tensors — no allocation."""
        return serve.init_paged_cache_tree(self.cfg, slots, num_pages,
                                           page_size, dtype, device="meta")

    def paged_cache_axes(self):
        return serve.paged_cache_logical_axes_tree(self.cfg)


    # -- abstract inputs (dry run) ---------------------------------------
    def input_specs(self, shape: InputShape, *, serve_window: int = 0,
                    cache_dtype=torch.bfloat16) -> dict:
        """``meta`` stand-ins for every input of the step that ``shape``
        exercises (train/prefill: the token batch and the stub frontend
        embeddings; decode: one token, the full cache and ``pos``), the
        reference's shapes and dtypes."""
        cfg = self.cfg
        B, T = shape.global_batch, shape.seq_len
        i32 = torch.int32

        def meta(shape_, dtype):
            return torch.empty(shape_, dtype=dtype, device="meta")

        def frontend(specs):
            name = {"vlm": "patches", "encdec": "frames",
                    "audio": "frames"}.get(cfg.kind)
            if name:
                specs[name] = meta((B, cfg.enc_seq_len, cfg.d_model),
                                   torch.bfloat16)
            return specs

        t_text = T - (cfg.enc_seq_len if cfg.kind == "vlm" else 0)
        if shape.phase == "train":
            return {"batch": frontend({"tokens": meta((B, t_text), i32),
                                       "labels": meta((B, t_text), i32)})}
        if shape.phase == "prefill":
            return {"batch": frontend({"tokens": meta((B, t_text), i32)})}
        # decode: one token against a cache of length T
        return {"token": meta((B, 1), i32),
                "cache": self.abstract_cache(B, T, cache_dtype,
                                             serve_window=serve_window),
                "pos": meta((), i32)}


def build_model(cfg: ModelConfig) -> ModelApi:
    return ModelApi(cfg)


__all__ = ["ModelApi", "build_model", "params_from_jax"]
