"""Serving-side sharding — the port of ``repro/serving/sharding.py``: the
rule tables and resolved placements that thread
:mod:`repro_torch.dist` through the serving engine.

Two tables:

* :data:`SERVE_PARAM_RULES` — weights tensor-parallel over ``model``
  (heads / ffn / experts), replicated over the replica axes (latency
  path); expert weights additionally FSDP-sharded over ``(pod, data)``
  (memory).
* :data:`SERVE_CACHE_RULES` — cache leaves sharded along heads/experts
  first (``cache_kv_heads`` / ``ssm_heads`` / ``rnn_width`` over
  ``model``), with ``cache_seq`` as the model-axis FALLBACK for configs
  whose head count does not divide the mesh (table order is the
  priority — see ``ShardingRules.spec_for_shape``), and the slot/batch
  dimension over the replica axes when it divides.

All resolution is shape-aware (``spec_for_shape``): a small config on a
big mesh degrades toward replication instead of failing to place, so
one table serves a host mesh of gloo ranks and the 512-chip geometry.

A resolved leaf is a spec (a tuple, JAX's ``PartitionSpec``) turned
into DTensor placements (:func:`repro_torch.dist.sharding.placements`,
JAX's ``NamedSharding``). :func:`serve_shardings` bundles the
placements of one (model, mesh, slot geometry) into a
:class:`ServeShardings`. The schedulers place their caches by
:data:`SERVE_CACHE_RULES` and their tokens and logits by
:func:`token_placements`, and the admission splice
(``write_cache_slot``) writes into that layout without resharding.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch

from repro_torch.dist.sharding import (
    ShardingRules, distribute_like, placements)
from repro_torch.models.common import tree_from_items, tree_items

# Params: tensor-parallel over model, replicated over (pod, data) —
# the latency path keeps every replica axis free for cache slots.
# Expert weights stay FSDP-sharded (the giant-MoE memory story).
SERVE_PARAM_RULES = ShardingRules((
    ("batch", ("pod", "data")),
    ("embed", None),
    ("embed_nomodel", None),
    ("vocab", "model"),
    ("q_proj", "model"),
    ("kv_proj", "model"),
    ("ffn", "model"),
    ("experts", "model"),
    ("expert_ffn", None),
    ("experts_router", None),
    ("embed_fsdp", ("pod", "data")),
    ("ssm_in", "model"),
    ("ssm_heads", "model"),
    ("ssm_state", None),
    ("rnn_width", "model"),
    ("rnn_width_in", None),
    ("conv_k", None),
    ("layers", None),
))

# Cache leaves: heads/experts first, sequence as the model-axis
# fallback (table order = contention priority under spec_for_shape).
# Paged leaves reuse the same head/TP placement; the page pool and
# in-page offset dims stay replicated (pages are the unit of host-side
# allocation — splitting them across devices would turn every page-map
# gather into a collective).
SERVE_CACHE_RULES = ShardingRules((
    ("cache_kv_heads", "model"),
    ("ssm_heads", "model"),
    ("rnn_width", "model"),
    ("ssm_in", "model"),
    ("cache_seq", "model"),
    ("cache_batch", ("pod", "data")),
    ("cache_pages", None),
    ("page_off", None),
    ("head_dim", None),
    ("ssm_state", None),
    ("layers", None),
))


def specs_for(axes_tree, shaped_tree, mesh, rules: ShardingRules):
    """Per-leaf spec from (logical axes, tensors or ``meta`` tensors of
    the same structure)."""
    ax = tree_items(axes_tree)
    sh = tree_items(shaped_tree)
    assert len(ax) == len(sh), (len(ax), len(sh))
    out = []
    for (path, a), (spath, s) in zip(ax, sh):
        assert path == spath, (path, spath)
        out.append((path, rules.spec_for_shape(tuple(a), tuple(s.shape),
                                               mesh)))
    return tree_from_items(out)


def _shard_shaped(axes_tree, shaped_tree, mesh, rules: ShardingRules):
    """Per-leaf DTensor placements from (logical axes, shapes)."""
    specs = specs_for(axes_tree, shaped_tree, mesh, rules)
    return tree_from_items((path, placements(spec, mesh))
                           for path, spec in tree_items(specs))


def param_shardings(model, mesh, *, rules: Optional[ShardingRules] = None,
                    param_dtype=torch.float32):
    """Shape-aware serve-phase placements tree for the params."""
    rules = rules or SERVE_PARAM_RULES
    abs_p, axes = model.abstract_params(dtype=param_dtype)
    return _shard_shaped(axes, abs_p, mesh, rules)


def cache_shardings(model, mesh, batch: int, seq_len: int,
                    dtype=torch.bfloat16, *, serve_window: int = 0,
                    cache_rules: Optional[ShardingRules] = None):
    """Placements tree matching ``init_cache_tree``'s structure."""
    rules = cache_rules or SERVE_CACHE_RULES
    abs_c = model.abstract_cache(batch, seq_len, dtype,
                                 serve_window=serve_window)
    return _shard_shaped(model.cache_axes(), abs_c, mesh, rules)


def paged_cache_shardings(model, mesh, slots: int, cache_pages: int,
                          page_size: int, dtype=torch.bfloat16, *,
                          cache_rules: Optional[ShardingRules] = None):
    """Placements tree matching ``init_paged_cache_tree``'s structure:
    heads TP over ``model``, page/offset dims replicated."""
    rules = cache_rules or SERVE_CACHE_RULES
    abs_c = model.abstract_paged_cache(slots, cache_pages, page_size, dtype)
    return _shard_shaped(model.paged_cache_axes(), abs_c, mesh, rules)


def token_placements(model, mesh, slots: int, *,
                     cache_rules: Optional[ShardingRules] = None
                     ) -> tuple:
    """(sampled tokens (slots, 1), logits (slots, 1, padded vocab))
    placements: the slots over the replica axes where they divide, as
    the cache's ``cache_batch``."""
    rules = cache_rules or SERVE_CACHE_RULES
    V = model.cfg.padded_vocab   # logits carry the padded width
    tok = placements(rules.spec_for_shape(
        ("cache_batch", None), (slots, 1), mesh), mesh)
    lg = placements(rules.spec_for_shape(
        ("cache_batch", None, None), (slots, 1, V), mesh), mesh)
    return tok, lg


@dataclass(frozen=True)
class ServeShardings:
    """Resolved placements for one (model, mesh, slot geometry)."""
    mesh: Any
    rules: ShardingRules            # param table
    cache_rules: ShardingRules      # cache table
    params: Any                     # placements tree
    cache: Any                      # placements tree
    token: tuple                    # (slots, 1) int32
    logits: tuple                   # (slots, 1, vocab)
    pos: tuple                      # (slots,) int32
    replicated: tuple
    # paged layout (set when serve_shardings gets page_size > 0)
    paged_cache: Any = None         # placements tree (page pools)
    page_map: Optional[tuple] = None    # (slots, pages_per_slot)
    live: Optional[tuple] = None        # (slots,) bool


def serve_shardings(model, mesh, *, slots: int, max_total: int,
                    dtype=torch.float32, serve_window: int = 0,
                    param_dtype=None, page_size: int = 0,
                    cache_pages: int = 0,
                    rules: Optional[ShardingRules] = None,
                    cache_rules: Optional[ShardingRules] = None
                    ) -> ServeShardings:
    """Resolve every placement the serving stack builds its state in.

    ``dtype`` is the cache dtype (shapes only — resolution is dtype-
    free); ``param_dtype`` defaults to ``dtype``. Pass ``page_size`` /
    ``cache_pages`` to also resolve the paged cache tree and its
    page-map/live inputs (replicated — they are tiny i32/bool control
    state every rank needs whole).
    """
    rules = rules or SERVE_PARAM_RULES
    cache_rules = cache_rules or SERVE_CACHE_RULES
    p_sh = param_shardings(model, mesh, rules=rules,
                           param_dtype=param_dtype or dtype)
    c_sh = cache_shardings(model, mesh, slots, max_total, dtype,
                           serve_window=serve_window,
                           cache_rules=cache_rules)
    tok, lg = token_placements(model, mesh, slots, cache_rules=cache_rules)
    repl = placements((), mesh)
    paged_kw = {}
    if page_size:
        paged_kw = dict(
            paged_cache=paged_cache_shardings(
                model, mesh, slots, cache_pages, page_size, dtype,
                cache_rules=cache_rules),
            page_map=repl, live=repl)
    return ServeShardings(
        mesh=mesh, rules=rules, cache_rules=cache_rules, params=p_sh,
        cache=c_sh, token=tok, logits=lg, pos=repl, replicated=repl,
        **paged_kw)


def shard_params(params, model, mesh, *,
                 rules: Optional[ShardingRules] = None):
    """Place a live param tree onto ``mesh`` under the serve rules (every
    rank made the same tree from the same seed)."""
    rules = rules or SERVE_PARAM_RULES
    _, axes = model.abstract_params()
    sh = _shard_shaped(axes, params, mesh, rules)
    return tree_from_items(
        (path, distribute_like(x, mesh, pl)) for (path, x), (_, pl)
        in zip(tree_items(params), tree_items(sh)))


__all__ = ["SERVE_PARAM_RULES", "SERVE_CACHE_RULES", "ServeShardings",
           "cache_shardings", "paged_cache_shardings",
           "param_shardings", "serve_shardings", "shard_params",
           "specs_for", "token_placements"]
