"""Sharded step builders — the port of ``repro/launch/steps.py``: the
train, prefill and decode steps, the serving pairs, and the rule tables
that place their inputs on a mesh.

This is the one place where logical axes meet the mesh: a phase is
re-sharded by editing its table (or passing overrides), not model code.

A builder returns ``(fn, abstract_args)``. ``fn`` is a :class:`Program`:
the step bound to a ``DeviceMesh`` with the placements of its inputs
(the reference's ``in_shardings``) and, where the reference pins them,
of its outputs. Called with plain tensors that every rank holds whole,
it keeps each rank's shard (no communication); DTensors in another
layout are redistributed. ``abstract_args`` are ``meta`` tensors of the
inputs' global shapes and dtypes; host values (a slot, a chunk's start)
are Python values, as the port's engine takes them on the host. The dry
run (:mod:`repro_torch.launch.dryrun`) turns them into fake DTensors.

What the reference has and the port does not: ``remat`` (the port keeps
every activation for the backward) and buffer donation. Instead the
train step updates the parameters it is given in place (as
``ScaleTrainer`` does) and returns them; the optimizer state is
returned anew. The serving programs write the caches they are given in
place, as the port's engine does.

The serving programs run what the port's schedulers run on a card: the
ssm kind's prefill scans through the ``ssd_scan`` wrapper and the paged
decode's attention through ``paged_decode`` (on a CPU tensor each
wrapper runs its plain version).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.core.distributed import _loss_and_grads
from repro_torch.dist.sharding import (
    ShardingRules, distribute_like, from_shard, is_dtensor,
    mesh_axis_sizes, placements, use_mesh, write_rows)
from repro_torch.models.common import tree_from_items, tree_items
from repro_torch.models.registry import ModelApi
from repro_torch.optim import make_optimizer

# ---------------------------------------------------------------------------
# rule tables per phase
# ---------------------------------------------------------------------------

TRAIN_RULES = ShardingRules((
    ("batch", ("pod", "data")),
    # params: FSDP over (pod, data) on d_model dims, tensor over model
    ("embed", ("pod", "data")),
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
    ("rnn_width_in", ("pod", "data")),
    ("conv_k", None),
    ("layers", None),
))

# Serving: weights replicated over data (latency path), tensor-parallel
# over model; expert weights stay FSDP-sharded (memory). The table lives
# with the serving stack; re-exported here so that the rule tables of
# every phase are edited in one module.
from repro_torch.serving.sharding import (  # noqa: E402
    SERVE_CACHE_RULES, SERVE_PARAM_RULES as SERVE_RULES, serve_shardings)

CACHE_RULES_DECODE = ShardingRules((
    ("cache_batch", ("pod", "data")),
    ("cache_seq", "model"),
    ("cache_kv_heads", None),
    ("head_dim", None),
    ("ssm_heads", "model"),
    ("ssm_state", None),
    ("ssm_in", "model"),
    ("rnn_width", "model"),
    ("layers", None),
))

# long_500k: batch = 1 -> parallelize over the sequence/state dims.
CACHE_RULES_LONG = CACHE_RULES_DECODE.with_overrides(
    cache_batch=None,
    cache_seq=("pod", "data", "model"),
)


def _is_placements(x) -> bool:
    from torch.distributed.tensor import Placement
    return (isinstance(x, tuple) and len(x) > 0
            and all(isinstance(p, Placement) for p in x))


def shard_tree(tree_axes, mesh, rules: ShardingRules):
    """Placements of every leaf of a logical-axes tree under ``rules``
    (the reference's ``_shard``: shape-blind ``rules.spec``)."""
    return tree_from_items((path, placements(rules.spec(tuple(ax), mesh),
                                             mesh))
                           for path, ax in tree_items(tree_axes))


def replicated(mesh) -> tuple:
    return placements((), mesh)


def batch_shardings(batch_specs: dict, mesh, rules: ShardingRules) -> dict:
    """Each batch leaf's rows over the table's ``batch`` axes."""
    return {k: placements(rules.spec(("batch",) + (None,) * (v.ndim - 1),
                                     mesh), mesh)
            for k, v in batch_specs.items()}


def place(value, where, mesh):
    """``value`` (a tensor, or tuples, lists and dicts of them) in the
    layout ``where`` of the same structure: a placements tuple per
    tensor, None for a value left as it is. A plain tensor is taken as
    held whole by every rank, which keeps its shard; a DTensor in
    another layout is redistributed."""
    if where is None:
        return value
    if _is_placements(where):
        if is_dtensor(value):
            if tuple(value.placements) == where:
                return value
            return value.redistribute(value.device_mesh, list(where))
        return distribute_like(value, mesh, where)
    if isinstance(value, dict):
        return {k: place(v, where[k], mesh) for k, v in value.items()}
    if isinstance(value, (tuple, list)):
        return type(value)(place(v, w, mesh) for v, w in zip(value, where))
    raise TypeError(f"no placements for {type(value).__name__}")


@dataclass
class Program:
    """A step bound to a mesh: its arguments are placed by
    ``in_placements`` (one entry per argument; None passes a host value
    through), the step runs with the mesh ambient, and its outputs are
    placed by ``out_placements`` where given."""
    step: Callable
    mesh: Any
    in_placements: tuple
    out_placements: Any = None

    def __call__(self, *args):
        with use_mesh(self.mesh):
            out = self.step(*place(args, self.in_placements, self.mesh))
            return place(out, self.out_placements, self.mesh)


# ---------------------------------------------------------------------------
# step builders
# ---------------------------------------------------------------------------

def _microbatch(x: torch.Tensor, accum_steps: int, i: int) -> torch.Tensor:
    """Microbatch ``i`` of ``accum_steps`` along the rows. A DTensor is
    split on each rank's own rows (its shard of every microbatch), so
    that no rank gathers the batch; unsharded, the rows are the
    reference's ``reshape((accum, b // accum) + ...)``."""
    if not is_dtensor(x):
        b = x.shape[0]
        return x.reshape((accum_steps, b // accum_steps) + x.shape[1:])[i]
    mine = x.to_local()
    b = mine.shape[0]
    part = mine.reshape((accum_steps, b // accum_steps)
                        + mine.shape[1:])[i]
    return from_shard(part, x.device_mesh, x.placements)


def make_train_step(model: ModelApi, *, optimizer: str = "sgd",
                    lr: float = 1e-3, dtype=torch.bfloat16,
                    accum_steps: int = 1):
    """Returns ``(step, opt)``: ``step(params, opt_state, batch,
    step_idx) -> (params, opt_state, loss)``, the params updated in
    place.

    ``accum_steps > 1`` runs the microbatches one after another and sums
    their gradients: in float32 for float32 params, in the param dtype
    for bf16 masters (the giant MoEs). The summed gradients take the
    ``1 / accum_steps`` in the learning rate (exact for SGD), and the
    loss is the microbatches' mean. The learning rate is constant, a
    float32 value, as the reference's ``constant`` schedule; ``step_idx``
    is taken for its signature.
    """
    opt = make_optimizer(optimizer)
    # sched(step_idx) / accum_steps in float32, as the reference divides
    step_lr = float(np.float32(lr) / np.float32(accum_steps))

    def step(params, opt_state, batch, step_idx):
        if accum_steps == 1:
            loss, grads = _loss_and_grads(model, params, batch, dtype)
        else:
            acc, loss = None, None
            for i in range(accum_steps):
                mb = {k: _microbatch(v, accum_steps, i)
                      for k, v in batch.items()}
                l, g = _loss_and_grads(model, params, mb, dtype)
                if acc is None:
                    acc = [torch.zeros_like(
                        p, dtype=torch.float32 if p.dtype == torch.float32
                        else p.dtype) for p in g]
                    loss = torch.zeros_like(l, dtype=torch.float32)
                for a, g_ in zip(acc, g):
                    a.add_(g_.to(a.dtype))
                loss = loss + l
            grads, loss = acc, loss / accum_steps
        paths = [p for p, _ in tree_items(params)]
        grads = tree_from_items(zip(paths, grads))
        updates, opt_state = opt.update(grads, opt_state, params, step_lr)
        with torch.no_grad():           # apply_updates, in place
            for (_, p), (_, u) in zip(tree_items(params),
                                      tree_items(updates)):
                p.add_(u)
        return params, opt_state, loss

    return step, opt


def accum_steps_for(cfg: ModelConfig, shape: InputShape, mesh,
                    budget_bytes: float = 2e9) -> int:
    """Pick gradient accumulation so that the per-layer activation stack
    (scan length x b_local x T x d x 2 B) stays under the budget."""
    sizes = mesh_axis_sizes(mesh)
    repl = sizes.get("pod", 1) * sizes.get("data", 1)
    b_local = max(shape.global_batch // repl, 1)
    n_saves = cfg.num_layers
    if cfg.kind == "moe" and cfg.moe_every > 1:
        n_saves = cfg.num_layers // cfg.moe_every
    if cfg.kind == "hybrid":
        n_saves = cfg.num_layers // (cfg.local_attn_every or 3) + 2
    if cfg.enc_num_layers:
        n_saves += cfg.enc_num_layers
    stack = n_saves * b_local * shape.seq_len * cfg.d_model * 2
    a = 1
    while stack / a > budget_bytes and a < b_local:
        a *= 2
    return a


def opt_state_shardings(optimizer: str, param_shardings, mesh):
    if optimizer == "sgd":
        return ()
    if optimizer == "momentum":
        return {"m": param_shardings}
    if optimizer == "adamw":
        return {"m": param_shardings, "v": param_shardings,
                "count": replicated(mesh)}
    raise ValueError(optimizer)


def make_prefill_step(model: ModelApi, *, dtype=torch.bfloat16,
                      serve_window: int = 0):
    def step(params, batch):
        return model.prefill(params, batch, dtype=dtype,
                             serve_window=serve_window, use_kernel=True)
    return step


def make_decode_step(model: ModelApi, *, dtype=torch.bfloat16,
                     serve_window: int = 0):
    def step(params, token, cache, pos):
        return model.decode_step(params, token, cache, pos, dtype=dtype,
                                 serve_window=serve_window)
    return step


# ---------------------------------------------------------------------------
# programs per (arch, shape, mesh)
# ---------------------------------------------------------------------------

def serve_window_for(cfg: ModelConfig, shape: InputShape) -> int:
    """The sliding-window serving variant for long-context decode on
    full-attention archs."""
    if shape.name == "long_500k" and cfg.kind in ("dense", "moe", "vlm"):
        return 4096
    return 0


def param_dtype_for(cfg: ModelConfig):
    """bf16 master weights for the giant MoEs (SGD, the paper's
    optimizer, keeps no state, so this is the whole memory story)."""
    if cfg.param_count() > 5e10:
        return torch.bfloat16
    return torch.float32


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def build_program(model: ModelApi, shape: InputShape, mesh, *,
                  optimizer: str = "sgd", dtype=torch.bfloat16,
                  lr: float = 1e-3,
                  rules_override: Optional[ShardingRules] = None,
                  cache_rules_override: Optional[ShardingRules] = None,
                  accum_steps: Optional[int] = None):
    """The step of one (arch, shape) on ``mesh`` and its abstract inputs:
    ``(fn, abstract_args)``. ``accum_steps`` defaults to
    :func:`accum_steps_for`'s choice."""
    cfg = model.cfg
    pdt = param_dtype_for(cfg)
    params_abs, axes = model.abstract_params(dtype=pdt)
    sw = serve_window_for(cfg, shape)
    specs = model.input_specs(shape, serve_window=sw)
    repl = replicated(mesh)

    if shape.phase == "train":
        rules = rules_override or TRAIN_RULES
        p_sh = shard_tree(axes, mesh, rules)
        if accum_steps is None:
            accum_steps = accum_steps_for(cfg, shape, mesh)
        step, opt = make_train_step(model, optimizer=optimizer, lr=lr,
                                    dtype=dtype, accum_steps=accum_steps)
        opt_abs = opt.init(params_abs)
        o_sh = opt_state_shardings(optimizer, p_sh, mesh)
        b_sh = batch_shardings(specs["batch"], mesh, rules)
        fn = Program(step, mesh, (p_sh, o_sh, b_sh, repl),
                     (p_sh, o_sh, repl))
        args = (params_abs, opt_abs, specs["batch"], _meta((), torch.int32))
        return fn, args

    rules = rules_override or SERVE_RULES
    p_sh = shard_tree(axes, mesh, rules)

    if shape.phase == "prefill":
        c_sh = shard_tree(model.cache_axes(), mesh,
                          cache_rules_override or CACHE_RULES_DECODE)
        b_sh = batch_shardings(specs["batch"], mesh, rules)
        step = make_prefill_step(model, dtype=dtype, serve_window=sw)
        fn = Program(step, mesh, (p_sh, b_sh), (repl, c_sh, repl))
        return fn, (params_abs, specs["batch"])

    # decode
    long = shape.name == "long_500k"
    cache_rules = cache_rules_override or (
        CACHE_RULES_LONG if long else CACHE_RULES_DECODE)
    c_sh = shard_tree(model.cache_axes(long_context=long), mesh,
                      cache_rules)
    tok_sh = placements(cache_rules.spec(("cache_batch", None), mesh), mesh)
    step = make_decode_step(model, dtype=dtype, serve_window=sw)
    fn = Program(step, mesh, (p_sh, tok_sh, c_sh, repl), (tok_sh, c_sh))
    return fn, (params_abs, specs["token"], specs["cache"], specs["pos"])


def _token_only(cfg) -> None:
    if cfg.kind in ("vlm", "encdec", "audio"):
        raise ValueError(
            f"serve program is token-only; arch kind {cfg.kind!r} needs "
            "frontend inputs the request path does not carry")


def build_serve_program(model: ModelApi, mesh, *, slots: int = 8,
                        max_prompt: int = 1024, max_total: int = 2048,
                        dtype=torch.bfloat16,
                        rules: Optional[ShardingRules] = None,
                        cache_rules: Optional[ShardingRules] = None) -> dict:
    """The continuous-batching serving pair on a mesh:

    * ``admission`` — a batch-1 prefill written into slot ``slot`` of the
      live ``(slots, max_total)`` cache, its ``pos`` and its logits (what
      ``ContinuousScheduler`` runs for one request);
    * ``decode`` — one decode step over every slot with a per-slot
      ``pos`` vector.

    Returns ``{"admission": (fn, args), "decode": (fn, args)}``, every
    input placed by :func:`~repro_torch.serving.serve_shardings`.
    """
    cfg = model.cfg
    _token_only(cfg)
    pdt = param_dtype_for(cfg)
    sh = serve_shardings(model, mesh, slots=slots, max_total=max_total,
                         dtype=dtype, param_dtype=pdt, rules=rules,
                         cache_rules=cache_rules)
    params_abs, _ = model.abstract_params(dtype=pdt)
    cache_abs = model.abstract_cache(slots, max_total, dtype)
    i32 = torch.int32
    logits_abs = _meta((slots, 1, cfg.padded_vocab), dtype)
    pos_abs = _meta((slots,), i32)

    def admission(params, cache, pos, logits, tokens, length, slot):
        lg1, c1, p1 = model.prefill(
            params, {"tokens": tokens}, dtype=dtype, cache_dtype=dtype,
            cache_len=max_total, lengths=length, use_kernel=True)
        model.write_cache_slot(cache, c1, slot, pos=pos, one_pos=p1[0])
        write_rows(logits, lg1, slot, 0)
        return cache, pos, logits

    adm = Program(admission, mesh,
                  (sh.params, sh.cache, sh.pos, sh.logits, sh.replicated,
                   sh.replicated, None))
    adm_args = (params_abs, cache_abs, pos_abs, logits_abs,
                _meta((1, max_prompt), i32), _meta((1,), i32), 0)

    def decode(params, token, cache, pos):
        return model.decode_step(params, token, cache, pos, dtype=dtype)

    dec = Program(decode, mesh, (sh.params, sh.token, sh.cache, sh.pos),
                  (sh.logits, sh.cache))
    dec_args = (params_abs, _meta((slots, 1), i32), cache_abs, pos_abs)
    return {"admission": (adm, adm_args), "decode": (dec, dec_args)}


def build_paged_serve_program(model: ModelApi, mesh, *, slots: int = 8,
                              max_prompt: int = 1024, max_total: int = 2048,
                              page_size: int = 64,
                              cache_pages: Optional[int] = None,
                              prefill_chunk: Optional[int] = None,
                              dtype=torch.bfloat16,
                              rules: Optional[ShardingRules] = None,
                              cache_rules: Optional[ShardingRules] = None
                              ) -> dict:
    """The paged serving pair on a mesh:

    * ``admission_chunk`` — one chunked-prefill step writing a
      ``prefill_chunk``-token piece of a prompt into the slot's pages
      and its logits (``start``, ``valid``, the page row and the slot
      are host values, as ``PagedContinuousScheduler`` passes them);
    * ``decode`` — one paged decode step over every slot through the
      ``(slots, pages_per_slot)`` page map.

    Returns ``{"admission_chunk": (fn, args), "decode": (fn, args)}``,
    placed as the paged scheduler places them.
    """
    from repro_torch.serving import pages_per_slot
    cfg = model.cfg
    _token_only(cfg)
    P = pages_per_slot(max_total, page_size)
    if cache_pages is None:
        cache_pages = slots * P + 1
    if prefill_chunk is None:
        prefill_chunk = -(-max_prompt // page_size) * page_size
    if prefill_chunk % page_size:
        raise ValueError(f"prefill_chunk {prefill_chunk} is not a multiple "
                         f"of page_size {page_size}")
    pdt = param_dtype_for(cfg)
    sh = serve_shardings(model, mesh, slots=slots, max_total=max_total,
                         dtype=dtype, param_dtype=pdt, page_size=page_size,
                         cache_pages=cache_pages, rules=rules,
                         cache_rules=cache_rules)
    params_abs, _ = model.abstract_params(dtype=pdt)
    cache_abs = model.abstract_paged_cache(slots, cache_pages, page_size,
                                           dtype)
    i32 = torch.int32
    logits_abs = _meta((slots, 1, cfg.padded_vocab), dtype)
    pos_abs = _meta((slots,), i32)

    def admission_chunk(params, cache, logits, tokens, start, valid, row,
                        slot):
        c1, lg = model.prefill_chunk(params, cache, tokens, start, valid,
                                     row, slot, dtype=dtype,
                                     use_kernel=True)
        write_rows(logits, lg, slot, 0)
        return c1, logits

    adm = Program(admission_chunk, mesh,
                  (sh.params, sh.paged_cache, sh.logits, sh.replicated,
                   None, None, None, None))
    adm_args = (params_abs, cache_abs, logits_abs,
                _meta((1, prefill_chunk), i32), 0, prefill_chunk,
                np.arange(1, P + 1, dtype=np.int32), 0)

    def decode(params, token, cache, pos, page_map, live):
        return model.decode_step_paged(params, token, cache, pos, page_map,
                                       live, dtype=dtype, use_kernel=True)

    dec = Program(decode, mesh,
                  (sh.params, sh.token, sh.paged_cache, sh.pos, sh.page_map,
                   sh.live), (sh.logits, sh.paged_cache))
    dec_args = (params_abs, _meta((slots, 1), i32), cache_abs, pos_abs,
                _meta((slots, P), i32), _meta((slots,), torch.bool))
    return {"admission_chunk": (adm, adm_args), "decode": (dec, dec_args)}


__all__ = [
    "CACHE_RULES_DECODE", "CACHE_RULES_LONG", "Program", "SERVE_CACHE_RULES",
    "SERVE_RULES", "TRAIN_RULES", "accum_steps_for", "batch_shardings",
    "build_paged_serve_program", "build_program", "build_serve_program",
    "make_decode_step", "make_prefill_step", "make_train_step",
    "opt_state_shardings", "param_dtype_for", "place", "replicated",
    "serve_window_for", "shard_tree",
]
