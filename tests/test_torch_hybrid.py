"""The hybrid kind (recurrentgemma-9b: RG-LRU blocks and local attention
2:1) of the port against the reference on the CPU: the parameter tree,
the forward, loss and gradient, and the ring and paged serving engines
(the schedulers are in ``tests/test_torch_serve_hybrid.py``, the serve
CLI in ``test_torch_serve_hybrid_cli.py``, scale mode in
``test_torch_scale_hybrid.py`` and ``test_torch_scale_hybrid_trainer.py``).

The config is a reduced recurrentgemma-9b with 5 layers — one
``(rec, rec, attn)`` group and a ``tail`` of two recurrent layers, the
full model's structure (12 groups and a tail of 2) — d 64, vocabulary
128, and an ``attention_window`` of 8, below the prompt lengths, so
that the ring wraps and the paged band masks (as
``tests/test_serving_paged.py`` cuts the window). Weights are the
reference's, carried by ``params_from_jax``; inputs are seeded numpy
draws.

Tolerances, and why:
- logits within 1e-5 (float32 on both sides; the RG-LRU scans sum in
  another tree, the attention in another order), greedy tokens exactly;
- the gradient within 1e-5 of every parameter, the loss rtol 1e-5;
"""
import _torch_threads  # noqa: F401  (torch threads per xdist worker)
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.models import build_model as j_build_model
from repro.serving import engine as j_engine

from repro_torch.configs import get_arch
from repro_torch.models import build_model, params_from_jax
from repro_torch.models.common import tree_items
from repro_torch.serving import (
    decode_step, decode_step_paged, init_paged_cache_tree, pages_per_slot,
    prefill, prefill_chunk, write_cache_slot,
)

from test_torch_serving import _assert_logits_and_tokens

ARCH = "recurrentgemma-9b"
ATOL = 1e-5
WINDOW = 8

# the reference's engine, compiled once per shape (eager JAX dispatches
# every op of every layer on its own)
_STATIC = {"prefill": ("dtype", "cache_dtype", "cache_len"),
           "decode_step": ("dtype",), "prefill_chunk": ("dtype",),
           "decode_step_paged": ("dtype",)}
_J = {name: jax.jit(getattr(j_engine, name), static_argnums=(1,),
                    static_argnames=static)
      for name, static in _STATIC.items()}


@functools.lru_cache(maxsize=None)
def _tiny(num_layers=5, window=WINDOW):
    """(port cfg, reference cfg, port params, reference params)."""
    def make(get):
        cfg = get(ARCH).reduced(num_layers=num_layers, d_model=64, d_ff=128,
                                vocab_size=128)
        return dataclasses.replace(cfg, attention_window=window)
    jcfg, cfg = make(j_get_arch), make(get_arch)
    jp = jax.jit(j_build_model(jcfg).init)(jax.random.PRNGKey(0))
    return cfg, jcfg, params_from_jax(jax.tree.map(np.asarray, jp),
                                      "cpu"), jp


def _prompt(cfg, seed, n):
    return np.random.default_rng(seed).integers(
        1, cfg.vocab_size, size=n).astype(np.int32)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=0)


# ------------------------------------------------------------- the model

def test_parameter_tree_matches_reference():
    """``groups`` of {rec_0, rec_1, attn} and a ``tail``, with the
    reference's leaf order, shapes and logical axes — the flat (R, P)
    carrier and the checkpoints depend on them — at the reduced size and,
    through ``abstract_params``, at the full size: 9,396,301,824
    parameters (``param_count()`` says 8,959,246,336: it counts one of
    the two (w, w) gates and no conv, gate bias, ``lam`` or norm)."""
    cfg, jcfg, p, jp = _tiny()
    fresh, axes = build_model(cfg).abstract_params()
    jabs, _ = j_build_model(jcfg).abstract_params()
    assert [(k, tuple(v.shape)) for k, v in tree_items(fresh)] == \
        [(k, tuple(v.shape)) for k, v in tree_items(p)]
    assert [k for k, _ in tree_items(p)] == \
        [tuple(getattr(e, "key", e) for e in path) for path, _ in
         jax.tree_util.tree_flatten_with_path(jabs)[0]]
    assert sorted(p) == ["embed", "groups", "ln_final", "tail"]
    assert sorted(p["groups"]) == ["attn", "rec_0", "rec_1"]
    assert p["tail"]["rec"]["w_a"].shape == (2, 64, 64)
    assert axes["groups"]["rec_0"]["rec"]["w_a"] == \
        ("layers", "rnn_width_in", "rnn_width")
    full = get_arch(ARCH)
    shapes, _ = build_model(full).abstract_params()
    jshapes, _ = j_build_model(j_get_arch(ARCH)).abstract_params()
    got = [tuple(v.shape) for _, v in tree_items(shapes)]
    assert got == [tuple(v.shape) for v in jax.tree.leaves(jshapes)]
    total = sum(int(np.prod(s)) for s in got)
    assert total == 9_396_301_824 and shapes["groups"]["attn"]["attn"][
        "wk"].shape == (12, 4096, 256)


def test_forward_loss_and_gradient_match_reference():
    cfg, jcfg, p, jp = _tiny()
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(2, 20)).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    jm, m = j_build_model(jcfg), build_model(cfg)
    jl, _ = jax.jit(lambda pp: jm.forward(pp, jb, dtype=jnp.float32))(jp)
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(toks)}
    p = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    for _, v in tree_items(p):
        v.requires_grad_()
    logits, aux = m.forward(p, tb, dtype=torch.float32)
    assert aux == {}
    _close(logits, jl)
    jloss, jgrad = jax.jit(jax.value_and_grad(
        lambda pp: jm.loss(pp, jb, dtype=jnp.float32)))(jp)
    loss = m.loss(p, tb, dtype=torch.float32)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    for (_, v), want in zip(tree_items(p), jax.tree.leaves(jgrad)):
        _close(v.grad, want)


# ------------------------------------------------------ the ring engine

def test_ring_prefill_decode_and_slot_write_match_reference():
    """A right-padded mixed-length prefill (prompts of 12, 5 and 9 past
    the window of 8), decode with per-slot positions as the ring wraps,
    and write_cache_slot of a batch-1 prefill: logits and every cache
    leaf (K/V rings, RG-LRU h and conv, in groups and tail)."""
    cfg, jcfg, p, jp = _tiny()
    B, T, steps, total = 3, 12, 5, 20
    rng = np.random.default_rng(4)
    toks = rng.integers(1, cfg.vocab_size, size=(B, T)).astype(np.int32)
    lens = np.asarray([12, 5, 9], np.int32)
    feed = rng.integers(1, cfg.vocab_size, size=(steps, B, 1)).astype(
        np.int32)
    kw = dict(dtype=jnp.float32, cache_dtype=jnp.float32, cache_len=total)
    jl, jc, jpos = _J["prefill"](jp, jcfg, {"tokens": jnp.asarray(toks)},
                                    lengths=jnp.asarray(lens), **kw)
    tkw = dict(dtype=torch.float32, cache_dtype=torch.float32,
               cache_len=total)
    tl, tc, tpos = prefill(p, cfg, {"tokens": torch.from_numpy(toks)},
                           lengths=torch.from_numpy(lens), **tkw)
    assert tc["groups"]["attn"]["k"].shape[2] == WINDOW
    _close(tl, jl)
    assert tpos.tolist() == np.asarray(jpos).tolist()
    for i in range(steps):
        jl, jc = _J["decode_step"](jp, jcfg, jnp.asarray(feed[i]), jc,
                                      jpos, dtype=jnp.float32)
        tl, tc = decode_step(p, cfg, torch.from_numpy(feed[i]), tc, tpos,
                             dtype=torch.float32)
        _close(tl, jl)
        jpos, tpos = jpos + 1, tpos + 1
    one = np.zeros((1, T), np.int32)
    one[0, :7] = _prompt(cfg, 5, 7)
    _, jc1, jp1 = _J["prefill"](jp, jcfg, {"tokens": jnp.asarray(one)},
                                   lengths=jnp.asarray([7]), **kw)
    _, tc1, tp1 = prefill(p, cfg, {"tokens": torch.from_numpy(one)},
                          lengths=torch.tensor([7]), **tkw)
    jc, jpos = j_engine.write_cache_slot(jcfg, jc, jc1, 1, pos=jpos,
                                         one_pos=jp1[0])
    tc, tpos = write_cache_slot(cfg, tc, tc1, 1, pos=tpos, one_pos=tp1[0])
    assert tpos.tolist() == np.asarray(jpos).tolist()
    leaves = tree_items(tc)
    assert [k for k, _ in leaves] == \
        [tuple(getattr(e, "key", e) for e in path) for path, _ in
         jax.tree_util.tree_flatten_with_path(jc)[0]]
    for (_, got), want in zip(leaves, jax.tree.leaves(jc)):
        _close(got, want)
    jl, _ = _J["decode_step"](jp, jcfg, jnp.asarray(feed[0]), jc, jpos,
                                 dtype=jnp.float32)
    tl, _ = decode_step(p, cfg, torch.from_numpy(feed[0]), tc, tpos,
                        dtype=torch.float32)
    _close(tl, jl)


def test_ring_one_shot_prefill_past_2048_goes_through_flash():
    """An aligned (no lengths) 2,100-token prefill — the attention layer
    through flash, the ring filled with the last 8 positions — and two
    decode steps, against the reference's flash branch. Each cache leaf
    is held to 1e-5 of its max |value|: over 200 tokens or more the two
    scans' summation orders leave the RG-LRU states some 3e-6 apart and
    the keys and values they feed (of magnitude 3) some 1.5e-5."""
    cfg, jcfg, p, jp = _tiny(num_layers=3)
    toks = _prompt(cfg, 7, 2100)[None]
    jl, jc, jpos = _J["prefill"](jp, jcfg, {"tokens": jnp.asarray(toks)},
                                    dtype=jnp.float32,
                                    cache_dtype=jnp.float32, cache_len=2104)
    tl, tc, tpos = prefill(p, cfg, {"tokens": torch.from_numpy(toks)},
                           dtype=torch.float32, cache_dtype=torch.float32,
                           cache_len=2104)
    assert int(tpos) == int(jpos) == 2100
    _close(tl, jl)
    for (_, got), want in zip(tree_items(tc), jax.tree.leaves(jc)):
        _close(got, want, atol=ATOL * max(1.0, float(np.abs(want).max())))
    tok = np.argmax(np.asarray(jl), -1).astype(np.int32)
    for _ in range(2):
        jl, jc = _J["decode_step"](jp, jcfg, jnp.asarray(tok), jc, jpos,
                                      dtype=jnp.float32)
        tl, tc = decode_step(p, cfg, torch.from_numpy(tok), tc, tpos,
                             dtype=torch.float32)
        _close(tl, jl)
        tok = np.argmax(np.asarray(jl), -1).astype(np.int32)
        jpos, tpos = jpos + 1, tpos + 1


# ----------------------------------------------------- the paged engine

def _paged_runs(cfg, jcfg, p, jp, prompt, feed, *, ps, chunk, use_kernel):
    """The reference's and the port's chunked paged prefill and
    teacher-forced paged decode (one slot); the logits of every step."""
    plen, P = len(prompt), pages_per_slot(len(prompt) + len(feed) + 1, ps)
    jcache = j_engine.init_paged_cache_tree(jcfg, 1, P + 1, ps, jnp.float32)
    cache = init_paged_cache_tree(cfg, 1, P + 1, ps, torch.float32,
                                  device="cpu")
    row = np.arange(1, P + 1, dtype=np.int32)
    padded = np.zeros(-(-plen // chunk) * chunk, np.int32)
    padded[:plen] = prompt
    start = 0
    while start < plen:
        valid = min(chunk, plen - start)
        piece = padded[start:start + chunk][None]
        jcache, jl = _J["prefill_chunk"](
            jp, jcfg, jcache, jnp.asarray(piece), start, valid,
            jnp.asarray(row), 0, dtype=jnp.float32)
        cache, tl = prefill_chunk(p, cfg, cache, torch.from_numpy(piece),
                                  start, valid, row, 0, dtype=torch.float32,
                                  use_kernel=use_kernel)
        start += valid
    ref, got = [np.asarray(jl[0, 0])], [tl[0, 0].numpy()]
    jpos = jnp.asarray([plen], jnp.int32)
    pos = torch.tensor([plen], dtype=torch.int32)
    for tok in feed:
        jl, jcache = _J["decode_step_paged"](
            jp, jcfg, jnp.asarray([[tok]], jnp.int32), jcache, jpos,
            jnp.asarray(row)[None], jnp.asarray([True]), dtype=jnp.float32)
        tl, cache = decode_step_paged(
            p, cfg, torch.tensor([[tok]], dtype=torch.int32), cache, pos,
            torch.from_numpy(row)[None], torch.tensor([True]),
            dtype=torch.float32, use_kernel=use_kernel)
        ref.append(np.asarray(jl[0, 0]))
        got.append(tl[0, 0].numpy())
        jpos, pos = jpos + 1, pos + 1
    return got, ref, cache, jcache


@pytest.mark.parametrize("use_kernel", [False, True])
def test_paged_prefill_and_decode_match_reference(use_kernel):
    """prefill_chunk in chunks of 8 over an 11-token prompt (the second
    chunk carries every RG-LRU layer's state and conv context) and
    decode_step_paged past the window band (through the plain gather, or
    the ``paged_decode`` wrapper, which takes its plain version on the
    CPU): logits, tokens and the final cache."""
    cfg, jcfg, p, jp = _tiny()
    got, ref, cache, jcache = _paged_runs(
        cfg, jcfg, p, jp, _prompt(cfg, 0, 11), _prompt(cfg, 1, 6).tolist(),
        ps=4, chunk=8, use_kernel=use_kernel)
    _assert_logits_and_tokens(got, ref)
    for (_, a), b in zip(tree_items(cache), jax.tree.leaves(jcache)):
        _close(a, b)


def test_chunked_paged_matches_one_shot_ring():
    """The same prompt through chunks of 4 (paged) and a one-shot ring
    prefill, then greedy decode: equal logits and tokens."""
    cfg, _, p, _ = _tiny()
    prompt = _prompt(cfg, 2, 13)
    lg, cache, pos = prefill(p, cfg, {"tokens": torch.from_numpy(
        prompt[None])}, dtype=torch.float32, cache_dtype=torch.float32,
        cache_len=20)
    ring, feed = [lg[0, 0].numpy()], []
    for _ in range(5):
        tok = torch.argmax(lg[:, -1], -1)[:, None].to(torch.int32)
        feed.append(int(tok[0, 0]))
        lg, cache = decode_step(p, cfg, tok, cache, pos, dtype=torch.float32)
        ring.append(lg[0, 0].numpy())
        pos = pos + 1
    P = pages_per_slot(20, 4)
    pc = init_paged_cache_tree(cfg, 2, P + 1, 4, torch.float32, device="cpu")
    row = np.arange(1, P + 1, dtype=np.int32)
    padded = np.zeros(16, np.int32)
    padded[:13] = prompt
    for start in range(0, 13, 4):
        pc, lg = prefill_chunk(p, cfg, pc, torch.from_numpy(
            padded[start:start + 4])[None], start, min(4, 13 - start), row,
            1, dtype=torch.float32)
    paged = [lg[0, 0].numpy()]
    pm = torch.from_numpy(np.stack([np.zeros_like(row), row]))
    pos = torch.tensor([0, 13], dtype=torch.int32)
    for tok in feed:
        lg, pc = decode_step_paged(
            p, cfg, torch.tensor([[0], [tok]], dtype=torch.int32), pc, pos,
            pm, torch.tensor([False, True]), dtype=torch.float32)
        paged.append(lg[1, 0].numpy())
        pos = pos + 1
    _assert_logits_and_tokens(paged, ring)
    # the lane that is not live kept its (zero) recurrent state
    assert not pc["groups"]["rec_0"]["h"][:, 0].any()
    assert not pc["tail"]["conv"][:, 0].any()
