"""The port's chunked ``flash_attention`` (forward and its custom
backward) against the reference's ``flash_attention`` on the CPU, on the
grid of ``tests/test_attention.py``, with the same numpy inputs on both
sides.

Tolerances, and why (ROADMAP.md's ground rules):
- forward within 2e-5 of the reference's flash and of the port's
  materialized ``simple_attention`` (the reference's own flash-vs-simple
  tolerance: the online softmax rescales its partial sums);
- gradients of q, k and v within 5e-5 (the reference's flash-vs-simple
  gradient tolerance);
- any chunk sizes within 2e-5 of the materialized attention.
The attention block and a model loss past the 2,048-token threshold go
through flash on both sides; they are held to the reference at 1e-5 of
the output and rtol 1e-5 of the loss.
"""
import _torch_threads  # noqa: F401  (torch threads per xdist worker)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.models import attention as j_attn
from repro.models import build_model as j_build_model

from repro_torch.configs import get_arch
from repro_torch.models import attention, build_model, params_from_jax
from repro_torch.models.common import tree_items

GRID = [("causal", 0, None), ("sliding", 32, None), ("sliding", 7, None),
        ("prefix", 0, 13), ("full", 0, None)]


def _qkv(B=2, T=128, K=2, G=2, hd=16, seed=0, Tk=None):
    rng = np.random.default_rng(seed)
    Tk = Tk or T
    return (rng.normal(size=(B, T, K, G, hd)).astype(np.float32),
            rng.normal(size=(B, Tk, K, hd)).astype(np.float32),
            rng.normal(size=(B, Tk, K, hd)).astype(np.float32))


def _t(arrays, grad=False):
    return [torch.tensor(a, requires_grad=grad) for a in arrays]


@pytest.mark.parametrize("mode,window,prefix", GRID)
def test_flash_forward_matches_reference(mode, window, prefix):
    """The forward at the reference test's chunks (32, 64), against the
    reference's flash and the port's materialized attention."""
    qkv = _qkv()
    kw = dict(mode=mode, window=window, prefix_len=prefix)
    ref = np.asarray(j_attn.flash_attention(
        *map(jnp.asarray, qkv), q_chunk=32, k_chunk=64, **kw))
    got = attention.flash_attention(*_t(qkv), q_chunk=32, k_chunk=64, **kw)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=0)
    plain = attention.simple_attention(*_t(qkv), **kw)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=2e-5,
                               rtol=0)


@pytest.mark.parametrize("mode,window,prefix", GRID)
def test_flash_gradients_match_reference(mode, window, prefix):
    """d/d(q, k, v) of sum(out^2) through the custom backward (chunks of
    16 over 64 tokens), against the reference's custom VJP and the
    port's autograd through the materialized attention."""
    qkv = _qkv(T=64)
    kw = dict(mode=mode, window=window, prefix_len=prefix)
    ref = jax.grad(lambda *a: (j_attn.flash_attention(
        *a, q_chunk=16, k_chunk=16, **kw) ** 2).sum(), argnums=(0, 1, 2))(
            *map(jnp.asarray, qkv))
    q, k, v = _t(qkv, grad=True)
    (attention.flash_attention(q, k, v, q_chunk=16, k_chunk=16,
                               **kw) ** 2).sum().backward()
    qs, ks, vs = _t(qkv, grad=True)
    (attention.simple_attention(qs, ks, vs, **kw) ** 2).sum().backward()
    for got, plain, want in zip((q, k, v), (qs, ks, vs), ref):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want),
                                   atol=5e-5, rtol=0)
        np.testing.assert_allclose(got.grad.numpy(), plain.grad.numpy(),
                                   atol=5e-5, rtol=0)


@pytest.mark.parametrize("qc", [16, 32, 64])
@pytest.mark.parametrize("kc", [16, 32, 64])
def test_flash_chunk_size_invariance(qc, kc):
    qkv = _qkv(T=64)
    base = attention.simple_attention(*_t(qkv), mode="causal")
    out = attention.flash_attention(*_t(qkv), mode="causal", q_chunk=qc,
                                    k_chunk=kc)
    np.testing.assert_allclose(out.numpy(), base.numpy(), atol=2e-5, rtol=0)


def test_flash_padded_keys_and_query_offset_match_reference():
    """``k_len`` masks padded keys, and ``q_offset`` shifts the queries'
    positions (a later chunk of a sequence), forward and backward."""
    q, k, v = _qkv(T=32, Tk=64, seed=3)
    kw = dict(mode="sliding", window=20, q_offset=24, q_chunk=16,
              k_chunk=32, k_len=50)
    ref = j_attn.flash_attention(*map(jnp.asarray, (q, k, v)), **kw)
    jg = jax.grad(lambda *a: (j_attn.flash_attention(*a, **kw) ** 2).sum(),
                  argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = _t((q, k, v), grad=True)
    out = attention.flash_attention(tq, tk, tv, **kw)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=2e-5, rtol=0)
    (out ** 2).sum().backward()
    for got, want in zip((tq, tk, tv), jg):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want),
                                   atol=5e-5, rtol=0)


def _tiny_qwen(num_layers=1):
    kw = dict(num_layers=num_layers, d_model=64, d_ff=128, vocab_size=64)
    jcfg = j_get_arch("qwen1.5-0.5b").reduced(**kw)
    cfg = get_arch("qwen1.5-0.5b").reduced(**kw)
    jp = j_build_model(jcfg).init(jax.random.PRNGKey(0))
    return cfg, jcfg, params_from_jax(jax.tree.map(np.asarray, jp), "cpu"), jp


@pytest.mark.parametrize("T", [2049, 2560])
def test_attention_block_past_the_threshold_matches_reference(T):
    """``attention_block`` at T > 2048 (ragged: padded to the 512 / 1024
    chunks and ``k_len``-masked, and whole chunks) takes flash on both
    sides; it equals the reference's output and the port's materialized
    path (``flash_threshold`` raised)."""
    cfg, jcfg, p, jp = _tiny_qwen()
    lp = params_from_jax(jax.tree.map(lambda v: np.asarray(v[0]),
                                      jp["layers"]["attn"]), "cpu")
    jlp = jax.tree.map(lambda v: v[0], jp["layers"]["attn"])
    x = (np.random.default_rng(1).normal(size=(1, T, cfg.d_model)) * 0.5
         ).astype(np.float32)
    ref = j_attn.attention_block(jlp, jcfg, jnp.asarray(x))
    got = attention.attention_block(lp, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)
    plain = attention.attention_block(lp, cfg, torch.from_numpy(x),
                                      flash_threshold=T)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-5,
                               rtol=0)


def test_long_sequence_loss_and_gradient_match_reference():
    """A 2,049-token training loss (once refused by the port) through
    flash: the loss within rtol 1e-5 of the reference's and every
    parameter's gradient within 5e-5."""
    cfg, jcfg, p, jp = _tiny_qwen()
    toks = np.random.default_rng(2).integers(
        0, cfg.vocab_size, size=(1, 2049)).astype(np.int32)
    batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    jloss, jgrad = jax.value_and_grad(
        lambda pp: j_build_model(jcfg).loss(pp, batch, dtype=jnp.float32))(jp)
    for _, v in tree_items(p):
        v.requires_grad_()
    tt = torch.from_numpy(toks)
    loss = build_model(cfg).loss(p, {"tokens": tt, "labels": tt},
                                 dtype=torch.float32)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    for (_, v), want in zip(tree_items(p), jax.tree.leaves(jgrad)):
        np.testing.assert_allclose(v.grad.numpy(), np.asarray(want),
                                   atol=5e-5, rtol=0)
