"""The dense transformer of the port against ``repro.models`` on the CPU:
the same numpy-made tokens and the reference's parameters carried across
by ``params_from_jax``.

Tolerances, and why:
- float32: loss rtol 1e-5, each gradient leaf within 1e-4 relative L2
  error (float32 products summed in another order on the two sides;
  elementwise rtol is meaningless where a gradient is near zero, e.g.
  the key bias, whose exact gradient is 0 — softmax is shift-invariant).
- bfloat16 compute: loss rtol 2e-2, the whole gradient within 2e-2
  relative L2 error (bf16 rounds at other places in the two frameworks:
  XLA rounds between elementwise ops that torch fuses in float32).
- building blocks (norms, RoPE, MLP, attention, cross-entropy) in
  float32: rtol 1e-5 / atol 1e-6.
"""
import _torch_threads  # noqa: F401  (torch threads per xdist worker)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.models import attention as j_attn
from repro.models import build_model as j_build_model
from repro.models import common as j_common
from repro.models import mlp as j_mlp

from repro_torch.configs import ARCHS, get_arch
from repro_torch.models import attention, build_model, common, mlp
from repro_torch.models import params_from_jax
from repro_torch.models.common import tree_items, tree_map

DENSE = ["qwen1.5-0.5b", "gemma-2b", "granite-3-8b", "starcoder2-3b"]
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
TOL = dict(rtol=1e-5, atol=1e-6)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _perturbed_params(jm, seed=0):
    """The reference init plus a perturbation, so zero-initialized
    biases and norm scales carry gradients through non-trivial values."""
    p = jm.init(jax.random.PRNGKey(seed))
    leaves, tdef = jax.tree.flatten(p)
    keys = jax.random.split(jax.random.PRNGKey(seed + 1), len(leaves))
    return jax.tree.unflatten(tdef, [l + 0.01 * jax.random.normal(k, l.shape)
                                     for l, k in zip(leaves, keys)])


def _loss_and_grads(jcfg, cfg, dtype_name, B=2, T=16, seed=0):
    """(reference loss, reference grad leaves, port loss, port grad
    leaves, leaf paths) on one numpy-made batch."""
    tdt, jdt = DTYPES[dtype_name]
    jm, m = j_build_model(jcfg), build_model(cfg)
    jp = _perturbed_params(jm, seed)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(B, T + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jl, jg = jax.value_and_grad(lambda p: jm.loss(
        p, {k: jnp.asarray(v) for k, v in batch.items()}, dtype=jdt))(jp)
    items = tree_items(params_from_jax(jax.tree.map(np.asarray, jp), "cpu"))
    leaves = [v.requires_grad_(True) for _, v in items]
    tp = common.tree_from_items((p, l) for (p, _), l in zip(items, leaves))
    tl = m.loss(tp, {k: torch.from_numpy(v) for k, v in batch.items()},
                dtype=tdt)
    tg = torch.autograd.grad(tl, leaves)
    return (float(jl), [np.asarray(g) for g in jax.tree.leaves(jg)],
            float(tl.detach()), [g.numpy() for g in tg],
            [p for p, _ in items])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE)
def test_dense_loss_and_grads_match_reference(arch, dtype):
    jl, jg, tl, tg, paths = _loss_and_grads(j_get_arch(arch).reduced(),
                                            get_arch(arch).reduced(), dtype)
    assert len(tg) == len(jg)
    if dtype == "float32":
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
        for path, a, b in zip(paths, tg, jg):
            assert a.shape == b.shape, path
            assert _rel_l2(a, b) <= 1e-4, (path, _rel_l2(a, b))
    else:
        np.testing.assert_allclose(tl, jl, rtol=2e-2)
        assert _rel_l2(np.concatenate([a.ravel() for a in tg]),
                       np.concatenate([b.ravel() for b in jg])) <= 2e-2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_one_layer_at_qwen_full_widths(dtype):
    """d 1024, 16 heads of 64, d_ff 2816, QKV bias; vocabulary cut to
    512."""
    jcfg = dataclasses.replace(j_get_arch("qwen1.5-0.5b"), num_layers=1,
                               vocab_size=512)
    cfg = dataclasses.replace(get_arch("qwen1.5-0.5b"), num_layers=1,
                              vocab_size=512)
    assert (cfg.d_model, cfg.num_heads, cfg.head_dim, cfg.d_ff) == \
        (1024, 16, 64, 2816)
    jl, jg, tl, tg, paths = _loss_and_grads(jcfg, cfg, dtype, T=12)
    if dtype == "float32":
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
        for path, a, b in zip(paths, tg, jg):
            assert _rel_l2(a, b) <= 1e-4, (path, _rel_l2(a, b))
    else:
        np.testing.assert_allclose(tl, jl, rtol=2e-2)
        assert _rel_l2(np.concatenate([a.ravel() for a in tg]),
                       np.concatenate([b.ravel() for b in jg])) <= 2e-2


@pytest.mark.parametrize("arch", DENSE)
def test_init_and_abstract_params_match_reference_layout(arch):
    jm = j_build_model(j_get_arch(arch).reduced())
    m = build_model(get_arch(arch).reduced())
    j_abs, j_axes = jm.abstract_params()
    p_abs, p_axes = m.abstract_params()
    assert [tuple(v.shape) for _, v in tree_items(p_abs)] == \
        [tuple(v.shape) for v in jax.tree.leaves(j_abs)]
    assert all(v.device.type == "meta" for _, v in tree_items(p_abs))
    j_ax = jax.tree.leaves(j_axes, is_leaf=lambda x: isinstance(x, tuple))
    assert [a for _, a in tree_items(p_axes)] == [tuple(a) for a in j_ax]
    own = m.init(torch.Generator().manual_seed(0), "cpu")
    ref = jax.tree.leaves(jm.init(jax.random.PRNGKey(0)))
    for (path, a), b in zip(tree_items(own), ref):
        b = np.asarray(b)
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape, path
        # the same distribution: zeros stay zeros, ones stay ones, and a
        # random leaf's spread is the reference's within sampling noise
        if b.std() == 0:
            assert np.array_equal(a.numpy(), b), path
        else:
            assert abs(float(a.std()) / b.std() - 1) < 0.1, path
    bf = m.init(torch.Generator().manual_seed(0), "cpu", dtype=torch.bfloat16)
    assert all(v.dtype == torch.bfloat16 for _, v in tree_items(bf))


def test_params_from_jax_keeps_values_and_order():
    jm = j_build_model(j_get_arch("qwen1.5-0.5b").reduced())
    ref = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(2)))
    carried = params_from_jax(ref, "cpu")
    for (path, a), b in zip(tree_items(carried), jax.tree.leaves(ref)):
        assert np.array_equal(a.numpy(), b), path


def test_full_qwen_param_count():
    m = build_model(get_arch("qwen1.5-0.5b"))
    p_abs, _ = m.abstract_params()
    n = sum(v.numel() for _, v in tree_items(p_abs))
    jm = j_build_model(j_get_arch("qwen1.5-0.5b"))
    assert n == sum(int(np.prod(v.shape))
                    for v in jax.tree.leaves(jm.abstract_params()[0]))
    assert n == 464_118_784


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------

def _x(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_norms_match():
    x, s, b = _x(3, 5, 64), _x(64, seed=1), _x(64, seed=2)
    np.testing.assert_allclose(
        common.rmsnorm(torch.from_numpy(x), torch.from_numpy(s)).numpy(),
        np.asarray(j_common.rmsnorm(jnp.asarray(x), jnp.asarray(s))), **TOL)
    np.testing.assert_allclose(
        common.layernorm(torch.from_numpy(x), torch.from_numpy(s),
                         torch.from_numpy(b)).numpy(),
        np.asarray(j_common.layernorm(jnp.asarray(x), jnp.asarray(s),
                                      jnp.asarray(b))), **TOL)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope_matches(theta):
    x = _x(2, 9, 3, 64)
    pos = np.arange(9)
    np.testing.assert_allclose(
        common.rope(torch.from_numpy(x), torch.from_numpy(pos),
                    theta).numpy(),
        np.asarray(j_common.rope(jnp.asarray(x), jnp.asarray(pos), theta)),
        rtol=1e-5, atol=1e-5)


def test_cross_entropy_matches():
    logits = _x(2, 7, 50)
    labels = np.random.default_rng(3).integers(0, 50, size=(2, 7))
    np.testing.assert_allclose(
        float(common.softmax_cross_entropy(torch.from_numpy(logits),
                                           torch.from_numpy(labels))),
        float(j_common.softmax_cross_entropy(jnp.asarray(logits),
                                             jnp.asarray(labels))), **TOL)


@pytest.mark.parametrize("variant", ["swiglu", "geglu", "gelu"])
def test_mlp_variants_match(variant):
    cfg = dataclasses.replace(get_arch("qwen1.5-0.5b").reduced(d_model=64,
                                                               d_ff=96),
                              mlp_variant=variant)
    jp, _ = j_common.split_tree(j_mlp.init_mlp(jax.random.PRNGKey(0), cfg))
    jp = jax.tree.map(lambda v: v + 0.05, jp)
    x = _x(2, 5, 64)
    np.testing.assert_allclose(
        mlp.apply_mlp(params_from_jax(jax.tree.map(np.asarray, jp), "cpu"),
                      cfg, torch.from_numpy(x)).numpy(),
        np.asarray(j_mlp.apply_mlp(jp, cfg, jnp.asarray(x))),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode,window,prefix", [
    ("causal", 0, None), ("sliding", 3, None), ("prefix", 0, 4),
    ("full", 0, None)])
def test_simple_attention_masks_match(mode, window, prefix):
    q, k, v = _x(2, 8, 2, 3, 16), _x(2, 8, 2, 16, seed=1), \
        _x(2, 8, 2, 16, seed=2)
    got = attention.simple_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        mode=mode, window=window, prefix_len=prefix)
    ref = j_attn.simple_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), mode=mode, window=window,
                                  prefix_len=prefix)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_attention_block_matches_with_bias_and_gqa():
    cfg = get_arch("starcoder2-3b").reduced(d_model=64)    # GQA + bias
    jp, _ = j_common.split_tree(j_attn.init_attention(jax.random.PRNGKey(0),
                                                      cfg))
    jp = jax.tree.map(lambda v: v + 0.02, jp)
    x = _x(2, 10, 64)
    got = attention.attention_block(
        params_from_jax(jax.tree.map(np.asarray, jp), "cpu"), cfg,
        torch.from_numpy(x), mode="sliding", window=4)
    ref = j_attn.attention_block(jp, cfg, jnp.asarray(x), mode="sliding",
                                 window=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


def test_unported_kinds_and_long_sequences_raise():
    """Kept under its old name: the kinds still to port (vlm, audio)
    raise with item 6c; the moe kind, once refused, now runs (a reduced
    llama4 of each layout gives a finite loss with both aux terms; held
    to the reference in tests/test_torch_moe.py); a sequence past 2,048
    tokens, once refused, now trains through ``flash_attention`` and its
    loss equals the reference's flash path (rtol 1e-5)."""
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, 64, size=(2, 8)))
    for name, cfg in ARCHS.items():
        if cfg.kind in ("dense", "ssm", "hybrid"):     # ported earlier
            continue
        m = build_model(cfg.reduced(d_model=64, d_ff=128, vocab_size=64))
        if cfg.kind != "moe":
            with pytest.raises(NotImplementedError,
                               match="Queue 1 item 6c"):
                m.init(torch.Generator(), "cpu")
            continue
        p = m.init(torch.Generator().manual_seed(0), "cpu")
        _, aux = m.forward(p, {"tokens": toks}, dtype=torch.float32)
        assert set(aux) == {"load_balance", "router_z"}
        assert torch.isfinite(m.loss(p, {"tokens": toks, "labels": toks},
                                     dtype=torch.float32))
    kw = dict(d_model=64, vocab_size=64)
    cfg = get_arch("qwen1.5-0.5b").reduced(**kw)
    jcfg = j_get_arch("qwen1.5-0.5b").reduced(**kw)
    jp = j_build_model(jcfg).init(jax.random.PRNGKey(0))
    p = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    long = np.random.default_rng(0).integers(0, 64, size=(1, 2049))
    tl = torch.from_numpy(long)
    jl = jnp.asarray(long, jnp.int32)
    got = build_model(cfg).loss(p, {"tokens": tl, "labels": tl},
                                dtype=torch.float32)
    want = jax.jit(lambda pp: j_build_model(jcfg).loss(
        pp, {"tokens": jl, "labels": jl}, dtype=jnp.float32))(jp)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert tree_map(lambda v: v.shape, p)["embed"] == (256, 64)
