"""The vlm kind (paligemma-3b: a prefix LM over 256 stub patch
embeddings) and the audio kind (whisper-small: an encoder over stub
frames, cross-attention in every decoder layer), and the encdec kind
(whisper-small with ``kind="encdec"``: no arch has it, and the reference
runs it down the audio kind's branches), of the port against the
reference on the CPU: the parameter trees, the forward, the loss and the
gradient, and a 2,100-token whisper decoder through ``flash_attention``
in both its self- and cross-attention. Serving is in
``tests/test_torch_serve_vlm_audio.py``.

Configs are the archs' ``reduced()`` defaults (2 layers, d 256,
vocabulary 512): paligemma keeps its 256 patches, whisper gets 2 + 2
layers and 16 frames. Weights are the reference's, perturbed so that
the zero-initialized norm scales and biases carry gradients, carried by
``params_from_jax``; tokens and frontend embeddings are seeded numpy
draws.

Tolerances, and why:
- logits within 1e-5 and the loss rtol 1e-5, each gradient leaf within
  1e-5 relative L2, in float32 (products summed in another order on the
  two sides);
- in bfloat16 the loss rtol 2e-2 and each gradient leaf within 2e-2
  relative L2 (the scale tolerance: XLA rounds between elementwise ops
  that torch fuses);
- the 2,100-token case: the tolerances of ``tests/test_torch_flash.py``,
  every gradient within 5e-5 and the logits within 2e-5 of their max
  |logit| (1.64 here). Not 2e-5 absolute: XLA's float32 ``exp`` is one
  ulp off at 14 of the 128 sinusoid frequencies (torch's at 2, against
  float64 rounded), which moves the decoder's position embedding by up
  to 1.2e-4 at position 2,100 and the logits by up to 2.0e-5; the port's
  flash and materialized paths agree within 1.5e-6, as the reference's
  do.
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

from repro_torch.configs import get_arch
from repro_torch.models import build_model, params_from_jax
from repro_torch.models.common import tree_from_items, tree_items

PALIGEMMA, WHISPER = "paligemma-3b", "whisper-small"
# name -> (arch, kind override)
CASES = {"vlm": (PALIGEMMA, None), "audio": (WHISPER, None),
         "encdec": (WHISPER, "encdec")}


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _cfgs(case):
    """(port cfg, reference cfg) of the reduced arch."""
    arch, kind = CASES[case]
    over = {"kind": kind} if kind else {}
    return tuple(dataclasses.replace(get(arch).reduced(), **over)
                 for get in (get_arch, j_get_arch))


@functools.lru_cache(maxsize=None)
def _carried(case, scale=0.01):
    """(port cfg, reference cfg, reference params, port params): the
    reference's init plus ``scale`` times a normal perturbation."""
    cfg, jcfg = _cfgs(case)
    jp = jax.jit(j_build_model(jcfg).init)(jax.random.PRNGKey(0))
    leaves, tdef = jax.tree.flatten(jp)
    keys = jax.random.split(jax.random.PRNGKey(1), len(leaves))
    jp = jax.tree.unflatten(tdef, [l + scale * jax.random.normal(k, l.shape)
                                   for l, k in zip(leaves, keys)])
    return cfg, jcfg, jp, jax.tree.map(np.asarray, jp)


def batch_for(cfg, B, T, seed):
    """Tokens, labels and the kind's frontend embeddings (standard
    normal x 0.1, float32), as numpy arrays."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(B, T + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    name = "patches" if cfg.kind == "vlm" else "frames"
    out[name] = rng.standard_normal((B, cfg.enc_seq_len, cfg.d_model),
                                    dtype=np.float32) * np.float32(0.1)
    return out


def _loss_and_grads(cfg, jcfg, jp, np_params, batch, dtype):
    """(reference loss, its gradient leaves, port loss, its gradient
    leaves, the port's leaf paths)."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jloss, jgrad = jax.jit(jax.value_and_grad(
        lambda pp: j_build_model(jcfg).loss(
            pp, {k: jnp.asarray(v) for k, v in batch.items()},
            dtype=jdt)))(jp)
    items = tree_items(params_from_jax(np_params, "cpu"))
    leaves = [v.requires_grad_(True) for _, v in items]
    loss = build_model(cfg).loss(
        tree_from_items((k, l) for (k, _), l in zip(items, leaves)),
        {k: torch.from_numpy(v) for k, v in batch.items()}, dtype=tdt)
    grads = [g.numpy() for g in torch.autograd.grad(loss, leaves)]
    return (float(jloss), [np.asarray(g) for g in jax.tree.leaves(jgrad)],
            float(loss.detach()), grads, [k for k, _ in items])


# ------------------------------------------------------------- the trees

@pytest.mark.parametrize("case", sorted(CASES))
def test_parameter_tree_matches_reference(case):
    """The reference's leaf paths, order, shapes and logical axes (the
    flat carrier's offsets and the checkpoints depend on them) at the
    reduced size and, through ``abstract_params``, at the full size:
    paligemma's plain ``layers``; whisper's ``enc_layers``,
    ``enc_ln_final`` and decoder ``layers`` with ``cross`` and
    ``ln_cross``, where JAX sorts them."""
    cfg, jcfg = _cfgs(case)
    for c, jc in ((cfg, jcfg), (get_arch(CASES[case][0]),
                                j_get_arch(CASES[case][0]))):
        if c.kind != cfg.kind:
            c, jc = (dataclasses.replace(x, kind=cfg.kind) for x in (c, jc))
        shapes, axes = build_model(c).abstract_params()
        jshapes, jaxes = j_build_model(jc).abstract_params()
        got = [(k, tuple(v.shape)) for k, v in tree_items(shapes)]
        want = [(tuple(getattr(e, "key", e) for e in path), tuple(v.shape))
                for path, v in
                jax.tree_util.tree_flatten_with_path(jshapes)[0]]
        assert got == want
        assert [a for _, a in tree_items(axes)] == jax.tree.leaves(
            jaxes, is_leaf=lambda x: isinstance(x, tuple))
    if cfg.kind == "vlm":
        assert sorted(shapes) == ["embed", "layers", "ln_final"]
        # param_count() says 2,508,587,008: it counts no norm and the
        # vocabulary unpadded (257,216 of the 257,280 rows)
        assert sum(int(np.prod(v.shape)) for _, v in tree_items(shapes)) \
            == 2_508_793_856
    else:
        assert sorted(shapes) == ["embed", "enc_layers", "enc_ln_final",
                                  "layers", "ln_final"]
        assert sorted(shapes["layers"]) == ["attn", "cross", "ln_attn",
                                            "ln_cross", "ln_mlp", "mlp"]
        assert "cross" not in shapes["enc_layers"]
        assert shapes["layers"]["cross"]["wk"].shape == (12, 768, 768)


# ------------------------------------------- forward, loss and gradient

@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_reference(case):
    """The text positions' logits, (B, T, V): for the vlm kind the 256
    patch positions are cut after the final norm, as the reference's."""
    cfg, jcfg, jp, np_params = _carried(case)
    batch = batch_for(cfg, 2, 12, seed=0)
    feed = {k: v for k, v in batch.items() if k != "labels"}
    jl, _ = jax.jit(lambda pp: j_build_model(jcfg).forward(
        pp, {k: jnp.asarray(v) for k, v in feed.items()},
        dtype=jnp.float32))(jp)
    logits, aux = build_model(cfg).forward(
        params_from_jax(np_params, "cpu"),
        {k: torch.from_numpy(v) for k, v in feed.items()},
        dtype=torch.float32)
    assert aux == {} and logits.shape == (2, 12, cfg.padded_vocab)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_and_gradient_match_reference(case, dtype):
    """The loss and every parameter's gradient: the patches' and frames'
    paths included (the encoder's layers, ``enc_ln_final``, the cross
    blocks' K/V projections)."""
    cfg, jcfg, jp, np_params = _carried(case)
    batch = batch_for(cfg, 2, 12, seed=1)
    jloss, want, loss, grads, paths = _loss_and_grads(
        cfg, jcfg, jp, np_params, batch, dtype)
    assert len(grads) == len(want)
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(loss, jloss, rtol=tol)
    for path, a, b in zip(paths, grads, want):
        assert np.abs(b).max() > 0, path
        assert _rel_l2(a, b) <= tol, (path, _rel_l2(a, b))


def test_long_decoder_through_flash_matches_reference():
    """A 2,100-token whisper decoder (the encdec and audio kinds' long
    decode context): its causal self-attention and its cross-attention
    over the 16 frames both pass the 2,048 threshold and run through
    ``flash_attention``; the logits within 2e-5 of max |logit|, the loss
    rtol 1e-5 and every parameter's gradient within 5e-5 of the
    reference's."""
    cfg, jcfg, jp, np_params = _carried("audio")
    batch = batch_for(cfg, 1, 2100, seed=2)
    feed = {k: v for k, v in batch.items() if k != "labels"}
    jl, _ = jax.jit(lambda pp: j_build_model(jcfg).forward(
        pp, {k: jnp.asarray(v) for k, v in feed.items()},
        dtype=jnp.float32))(jp)
    from repro_torch.models import attention
    calls = []
    original = attention.flash_attention

    def counted(*a, **kw):
        calls.append(kw["k_len"])
        return original(*a, **kw)

    attention.flash_attention = counted
    try:
        logits, _ = build_model(cfg).forward(
            params_from_jax(np_params, "cpu"),
            {k: torch.from_numpy(v) for k, v in feed.items()},
            dtype=torch.float32)
    finally:
        attention.flash_attention = original
    # per decoder layer: self-attention (keys padded to 3,072, k_len
    # 2,100), then the cross block (16 keys in one chunk, no padding)
    assert calls == [2100, None] * cfg.num_layers
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl),
                               atol=2e-5 * float(np.abs(jl).max()), rtol=0)
    jloss, want, loss, grads, _ = _loss_and_grads(
        cfg, jcfg, jp, np_params, batch, "float32")
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    for a, b in zip(grads, want):
        np.testing.assert_allclose(a, b, atol=5e-5, rtol=0)
