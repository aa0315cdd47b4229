"""The pair-scheduled flash attention of the port
(``repro_torch.models.attention.flash_attention_pairs``, ``pair_schedule``)
against the reference's: the modes, windows and prefixes of
``tests/test_attention.py``'s pair test, forward within 2e-5 and
gradients within 5e-5, from numpy-seeded inputs; the block schedule
(fewer blocks than the rectangular sweep); and serving under
``pair_schedule``: a one-shot prefill past 2,048 tokens equal to the
same prefill without it, and to the reference's under its switch.
"""
import _torch_threads  # noqa: F401  (torch threads per xdist worker)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.models import attention as jattn
from repro.models import build_model as j_build_model
from repro_torch.configs import get_arch
from repro_torch.models import attention as attn
from repro_torch.models import build_model
from repro_torch.models.common import params_from_jax

MODES = [("causal", 0, None), ("sliding", 48, None), ("prefix", 0, 37)]


def _qkv(B=1, T=128, K=2, G=2, hd=16, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T, K, G, hd)).astype(np.float32),
            rng.standard_normal((B, T, K, hd)).astype(np.float32),
            rng.standard_normal((B, T, K, hd)).astype(np.float32))


@pytest.mark.parametrize("mode,window,prefix", MODES,
                         ids=[m[0] for m in MODES])
def test_pairs_match_reference(mode, window, prefix):
    q, k, v = _qkv()
    kw = dict(mode=mode, window=window, prefix_len=prefix, q_chunk=32,
              k_chunk=32)
    jo = jattn.flash_attention_pairs(q, k, v, **kw)
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = attn.flash_attention_pairs(*leaves, **kw)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jo),
                               atol=2e-5)
    # the reference test's loss: the sum of squared outputs
    jg = jax.grad(lambda *a: (jattn.flash_attention_pairs(*a, **kw) ** 2)
                  .sum(), argnums=(0, 1, 2))(q, k, v)
    (out ** 2).sum().backward()
    for t, j in zip(leaves, jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), atol=5e-5)
    # and the pair schedule computes the rectangular sweep's attention
    rect = attn.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                **kw)
    np.testing.assert_allclose(out.detach().numpy(), rect.numpy(),
                               atol=2e-5)


def test_pairs_with_key_padding_and_offset():
    """``k_len`` masks padded keys and ``q_offset`` shifts the queries,
    as the reference's do."""
    q, k, v = _qkv(T=96, seed=1)
    kw = dict(mode="causal", q_chunk=32, k_chunk=32, k_len=80, q_offset=0)
    jo = jattn.flash_attention_pairs(q, k, v, **kw)
    out = attn.flash_attention_pairs(*(torch.from_numpy(x)
                                       for x in (q, k, v)), **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(jo), atol=2e-5)
    kw = dict(mode="sliding", window=40, q_chunk=32, k_chunk=32,
              q_offset=32)
    jo = jattn.flash_attention_pairs(q[:, :64], k, v, **kw)
    out = attn.flash_attention_pairs(torch.from_numpy(q[:, :64]),
                                     torch.from_numpy(k),
                                     torch.from_numpy(v), **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(jo), atol=2e-5)


def test_pair_schedule_visits_fewer_blocks():
    for args in ((8, 8, 64, 64, "full", 0, None, 0),
                 (8, 8, 64, 64, "causal", 0, None, 0),
                 (8, 8, 64, 64, "sliding", 64, None, 0),
                 (8, 8, 64, 64, "prefix", 0, 100, 0),
                 (8, 16, 512, 256, "sliding", 1024, None, 512)):
        assert attn._block_pairs(*args) == jattn._block_pairs(*args), args
    assert len(attn._block_pairs(8, 8, 64, 64, "full", 0, None, 0)) == 64
    assert len(attn._block_pairs(8, 8, 64, 64, "causal", 0, None, 0)) == 36
    assert len(attn._block_pairs(8, 8, 64, 64, "sliding", 64, None,
                                 0)) == 15


def test_pair_schedule_switch_restores():
    assert attn.PAIR_SCHEDULE is False
    with attn.pair_schedule():
        assert attn.PAIR_SCHEDULE is True
        with attn.pair_schedule(False):
            assert attn.PAIR_SCHEDULE is False
        assert attn.PAIR_SCHEDULE is True
    assert attn.PAIR_SCHEDULE is False


def test_pair_schedule_serving_past_the_flash_threshold():
    """A reduced starcoder2 (sliding window) prefills 2,100 tokens
    through flash: under ``pair_schedule`` the port's logits equal its
    rectangular sweep's and the reference's under its own switch."""
    kw = dict(d_model=64, d_ff=128, vocab_size=128)
    jcfg = j_get_arch("starcoder2-3b").reduced(**kw)
    cfg = get_arch("starcoder2-3b").reduced(**kw)
    jmodel, model = j_build_model(jcfg), build_model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0), jnp.float32)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    tokens = np.random.default_rng(0).integers(
        1, cfg.vocab_size, size=(1, 2100)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(tokens)}
    calls = []
    original = attn.flash_attention_pairs

    def counted(*a, **k):
        calls.append(1)
        return original(*a, **k)

    with torch.no_grad():
        base, _, _ = model.prefill(params, batch, dtype=torch.float32,
                                   cache_dtype=torch.float32)
        attn.flash_attention_pairs = counted
        try:
            with attn.pair_schedule():
                pair, _, _ = model.prefill(params, batch,
                                           dtype=torch.float32,
                                           cache_dtype=torch.float32)
        finally:
            attn.flash_attention_pairs = original
    assert len(calls) == cfg.num_layers
    scale = float(base.abs().max())
    np.testing.assert_allclose(pair.numpy(), base.numpy(),
                               atol=1e-5 * scale)
    with jattn.pair_schedule(True):
        jpair, _, _ = jmodel.prefill(jparams, {"tokens": tokens},
                                     dtype=jnp.float32,
                                     cache_dtype=jnp.float32)
    np.testing.assert_allclose(pair.numpy(), np.asarray(jpair),
                               atol=2e-5 * scale)
