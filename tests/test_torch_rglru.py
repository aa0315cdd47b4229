"""The port's RG-LRU block (``repro_torch.models.rglru``) against
``repro/models/rglru.py`` on the CPU: the same seeded numpy inputs and the
reference's parameters (``params_from_jax``) on both sides.

Tolerances, and why:
- the block, its gates and its conv within 1e-5 of the reference (the
  port's log-depth scan sums the recurrence in another tree than
  ``jax.lax.associative_scan``, float32 both);
- the scan within 1e-5 of a Python loop of T steps (the oracle);
- decode step by step against the full forward: rtol 1e-3, atol 1e-4,
  as ``tests/test_ssm_rglru.py``;
- the ``lam`` init within rtol 1e-5 of the reference's: the formula is
  the reference's, but XLA's float32 ``linspace`` and ``log``/``expm1``
  round otherwise than torch's (ROADMAP.md Queue 3).
"""
import _torch_threads  # noqa: F401  (torch threads per xdist worker)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.models import rglru as j_rglru
from repro.models.common import split_tree as j_split_tree

from repro_torch.configs import get_arch
from repro_torch.models import params_from_jax, rglru
from repro_torch.models.common import split_tree, tree_items


def _cfgs(d=64):
    kw = dict(d_model=d, d_ff=2 * d)
    return (get_arch("recurrentgemma-9b").reduced(**kw),
            j_get_arch("recurrentgemma-9b").reduced(**kw))


def _params(seed=0, d=64):
    cfg, jcfg = _cfgs(d)
    jp, _ = j_split_tree(j_rglru.init_rglru(jax.random.PRNGKey(seed), jcfg))
    # non-zero biases, so that the gates' bias terms are exercised
    jp = dict(jp, b_a=jp["b_a"] + 0.1, b_x=jp["b_x"] - 0.2)
    return cfg, jcfg, params_from_jax(jax.tree.map(np.asarray, jp), "cpu"), jp


def _x(B, T, d, seed=1):
    return (np.random.default_rng(seed).normal(size=(B, T, d)) * 0.3
            ).astype(np.float32)


@pytest.mark.parametrize("d", [32, 64])
def test_init_matches_reference_layout_and_lambda(d):
    """The same leaves, shapes and logical axes; the deterministic
    ``lam`` within rtol 1e-5 of the reference's; the random leaves with
    the reference's scales."""
    cfg, jcfg = _cfgs(d)
    params, axes = split_tree(rglru.init_rglru(
        torch.Generator().manual_seed(0), cfg, device="cpu"))
    jparams, jaxes = j_split_tree(j_rglru.init_rglru(jax.random.PRNGKey(0),
                                                     jcfg))
    assert [(k, tuple(v.shape)) for k, v in tree_items(params)] == \
        [(k, tuple(v.shape)) for k, v in tree_items(
            jax.tree.map(np.asarray, jparams))]
    assert axes == jaxes
    np.testing.assert_allclose(params["lam"].numpy(),
                               np.asarray(jparams["lam"]), rtol=1e-5)
    assert not params["b_a"].any() and not params["b_x"].any()
    assert abs(float(params["conv"].std()) - 0.1) < 0.03


def test_gates_and_causal_conv_match_reference():
    cfg, _, p, jp = _params()
    xb = _x(2, 9, cfg.d_model, seed=3)
    a, beta = rglru._gates(p, torch.from_numpy(xb))
    ja, jbeta = j_rglru._gates(jp, jnp.asarray(xb))
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), atol=1e-6, rtol=0)
    np.testing.assert_allclose(beta.numpy(), np.asarray(jbeta), atol=1e-6,
                               rtol=0)
    assert bool((a > 0).all() and (a < 1).all() and (beta >= 0).all())
    state = _x(2, cfg.rglru_conv_width - 1, cfg.d_model, seed=4)
    for st in (None, state):
        y, new = rglru._causal_conv(
            torch.from_numpy(xb), p["conv"],
            None if st is None else torch.from_numpy(st))
        jy, jnew = j_rglru._causal_conv(
            jnp.asarray(xb), jp["conv"], None if st is None
            else jnp.asarray(st))
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-6)
        np.testing.assert_array_equal(new.numpy(), np.asarray(jnew))


@pytest.mark.parametrize("T", [1, 2, 3, 5, 8, 33, 100])
def test_linear_scan_matches_the_loop(T):
    """The log-depth scan against T steps of h = a h + b (the oracle),
    and against the reference's associative scan."""
    rng = np.random.default_rng(T)
    a = rng.uniform(0.5, 1.0, size=(2, T, 16)).astype(np.float32)
    b = rng.normal(size=(2, T, 16)).astype(np.float32)
    got = rglru.linear_scan(torch.from_numpy(a), torch.from_numpy(b))
    h = np.zeros((2, 16), np.float32)
    loop = []
    for t in range(T):
        h = a[:, t] * h + b[:, t]
        loop.append(h)
    np.testing.assert_allclose(got.numpy(), np.stack(loop, 1), atol=1e-5,
                               rtol=0)
    _, ref = jax.jit(lambda aa, bb: jax.lax.associative_scan(
        lambda l, r: (l[0] * r[0], r[0] * l[1] + r[1]), (aa, bb),
        axis=1))(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("T", [1, 7, 40])
def test_apply_rglru_matches_reference(T):
    cfg, jcfg, p, jp = _params()
    x = _x(2, T, cfg.d_model)
    got = rglru.apply_rglru(p, cfg, torch.from_numpy(x))
    ref = jax.jit(lambda pp, xx: j_rglru.apply_rglru(pp, jcfg, xx))(
        jp, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)


def test_sequence_with_carried_state_continues_the_full_sequence():
    """Two halves, the second from the first's final state and conv
    context (the chunked prefill's path), equal the whole sequence."""
    cfg, _, p, _ = _params()
    x = torch.from_numpy(_x(2, 20, cfg.d_model, seed=5))
    whole, hs, pre = rglru.rglru_sequence(p, x)
    first, hs1, pre1 = rglru.rglru_sequence(p, x[:, :12])
    K = cfg.rglru_conv_width
    second, hs2, _ = rglru.rglru_sequence(
        p, x[:, 12:], conv0=pre1[:, 12 - (K - 1):], h0=hs1[:, -1])
    np.testing.assert_allclose(torch.cat([first, second], 1).numpy(),
                               whole.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(hs2[:, -1].numpy(), hs[:, -1].numpy(),
                               atol=1e-5, rtol=0)


def test_decode_matches_full_forward_and_reference():
    """tests/test_ssm_rglru.py's case: T single-token decode steps from
    a zero cache equal the full forward (rtol 1e-3, atol 1e-4); each
    step's output and state equal the reference's decode (1e-5)."""
    cfg, jcfg, p, jp = _params()
    B, T = 2, 10
    x = _x(B, T, cfg.d_model, seed=2)
    full = rglru.apply_rglru(p, cfg, torch.from_numpy(x))
    cache = rglru.init_rglru_cache(cfg, B, torch.float32, device="cpu")
    jcache = j_rglru.init_rglru_cache(jcfg, B, jnp.float32)
    assert {k: tuple(v.shape) for k, v in cache.items()} == \
        {k: tuple(v.shape) for k, v in jcache.items()}
    outs = []
    for t in range(T):
        y, cache = rglru.decode_rglru(p, cfg, torch.from_numpy(x[:, t:t + 1]),
                                      cache)
        jy, jcache = j_rglru.decode_rglru(jp, jcfg, jnp.asarray(x[:, t:t + 1]),
                                          jcache)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5,
                                   rtol=0)
        for k in cache:
            np.testing.assert_allclose(cache[k].numpy(),
                                       np.asarray(jcache[k]), atol=1e-5,
                                       rtol=0)
        outs.append(y)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                               rtol=1e-3, atol=1e-4)


def test_rglru_gradient_matches_reference():
    """d/d(params, x) of sum(out^2) through the log-depth scan against
    the reference's grad through its associative scan (1e-5)."""
    cfg, jcfg, p, jp = _params()
    x = _x(2, 17, cfg.d_model, seed=6)
    jg, jgx = jax.jit(jax.grad(lambda pp, xx: (j_rglru.apply_rglru(
        pp, jcfg, xx) ** 2).sum(), argnums=(0, 1)))(jp, jnp.asarray(x))
    for v in p.values():
        v.requires_grad_()
    tx = torch.tensor(x, requires_grad=True)
    (rglru.apply_rglru(p, cfg, tx) ** 2).sum().backward()
    for k in p:
        np.testing.assert_allclose(p[k].grad.numpy(), np.asarray(jg[k]),
                                   atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), atol=1e-5,
                               rtol=1e-5)
