"""The port's optimizers (``repro_torch.optim``) against the reference's
(``repro.optim``): each update and its state on the same trees, from
numpy-seeded float32 inputs, to 1e-6; the reference's quadratic
convergence cases and its manual SGD case."""
import _torch_threads  # noqa: F401  (torch threads per xdist worker)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro_torch import optim as topt

SHAPES = {"a": (3, 5), "b": {"c": (7,), "d": (2, 2, 3)}}


def _tree(rng, shapes):
    return {k: _tree(rng, v) if isinstance(v, dict)
            else rng.standard_normal(v).astype(np.float32)
            for k, v in shapes.items()}


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _leaves(tree):
    out = []
    for k in sorted(tree):
        v = tree[k]
        out.extend(_leaves(v) if isinstance(v, dict) else [v])
    return out


def _close(t_tree, j_tree, tol=1e-6):
    for t, j in zip(_leaves(t_tree), _leaves(j_tree)):
        np.testing.assert_allclose(np.asarray(t), np.asarray(j), atol=tol,
                                   rtol=0)


CASES = [
    ("sgd", dict(), dict()),
    ("sgd_wd", dict(weight_decay=0.1), dict(weight_decay=0.1)),
    ("momentum", dict(beta=0.9), dict(beta=0.9)),
    ("nesterov_wd", dict(beta=0.8, weight_decay=0.05, nesterov=True),
     dict(beta=0.8, weight_decay=0.05, nesterov=True)),
    ("adamw", dict(), dict()),
    ("adamw_wd", dict(weight_decay=0.01), dict(weight_decay=0.01)),
]


@pytest.mark.parametrize("name,jkw,tkw", CASES, ids=[c[0] for c in CASES])
def test_update_and_state_match_reference(name, jkw, tkw):
    base = name.split("_")[0]
    jfac = {"sgd": jopt.sgd, "momentum": jopt.momentum,
            "nesterov": jopt.momentum, "adamw": jopt.adamw}[base]
    tfac = {"sgd": topt.sgd, "momentum": topt.momentum,
            "nesterov": topt.momentum, "adamw": topt.adamw}[base]
    jo, to = jfac(**jkw), tfac(**tkw)
    rng = np.random.default_rng(0)
    params = _tree(rng, SHAPES)
    jp = _map(jnp.asarray, params)
    tp = _map(torch.from_numpy, params)
    js, ts = jo.init(jp), to.init(tp)
    for step, lr in enumerate((0.1, 0.05, 1e-3)):
        grads = _tree(rng, SHAPES)
        ju, js = jo.update(_map(jnp.asarray, grads), js, jp, lr)
        tu, ts = to.update(_map(torch.from_numpy, grads), ts, tp,
                           torch.tensor(lr) if step % 2 else lr)
        _close(tu, ju)
        if base != "sgd":
            _close(ts["m"], js["m"])
        if base == "adamw":
            _close(ts["v"], js["v"])
            assert int(ts["count"]) == int(js["count"]) == step + 1
            assert ts["count"].dtype == torch.int32
        jp = jopt.apply_updates(jp, ju)
        tp = topt.apply_updates(tp, tu)
        _close(tp, jp)


def _quad_problem():
    """min 0.5||w - 3||^2 — every optimizer must converge."""
    w0 = {"w": torch.zeros((4,))}
    grad = lambda w: {"w": w["w"] - 3.0}  # noqa: E731
    return w0, grad


@pytest.mark.parametrize("opt,lr,steps", [
    (topt.sgd(), 0.1, 200), (topt.momentum(0.9), 0.05, 200),
    (topt.adamw(), 0.1, 400),
], ids=["sgd", "momentum", "adamw"])
def test_optimizers_converge_quadratic(opt, lr, steps):
    w, grad = _quad_problem()
    state = opt.init(w)
    for _ in range(steps):
        updates, state = opt.update(grad(w), state, w, lr)
        w = topt.apply_updates(w, updates)
    np.testing.assert_allclose(w["w"].numpy(), 3.0, atol=1e-2)


def test_sgd_matches_manual():
    opt = topt.sgd(weight_decay=0.1)
    w = {"w": torch.tensor([1.0, 2.0])}
    g = {"w": torch.tensor([0.5, -0.5])}
    updates, _ = opt.update(g, opt.init(w), w, 0.1)
    expect = -0.1 * (np.array([0.5, -0.5]) + 0.1 * np.array([1.0, 2.0]))
    np.testing.assert_allclose(updates["w"].numpy(), expect, atol=1e-6)
    out = topt.apply_updates(w, updates)
    np.testing.assert_allclose(out["w"].numpy(), [1.0, 2.0] + expect,
                               atol=1e-6)


def test_bf16_params_keep_their_dtype():
    w = {"w": torch.ones((3,), dtype=torch.bfloat16)}
    g = {"w": torch.full((3,), 0.5)}
    for opt in (topt.sgd(), topt.momentum(), topt.adamw()):
        u, _ = opt.update(g, opt.init(w), w, 0.1)
        assert u["w"].dtype == torch.bfloat16


def test_make_optimizer_names():
    assert topt.make_optimizer("sgd").name == "sgd"
    assert topt.make_optimizer("momentum").name == "momentum"
    assert topt.make_optimizer("adamw").name == "adamw"
    with pytest.raises(ValueError, match="unknown optimizer"):
        topt.make_optimizer("lion")
