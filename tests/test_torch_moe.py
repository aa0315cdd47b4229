"""The moe kind (llama4-scout: an MoE FFN in every layer; llama4-maverick:
``groups`` of ``{dense_0, moe}``) of the port against the reference on
the CPU: ``apply_moe`` at a capacity that binds and one that does not,
with and without a token mask; the routing invariants of
``tests/test_moe.py``; the parameter trees; and the model's forward,
loss and gradient for both layouts. Serving is in
``tests/test_torch_serve_moe.py``, scale mode in
``tests/test_torch_scale_moe.py``.

Configs are ``reduced()`` llama4s cut to d 64 (4 experts, vocabulary
128); maverick at 5 layers, so that its 2 groups drop a remainder layer
as the reference's do. Weights are the reference's, carried by
``params_from_jax``; inputs are seeded numpy draws.

Tolerances, and why:
- ``apply_moe``'s y within 1e-5 and its aux rtol 1e-5 (float32 on both
  sides, products summed in another order; the routing, capacity and
  drops are exact);
- the forward's logits within 1e-5 and aux rtol 1e-5; the loss rtol
  1e-5 and each gradient leaf within 1e-5 relative L2 in float32; in
  bfloat16 the loss and the whole gradient within 2e-2 (the scale
  tolerance: XLA rounds between elementwise ops that torch fuses);
- a row routed in a batch under ``token_mask`` against the same row
  alone: within 1e-6.
"""
import _torch_threads  # noqa: F401  (torch threads per xdist worker)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.models import build_model as j_build_model
from repro.models import moe as j_moe
from repro.models.common import split_tree as j_split_tree

from repro_torch.configs import get_arch
from repro_torch.models import build_model, params_from_jax
from repro_torch.models import moe
from repro_torch.models.common import split_tree, tree_from_items, tree_items

SCOUT, MAVERICK = "llama4-scout-17b-a16e", "llama4-maverick-400b-a17b"
KW = dict(d_model=64, d_ff=128, vocab_size=128)
LAYERS = {SCOUT: 2, MAVERICK: 5}
ATOL = 1e-5


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _cfgs(arch, **over):
    """(port cfg, reference cfg) of the reduced arch."""
    kw = dict(KW, num_layers=LAYERS[arch])
    return tuple(dataclasses.replace(get(arch).reduced(**kw), **over)
                 for get in (get_arch, j_get_arch))


def _moe_pair(cf, E=4, d=64, f=128, seed=0):
    """(port cfg, reference cfg, port params, reference params) of one
    MoE FFN, the reference's init carried across."""
    cfg, jcfg = (dataclasses.replace(c, d_model=d, d_ff=f,
                                     moe_num_experts=E,
                                     moe_capacity_factor=cf)
                 for c in _cfgs(SCOUT))
    jp, _ = j_split_tree(j_moe.init_moe(jax.random.PRNGKey(seed), jcfg))
    return cfg, jcfg, params_from_jax(jax.tree.map(np.asarray, jp),
                                      "cpu"), jp


def _x(*shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _mask(B, T, lens):
    return np.arange(T)[None, :] < np.asarray(lens)[:, None]


# ---------------------------------------------------------------- apply_moe

@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("cf", [1.25, 0.01])
def test_apply_moe_matches_reference(cf, masked):
    """The default capacity factor 1.25 (c = 5 a group of 16 tokens over 4
    experts) and a binding 0.01 (c = 1), over rows of 16 tokens with and
    without a mask of 5 and 11 real tokens: y, load_balance, router_z and
    drop_frac."""
    cfg, jcfg, p, jp = _moe_pair(cf)
    x = _x(2, 16, 64)
    mask = _mask(2, 16, [5, 11]) if masked else None
    y, aux = moe.apply_moe(p, cfg, torch.from_numpy(x),
                           token_mask=None if mask is None
                           else torch.from_numpy(mask))
    jy, jaux = j_moe.apply_moe(jp, jcfg, jnp.asarray(x),
                               token_mask=None if mask is None
                               else jnp.asarray(mask))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=ATOL, rtol=0)
    assert set(aux) == set(jaux) == {"load_balance", "router_z",
                                     "drop_frac"}
    for k in jaux:
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=1e-5,
                                   atol=1e-7)
    if cf == 0.01:
        assert float(aux["drop_frac"]) > 0.5
    if masked:                       # pads get y = 0
        assert not y[~torch.from_numpy(mask)].any()


@pytest.mark.parametrize("G", [1, 2048, 2049, 3000, 4096, 6000, 10_007])
def test_group_size_matches_reference(G):
    assert moe._group_size(G) == j_moe._group_size(G)
    assert G % moe._group_size(G) == 0 and moe._group_size(G) <= 2048


def test_apply_moe_past_2048_tokens_matches_reference():
    """3 x 1,000 tokens form 2 groups of 1,500 (``_group_size``), each
    with its own capacity of round(1500 * 1.25 / 4) = 469."""
    cfg, jcfg, p, jp = _moe_pair(1.25, d=16, f=32)
    x = _x(3, 1000, 16, seed=2)
    y, aux = moe.apply_moe(p, cfg, torch.from_numpy(x))
    jy, jaux = j_moe.apply_moe(jp, jcfg, jnp.asarray(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=ATOL, rtol=0)
    for k in jaux:
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=1e-5,
                                   atol=1e-7)


def test_masked_rows_route_as_they_would_alone():
    """At the default capacity factor, a row of a masked batch gives the
    same y as that row alone under its own mask: pads take no capacity
    and the rows share none."""
    cfg, _, p, _ = _moe_pair(1.25)
    x = torch.from_numpy(_x(3, 16, 64, seed=3))
    lens = [5, 11, 16]
    mask = torch.from_numpy(_mask(3, 16, lens))
    y, _ = moe.apply_moe(p, cfg, x, token_mask=mask)
    for i in range(3):
        yi, _ = moe.apply_moe(p, cfg, x[i:i + 1], token_mask=mask[i:i + 1])
        np.testing.assert_allclose(y[i].numpy(), yi[0].numpy(), atol=1e-6,
                                   rtol=0)


# ------------------------------------------------ tests/test_moe.py's four

def _own(cf, E=4, d=64, f=128, seed=0):
    cfg = dataclasses.replace(_cfgs(SCOUT)[0], d_model=d, d_ff=f,
                              moe_num_experts=E, moe_capacity_factor=cf)
    p, _ = split_tree(moe.init_moe(torch.Generator().manual_seed(seed), cfg,
                                   device="cpu"))
    return cfg, p


def test_moe_output_shape_finite_and_balance_bound():
    cfg, p = _own(8.0)
    x = torch.randn((2, 16, 64), generator=torch.Generator().manual_seed(1))
    y, aux = moe.apply_moe(p, cfg, x)
    assert y.shape == x.shape and torch.isfinite(y).all()
    assert float(aux["load_balance"]) >= 1.0 - 1e-3  # Cauchy-Schwarz


def test_moe_no_drops_with_large_capacity():
    cfg, p = _own(16.0)
    x = torch.randn((2, 32, 64), generator=torch.Generator().manual_seed(2))
    _, aux = moe.apply_moe(p, cfg, x)
    assert float(aux["drop_frac"]) == 0.0


def test_moe_matches_manual_top1():
    """Dispatch and combine equal each token through its argmax expert
    when nothing overflows."""
    cfg, p = _own(32.0)
    x = torch.randn((1, 8, 64), generator=torch.Generator().manual_seed(3))
    y, _ = moe.apply_moe(p, cfg, x)
    xf = x.reshape(-1, 64)
    logits = xf @ p["router"]
    eid = torch.argmax(logits, -1)
    gate = torch.softmax(logits, -1).amax(-1)
    manual = torch.stack([
        (torch.nn.functional.silu(xf[i] @ p["w_gate"][e])
         * (xf[i] @ p["w_up"][e])) @ p["w_down"][e] * gate[i]
        for i, e in enumerate(eid.tolist())]).reshape(y.shape)
    np.testing.assert_allclose(y.numpy(), manual.numpy(), rtol=2e-3,
                               atol=2e-4)


def test_moe_capacity_drops_overflow():
    cfg, p = _own(0.01)
    x = torch.randn((4, 64, 64), generator=torch.Generator().manual_seed(4))
    y, aux = moe.apply_moe(p, cfg, x)
    assert float(aux["drop_frac"]) > 0.5 and torch.isfinite(y).all()


# ------------------------------------------------------------- the model

@pytest.mark.parametrize("arch", [SCOUT, MAVERICK])
def test_parameter_tree_matches_reference(arch):
    """Leaf paths (JAX's sorted order), shapes and logical axes of the
    reduced model; at full width through ``abstract_params``, the leaf
    shapes and scout's count at depth 4 (the chip's serve cell):
    10,376,033,280 leaves' entries, where ``param_count()`` says
    10,374,021,120 (it counts the vocabulary unpadded and no norm)."""
    cfg, jcfg = _cfgs(arch)
    jabs, jaxes = j_build_model(jcfg).abstract_params()
    tabs, taxes = build_model(cfg).abstract_params()
    assert [k for k, _ in tree_items(tabs)] == \
        [tuple(getattr(e, "key", e) for e in path) for path, _ in
         jax.tree_util.tree_flatten_with_path(jabs)[0]]
    assert [tuple(v.shape) for _, v in tree_items(tabs)] == \
        [tuple(v.shape) for v in jax.tree.leaves(jabs)]
    jax_axes = jax.tree.leaves(jaxes, is_leaf=lambda x: isinstance(x, tuple))
    assert [a for _, a in tree_items(taxes)] == [tuple(a) for a in jax_axes]
    own = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    assert [k for k, _ in tree_items(own)] == [k for k, _ in tree_items(tabs)]
    if arch == SCOUT:
        assert sorted(own["layers"]) == ["attn", "ln_attn", "ln_mlp", "moe"]
        assert taxes["layers"]["moe"]["w_up"] == \
            ("layers", "experts", "embed_fsdp", "expert_ffn")
        full = dataclasses.replace(get_arch(arch), num_layers=4)
    else:
        assert sorted(own["groups"]) == ["dense_0", "moe"]
        assert own["groups"]["moe"]["moe"]["w_up"].shape == (2, 4, 64, 128)
        assert "mlp" in own["groups"]["dense_0"]
        full = get_arch(arch)
    shapes, _ = build_model(full).abstract_params()
    jshapes, _ = j_build_model(dataclasses.replace(
        j_get_arch(arch), num_layers=full.num_layers)).abstract_params()
    got = [tuple(v.shape) for _, v in tree_items(shapes)]
    assert got == [tuple(v.shape) for v in jax.tree.leaves(jshapes)]
    if arch == SCOUT:
        assert sum(int(np.prod(s)) for s in got) == 10_376_033_280


def _carried(jcfg, seed=0, scale=0.0):
    """The reference's init (plus ``scale`` times a normal perturbation,
    so zero-initialized norm scales carry gradients), as both trees."""
    jp = j_build_model(jcfg).init(jax.random.PRNGKey(seed))
    if scale:
        leaves, tdef = jax.tree.flatten(jp)
        keys = jax.random.split(jax.random.PRNGKey(seed + 1), len(leaves))
        jp = jax.tree.unflatten(tdef, [
            l + scale * jax.random.normal(k, l.shape)
            for l, k in zip(leaves, keys)])
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _batch(cfg, B=2, T=16, seed=0):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(B, T + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@pytest.mark.parametrize("arch", [SCOUT, MAVERICK])
def test_forward_matches_reference(arch):
    """Logits and the aux means over the MoE layers (scout: 2, maverick:
    the 2 groups' moe members) at the default capacity factor, which
    binds: 32 tokens a group, c = 10 over 4 experts."""
    cfg, jcfg = _cfgs(arch)
    jp, p = _carried(jcfg)
    batch = _batch(cfg)
    jl, jaux = jax.jit(lambda pp: j_build_model(jcfg).forward(
        pp, {"tokens": jnp.asarray(batch["tokens"])},
        dtype=jnp.float32))(jp)
    logits, aux = build_model(cfg).forward(
        p, {"tokens": torch.from_numpy(batch["tokens"])},
        dtype=torch.float32)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=ATOL,
                               rtol=0)
    assert set(aux) == set(jaux) == {"load_balance", "router_z"}
    for k in jaux:
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=1e-5)


def _routes(monkeypatch, arch, jcfg, cfg, jp, p, tokens, dtype):
    """Each MoE layer's expert per token, (reference's, port's), from one
    forward of each side in ``dtype``."""
    jseen, seen = [], []
    j_apply, apply = j_moe.apply_moe, moe.apply_moe

    def j_spy(pp, c, x, *a, **kw):
        logits = jnp.einsum("btd,de->bte", x, pp["router"].astype(x.dtype))
        jax.debug.callback(lambda e: jseen.append(np.asarray(e)),
                           jnp.argmax(logits.astype(jnp.float32), -1))
        return j_apply(pp, c, x, *a, **kw)

    def spy(pp, c, x, *a, **kw):
        seen.append(torch.argmax((x @ pp["router"].to(x.dtype)).float(),
                                 -1).numpy())
        return apply(pp, c, x, *a, **kw)

    monkeypatch.setattr(j_moe, "apply_moe", j_spy)
    monkeypatch.setattr(moe, "apply_moe", spy)
    jax.block_until_ready(j_build_model(jcfg).forward(
        jp, {"tokens": jnp.asarray(tokens)}, dtype=getattr(jnp, dtype)))
    build_model(cfg).forward(p, {"tokens": torch.from_numpy(tokens)},
                             dtype=getattr(torch, dtype))
    monkeypatch.undo()
    assert len(jseen) == len(seen) == {SCOUT: 2, MAVERICK: 2}[arch]
    return np.stack(jseen), np.stack(seen)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", [SCOUT, MAVERICK])
def test_loss_and_gradient_match_reference(arch, dtype, monkeypatch):
    """The loss with both aux terms and its gradient through the router,
    the gate and the experts (perturbed weights, so the norm scales
    carry gradients).

    In bfloat16 the two frameworks round the residual stream at other
    places, and the router logits of a later layer differ by some 1e-2
    of their size; a token whose top two are that close routes to
    another expert on each side, and its FFN output and every gradient
    downstream part by O(1). So in bfloat16: the loss within 2e-2; at
    most one token in 16 routed differently; where every token routes
    alike (scout here), the whole gradient within 2e-2 relative L2; the
    MoE FFN's own bfloat16 gradient on identical inputs is held in
    ``test_apply_moe_gradient_in_bfloat16_matches_reference``."""
    cfg, jcfg = _cfgs(arch)
    jp, p = _carried(jcfg, scale=0.01)
    batch = _batch(cfg, seed=1)
    jroutes, routes = _routes(monkeypatch, arch, jcfg, cfg, jp, p,
                              batch["tokens"], dtype)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jloss, jgrad = jax.jit(jax.value_and_grad(
        lambda pp: j_build_model(jcfg).loss(
            pp, {k: jnp.asarray(v) for k, v in batch.items()},
            dtype=jdt)))(jp)
    items = tree_items(p)
    leaves = [v.requires_grad_(True) for _, v in items]
    loss = build_model(cfg).loss(
        tree_from_items((k, l) for (k, _), l in zip(items, leaves)),
        {k: torch.from_numpy(v) for k, v in batch.items()}, dtype=tdt)
    grads = [g.numpy() for g in torch.autograd.grad(loss, leaves)]
    want = [np.asarray(g) for g in jax.tree.leaves(jgrad)]
    assert len(grads) == len(want)
    if dtype == "float32":
        assert np.array_equal(routes, jroutes)
        np.testing.assert_allclose(float(loss.detach()), float(jloss),
                                   rtol=1e-5)
        for (path, _), a, b in zip(items, grads, want):
            assert _rel_l2(a, b) <= 1e-5, (path, _rel_l2(a, b))
        router = [g for (path, _), g in zip(items, grads)
                  if path[-1] == "router"]
        assert router and all(np.abs(g).max() > 0 for g in router)
        return
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=2e-2)
    parted = int((routes != jroutes).sum())
    assert parted <= routes.size // 16, (parted, routes.size)
    if parted == 0:
        assert _rel_l2(np.concatenate([a.ravel() for a in grads]),
                       np.concatenate([b.ravel() for b in want])) <= 2e-2


def test_apply_moe_gradient_in_bfloat16_matches_reference():
    """The MoE FFN in bfloat16 on identical bfloat16 inputs (the
    default capacity, a mask of 11 and 16 real tokens): the same routing
    on both sides, y within 2e-2 of max |y|, and the gradient of a fixed
    projection of y plus both aux losses, over the router, the experts
    and x, within 2e-2 relative L2."""
    cfg, jcfg, p, jp = _moe_pair(1.25)
    x = np.array(jnp.asarray(_x(2, 16, 64, seed=5), jnp.bfloat16)
                 .astype(jnp.float32))
    r = _x(2, 16, 64, seed=6)
    mask = _mask(2, 16, [11, 16])

    def j_obj(pp, xx):
        y, aux = j_moe.apply_moe(pp, jcfg, xx.astype(jnp.bfloat16),
                                 token_mask=jnp.asarray(mask))
        return (jnp.sum(y.astype(jnp.float32) * r) + aux["load_balance"]
                + aux["router_z"]), y
    (_, jy), jg = jax.value_and_grad(j_obj, argnums=(0, 1), has_aux=True)(
        jp, jnp.asarray(x))
    items = tree_items(p)
    leaves = [v.requires_grad_(True) for _, v in items]
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = moe.apply_moe(tree_from_items(
        (k, l) for (k, _), l in zip(items, leaves)), cfg,
        xt.to(torch.bfloat16), token_mask=torch.from_numpy(mask))
    obj = (torch.sum(y.float() * torch.from_numpy(r))
           + aux["load_balance"] + aux["router_z"])
    grads = torch.autograd.grad(obj, leaves + [xt])
    jy = np.asarray(jy.astype(jnp.float32))
    assert np.abs(y.float().detach().numpy() - jy).max() <= \
        2e-2 * np.abs(jy).max()
    want = jax.tree.leaves(jg[0]) + [jg[1]]
    assert _rel_l2(np.concatenate([g.numpy().ravel() for g in grads]),
                   np.concatenate([np.asarray(g).ravel() for g in want])) \
        <= 2e-2
