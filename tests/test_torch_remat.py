"""Activation rematerialization (``remat``) and the donation contract of
the port's train paths, against the reference on the CPU.

* (a) The reduced qwen of ``tests/test_torch_dryrun.py``: the port's
  ``CostMode`` count of the loss and its backward equals the reference's
  ``analyze_hlo`` dot FLOPs of ``jax.value_and_grad`` of its jitted loss,
  with ``remat`` (503,316,480: each layer's forward runs again in the
  backward, all but its last projection) and without (402,653,184).
* (b) Every kind, reduced (qwen: dense; mamba2: ssm; recurrentgemma: a
  hybrid group and a tail; llama4-scout: MoE in every layer;
  llama4-maverick: {dense_0, moe} groups; paligemma: vlm; whisper: the
  audio encoder's ``enc_layers``), float32: the port's loss and
  gradients with remat equal its own without remat bitwise, and the
  reference's ``value_and_grad`` of ``loss(remat=True)`` within loss rtol
  1e-5 and gradients 1e-5 relative L2 a leaf (the MoE files' bound; the
  dense and vlm/audio files hold 1e-4, the ssm file 1e-4 of max |g|).
  The MoE routers' choices of the forward, of the recompute in the
  backward and of the run without remat are identical, router call by
  router call (the checkpoint's own determinism check compares shapes
  only).
* (c) On fake tensors (full-width qwen, 4 layers, 2 x 1,024 tokens) the
  peak of loss and gradient with remat is below the peak without by at
  least the saved activations of all layers but one (a layer's tensors
  saved for the backward, less its input, which the checkpoint keeps).
* (d) ``ScaleTrainer`` remats its interval step by default and not its
  evaluation loss or gradient probe; one interval of the default step
  equals one of a step built with ``remat=False`` bitwise, per-leaf and
  fused; ``TrainerConfig(donate=False)`` leaves the tensors it was
  given unchanged and reaches the parameters of ``donate=True`` bitwise.
"""
import _torch_threads  # noqa: F401  (torch threads per xdist worker)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.launch.hlo_cost import analyze_hlo
from repro.models import build_model as j_build_model
from repro_torch.configs import get_arch
from repro_torch.core import distributed as dist
from repro_torch.launch.cost import measure
from repro_torch.models import build_model, moe, params_from_jax
from repro_torch.models import transformer as tfm
from repro_torch.models.common import (
    tree_from_items, tree_items, tree_leaves, tree_map)
from repro_torch.train import ScaleTrainer, TrainerConfig

SCOUT, MAVERICK = "llama4-scout-17b-a16e", "llama4-maverick-400b-a17b"
_SMALL = dict(d_model=64, d_ff=128, vocab_size=128)
# kind -> (arch, reduce() overrides, config overrides)
CASES = {
    "dense": ("qwen1.5-0.5b", {}, {}),
    "ssm": ("mamba2-370m", dict(_SMALL, num_layers=2), {}),
    # one (rec, rec, attn) group and a tail of two, the window below the
    # 16-token sequences
    "hybrid": ("recurrentgemma-9b", dict(_SMALL, num_layers=5),
               {"attention_window": 8}),
    "moe-layers": (SCOUT, dict(_SMALL, num_layers=2), {}),
    # two {dense_0, moe} groups and a dropped remainder
    "moe-groups": (MAVERICK, dict(_SMALL, num_layers=5), {}),
    "vlm": ("paligemma-3b", {}, {}),
    "audio": ("whisper-small", {}, {}),
}


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _cfgs(case):
    """(port cfg, reference cfg) of the reduced arch."""
    arch, red, over = CASES[case]
    return tuple(dataclasses.replace(get(arch).reduced(**red), **over)
                 for get in (get_arch, j_get_arch))


def _perturbed(jcfg, seed=0, scale=0.01):
    """The reference's init plus ``scale`` times a normal perturbation,
    so zero-initialized biases and norm scales carry gradients."""
    jp = jax.jit(j_build_model(jcfg).init)(jax.random.PRNGKey(seed))
    leaves, tdef = jax.tree.flatten(jp)
    keys = jax.random.split(jax.random.PRNGKey(seed + 1), len(leaves))
    return jax.tree.unflatten(tdef, [l + scale * jax.random.normal(k, l.shape)
                                     for l, k in zip(leaves, keys)])


def _batch(cfg, B=2, T=16, seed=0):
    """Tokens, labels and the kind's frontend embeddings (standard normal
    x 0.1, float32), as numpy arrays."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(B, T + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.kind in tfm.FRONTEND_KINDS:
        name = "patches" if cfg.kind == "vlm" else "frames"
        out[name] = rng.standard_normal((B, cfg.enc_seq_len, cfg.d_model),
                                        dtype=np.float32) * np.float32(0.1)
    return out


def _port_loss_and_grads(model, params, batch, remat):
    items = tree_items(params)
    leaves = [v.detach().requires_grad_(True) for _, v in items]
    loss = model.loss(tree_from_items((k, l) for (k, _), l in
                                      zip(items, leaves)),
                      {k: torch.from_numpy(v) for k, v in batch.items()},
                      dtype=torch.float32, remat=remat)
    return loss.detach(), torch.autograd.grad(loss, leaves)


def _route_spy(monkeypatch):
    """Record every router call's expert per token and its keep mask."""
    seen = []
    route = moe._route_local

    def spy(logits, token_mask, c, dt):
        out = route(logits, token_mask, c, dt)
        seen.append((out[2].argmax(-1).numpy().copy(),
                     out[3].numpy().copy()))
        return out

    monkeypatch.setattr(moe, "_route_local", spy)
    return seen


# ---------------------------------------------------------------------------
# (a) the count against the reference's HLO walk
# ---------------------------------------------------------------------------

def _reduced_qwen(get):
    """2 layers, d 128, 4 heads of qwen's 64 over 2 KV heads, d_ff 256,
    vocabulary 512 (``tests/test_torch_dryrun.py``'s)."""
    cfg = get("qwen1.5-0.5b").reduced(num_layers=2, d_model=128, d_ff=256,
                                      vocab_size=512)
    return dataclasses.replace(cfg, num_kv_heads=2, head_dim=64)


@pytest.mark.parametrize("remat,want", [(True, 503_316_480),
                                        (False, 402_653_184)])
def test_reduced_qwen_remat_flops_equal_the_reference_hlo_walk(remat, want):
    jcfg, cfg = _reduced_qwen(j_get_arch), _reduced_qwen(get_arch)
    jmodel, model = j_build_model(jcfg), build_model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0), jnp.float32)
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(0, cfg.vocab_size, size=(2, 64)).astype(
        np.int32) for k in ("tokens", "labels")}
    jfn = jax.value_and_grad(lambda p, b: jmodel.loss(
        p, b, dtype=jnp.float32, remat=remat))
    ref = analyze_hlo(jax.jit(jfn).lower(jparams, batch).compile()
                      .as_text()).flops
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    _, rec = measure(lambda p: _port_loss_and_grads(model, p, batch, remat),
                     params)
    assert rec.flops == ref == want


# ---------------------------------------------------------------------------
# (b) every kind: bitwise against no remat, held to the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_remat_loss_and_grads_bitwise_and_match_reference(case, monkeypatch):
    cfg, jcfg = _cfgs(case)
    jp = _perturbed(jcfg)
    batch = _batch(cfg)
    jloss, jgrad = jax.jit(jax.value_and_grad(
        lambda pp: j_build_model(jcfg).loss(
            pp, {k: jnp.asarray(v) for k, v in batch.items()},
            dtype=jnp.float32, remat=True)))(jp)
    model = build_model(cfg)
    params = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    seen = _route_spy(monkeypatch)
    loss0, g0 = _port_loss_and_grads(model, params, batch, remat=False)
    plain = list(seen)
    seen.clear()
    loss1, g1 = _port_loss_and_grads(model, params, batch, remat=True)
    assert torch.equal(loss0, loss1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    if cfg.kind == "moe":
        # the forward's calls, then the recompute's in the backward's
        # (reverse) order, each the plain run's routing
        n = len(plain)
        assert n == {SCOUT: 2, MAVERICK: 2}[CASES[case][0]]
        assert len(seen) == 2 * n
        for got, want in zip(seen[:n] + seen[n:][::-1], plain + plain):
            assert all(np.array_equal(a, b) for a, b in zip(got, want))
    else:
        assert not seen and not plain
    np.testing.assert_allclose(float(loss1), float(jloss), rtol=1e-5)
    want = [np.asarray(g) for g in jax.tree.leaves(jgrad)]
    assert len(want) == len(g1)
    for (path, _), a, b in zip(tree_items(params), g1, want):
        assert _rel_l2(a.numpy(), b) <= 1e-5, (path, _rel_l2(a.numpy(), b))


def test_remat_runs_only_where_a_gradient_is_recorded(monkeypatch):
    """No checkpoint under ``no_grad`` or for parameters that take no
    gradient (serving); one per unit where a gradient is recorded:
    hybrid: 1 group + 2 tail layers; audio: 2 encoder + 2 decoder
    layers."""
    calls = []
    ckpt = tfm.checkpoint

    def spy(*a, **kw):
        calls.append(1)
        return ckpt(*a, **kw)

    monkeypatch.setattr(tfm, "checkpoint", spy)
    for case, units in (("hybrid", 3), ("audio", 4)):
        cfg, _ = _cfgs(case)
        model = build_model(cfg)
        params = model.init(torch.Generator().manual_seed(0), "cpu")
        batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
        with torch.no_grad():
            model.loss(params, batch, dtype=torch.float32)
        model.loss(params, batch, dtype=torch.float32)
        assert not calls
        _port_loss_and_grads(model, params, _batch(cfg), remat=True)
        assert len(calls) == units, (case, len(calls))
        calls.clear()


# ---------------------------------------------------------------------------
# (c) the peak on fake tensors
# ---------------------------------------------------------------------------

def _fake_tree(fm, tree):
    with fm:
        return tree_map(lambda m: torch.empty(tuple(m.shape),
                                              dtype=m.dtype), tree)


def test_remat_peak_is_below_by_the_saved_activations():
    from torch._subclasses.fake_tensor import FakeTensorMode
    L, B, T = 4, 2, 1024
    cfg = dataclasses.replace(get_arch("qwen1.5-0.5b"), num_layers=L)
    model = build_model(cfg)
    fm = FakeTensorMode()
    params = _fake_tree(fm, model.abstract_params()[0])
    with fm:
        batch = {k: torch.zeros((B, T), dtype=torch.int32)
                 for k in ("tokens", "labels")}

    def loss_and_grads(p, b, remat):
        items = tree_items(p)
        leaves = [v.requires_grad_(True) for _, v in items]
        loss = model.loss(tree_from_items((k, l) for (k, _), l in
                                          zip(items, leaves)), b,
                          dtype=torch.float32, remat=remat)
        return torch.autograd.grad(loss, leaves)

    peaks = {}
    for remat in (False, True):
        with fm:
            _, rec = measure(lambda p, b: loss_and_grads(p, b, remat),
                             params, batch, fake_mode=fm)
        peaks[remat] = rec.peak_bytes
    # one layer's saved tensors, less its input and its weights' views
    layer = tree_map(lambda v: v[0], params["layers"])
    with fm:
        x = torch.empty((B, T, cfg.d_model), requires_grad=True)
    skip = {x.untyped_storage()._cdata} | {
        v.untyped_storage()._cdata for v in tree_leaves(params)}
    saved = {}

    def pack(t):
        key = t.untyped_storage()._cdata
        if key not in skip:
            saved[key] = t.untyped_storage().nbytes()
        return t

    with fm, torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        tfm.apply_dense_layer(
            tree_map(lambda v: v.requires_grad_(True), layer), cfg, x)
    per_layer = sum(saved.values())
    assert per_layer > 0
    assert peaks[False] - peaks[True] >= (L - 1) * per_layer, (
        peaks, per_layer)


# ---------------------------------------------------------------------------
# (d) the scale trainer: remat by default, donation
# ---------------------------------------------------------------------------

_KW = dict(num_layers=2, d_model=64, d_ff=128, vocab_size=128)


def _trainer(fused, **kw):
    sc = dist.TTHFScaleConfig(replicas=4, cluster_size=2, tau=4,
                              consensus_every=2, gamma_d2d=2, lr=0.05)
    tc = TrainerConfig(batch_per_replica=2, seq_len=16, intervals=1,
                       eval_every=1, eval_batches=1, prefetch=False,
                       fused_interval=fused, **kw)
    return ScaleTrainer(get_arch("qwen1.5-0.5b").reduced(**_KW), sc, tc,
                        device="cpu").init()


def _params(tr):
    p = tr.params
    return [p] if isinstance(p, torch.Tensor) else tree_leaves(p)


@pytest.mark.parametrize("fused", [False, True])
def test_scale_trainer_remats_its_step_only(fused, monkeypatch, tmp_path):
    seen = []
    loss_fn = tfm.loss_fn

    def spy(*a, remat=True, **kw):
        seen.append((torch.is_grad_enabled(), remat))
        return loss_fn(*a, remat=remat, **kw)

    monkeypatch.setattr(tfm, "loss_fn", spy)
    tr = _trainer(fused, trace_dir=str(tmp_path))
    tr.run()
    tr.close()
    monkeypatch.undo()
    # 4 microsteps x 4 replicas with remat; the evaluation (no grad)
    # and the gradient probe without
    assert seen[:16] == [(True, True)] * 16
    assert (False, False) in seen[16:] and (True, False) in seen[16:]
    assert all(not remat for _, remat in seen[16:])
    # the default step against one built without remat: bitwise
    ref = _trainer(fused)
    step, _ = dist.make_tthf_train_step(
        ref.model, ref.scale, dtype=ref.dtype, remat=False,
        fused_interval=fused, device="cpu")
    ref._step = step
    ref.run()
    assert all(torch.equal(a, b) for a, b in zip(_params(tr), _params(ref)))


@pytest.mark.parametrize("fused", [False, True])
def test_undonated_step_keeps_the_tensors_it_was_given(fused):
    done, kept = _trainer(fused), _trainer(fused, donate=False)
    given = {"donated": _params(done), "undonated": _params(kept)}
    copies = {k: [t.clone() for t in v] for k, v in given.items()}
    done.run()
    kept.run()
    assert all(torch.equal(a, b)
               for a, b in zip(given["undonated"], copies["undonated"]))
    # the donated step wrote its interval into the tensors it was given
    assert not all(torch.equal(a, b)
                   for a, b in zip(given["donated"], copies["donated"]))
    assert all(torch.equal(a, b)
               for a, b in zip(_params(done), _params(kept)))
