"""The port's ssm kind (Mamba-2 SSD) against ``repro.models.ssm`` and
``repro.kernels`` on the CPU: the ``ssd_scan`` kernel's plain version,
``ssd_chunked`` with and without an initial state, ``apply_ssm`` through
both scan paths, single-step decode, and the reduced mamba2's forward,
loss and gradient. Inputs are made with numpy; the reference's
parameters are carried across by ``params_from_jax``.

Tolerances, and why:
- the scan: max |Δy| / max |y| < 1e-4 and the final state to rtol/atol
  1e-4, the reference's own (``tests/test_kernels.py``), against the
  sequential oracle and the Pallas kernel in interpret mode;
- layer outputs and logits within 1e-5 (float32 products summed in
  another order on the two sides; observed below 1e-6);
- decode stepped against the full forward: the reference's rtol 1e-3,
  atol 1e-4 (``tests/test_ssm_rglru.py``), and each step within 1e-5 of
  the reference's decode;
- the float32 loss to rtol 1e-5 and every gradient leaf within 1e-4 of
  that leaf's max |gradient| (observed below 1e-5).
"""
import _torch_threads  # noqa: F401  (torch threads per xdist worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro.models import build_model as j_build_model
from repro.models import ssm as j_ssm
from repro.models.common import split_tree as j_split_tree

from repro_torch.configs import get_arch
from repro_torch.launch import train as train_cli
from repro_torch.models import build_model, params_from_jax
from repro_torch.models import ssm
from repro_torch.models.common import tree_items, tree_map
from repro_torch.kernels.ssd_scan import (
    ssd_scan, ssd_scan_heads, ssd_scan_plain)

ATOL = 1e-5

# tests/test_kernels.py::test_ssd_scan_shapes
SCAN_SHAPES = [(1, 64, 16, 16, 16), (2, 256, 64, 128, 128),
               (3, 512, 64, 128, 256),
               (2, 130, 32, 64, 64)]     # ragged T -> the padding path


def _scan_inputs(BH, T, P, S, seed=0, loga_scale=True):
    """The reference test's inputs (numpy, float32)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(BH, T, P)).astype(np.float32)
    dt = rng.uniform(0.001, 0.1, size=(BH, T)).astype(np.float32)
    a = rng.uniform(0.5, 2.0, size=(BH, 1)) if loga_scale else 1.0
    loga = (-dt * a).astype(np.float32)
    B = (rng.normal(size=(BH, T, S)) * 0.3).astype(np.float32)
    C = (rng.normal(size=(BH, T, S)) * 0.3).astype(np.float32)
    return x, dt, loga, B, C


def _rel(a, b) -> float:
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / (np.abs(np.asarray(b)).max() + 1e-6))


@pytest.mark.parametrize("BH,T,P,S,chunk", SCAN_SHAPES)
def test_ssd_scan_plain_matches_reference(BH, T, P, S, chunk):
    """ssd_scan_plain against the Pallas kernel in interpret mode (through
    ops.ssd_scan, which pads as the wrapper does) and the sequential
    oracle; the wrapper on CPU tensors is the plain version and counts no
    launch."""
    inputs = _scan_inputs(BH, T, P, S)
    yk, hk = j_ops.ssd_scan(*map(jnp.asarray, inputs), chunk=chunk)
    yr, hr = j_ref.ssd_scan_ref(*map(jnp.asarray, inputs))
    args = [torch.from_numpy(a) for a in inputs]
    y, h = ssd_scan_plain(*args, chunk=chunk)
    assert y.shape == (BH, T, P) and y.dtype == torch.float32
    assert h.shape == (BH, S, P) and h.dtype == torch.float32
    assert _rel(y, yr) < 1e-4 and _rel(y, yk) < 1e-4
    np.testing.assert_allclose(h.numpy(), np.asarray(hk), rtol=1e-4,
                               atol=1e-4)
    # zero padding freezes the state, so it is the oracle's at any T
    np.testing.assert_allclose(h.numpy(), np.asarray(hr), rtol=1e-4,
                               atol=1e-4)
    before = ssd_scan.launches
    yw, hw = ssd_scan(*args, chunk=chunk)
    assert ssd_scan.launches == before
    assert torch.equal(yw, y) and torch.equal(hw, h)


def test_ssd_scan_plain_state_carry_across_chunks():
    """Chunk 64 equals chunk 256 (tests/test_kernels.py's state-carry
    case), and bfloat16 inputs give y in bfloat16 within its rounding of
    the float32 scan."""
    inputs = [torch.from_numpy(a) for a in
              _scan_inputs(2, 256, 32, 64, seed=2, loga_scale=False)]
    y64, h64 = ssd_scan_plain(*inputs, chunk=64)
    y256, h256 = ssd_scan_plain(*inputs, chunk=256)
    np.testing.assert_allclose(y64.numpy(), y256.numpy(), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(h64.numpy(), h256.numpy(), rtol=1e-4,
                               atol=1e-4)
    x, dt, loga, B, C = inputs
    yb, hb = ssd_scan_plain(x.bfloat16(), dt, loga, B.bfloat16(),
                            C.bfloat16(), chunk=64)
    assert yb.dtype == torch.bfloat16 and hb.dtype == torch.float32
    # the float32 scan of the bf16-rounded inputs, rounded once
    yr, _ = ssd_scan_plain(x.bfloat16().float(), dt, loga,
                           B.bfloat16().float(), C.bfloat16().float(),
                           chunk=64)
    assert torch.equal(yb, yr.bfloat16())


@pytest.mark.parametrize("b,H,T,P,S,chunk", [(2, 3, 45, 8, 16, 16),
                                             (1, 4, 130, 32, 64, 64)])
def test_grouped_scan_matches_reference(b, H, T, P, S, chunk):
    """B and C once per batch element: ssd_scan(heads_per_group=H) on rows
    and ssd_scan_heads on the model's (b, T, H, P) layout against the
    reference's use_pallas branch (x, dt, loga folded into rows, B and C
    repeated per head, the Pallas kernel in interpret mode) and the
    sequential oracle; on the CPU both count no launch."""
    rng = np.random.default_rng(6)
    x = rng.normal(size=(b, T, H, P)).astype(np.float32)
    dt = rng.uniform(0.001, 0.1, size=(b, T, H)).astype(np.float32)
    loga = (-dt * rng.uniform(0.5, 2.0, size=(1, 1, H))).astype(np.float32)
    B = (rng.normal(size=(b, T, S)) * 0.3).astype(np.float32)
    C = (rng.normal(size=(b, T, S)) * 0.3).astype(np.float32)
    fold = lambda a: a.transpose(0, 2, 1, *range(3, a.ndim)).reshape(  # noqa
        b * H, T, *a.shape[3:])
    rep = lambda a: np.repeat(a, H, axis=0)  # noqa: E731
    rows = (fold(x), fold(dt), fold(loga), rep(B), rep(C))
    yk, hk = j_ops.ssd_scan(*map(jnp.asarray, rows), chunk=chunk)
    yr, hr = j_ref.ssd_scan_ref(*map(jnp.asarray, rows))
    before = ssd_scan.launches
    y, h = ssd_scan(*map(torch.from_numpy, rows[:3]), torch.from_numpy(B),
                    torch.from_numpy(C), chunk=chunk, heads_per_group=H)
    yh, hh = ssd_scan_heads(*map(torch.from_numpy, (x, dt, loga, B, C)),
                            chunk=chunk)
    assert ssd_scan.launches == before
    assert yh.shape == (b, T, H, P) and hh.shape == (b, H, S, P)
    y_heads = yh.numpy().transpose(0, 2, 1, 3).reshape(b * H, T, P)
    for yy, hhh in ((y.numpy(), h.numpy()),
                    (y_heads, hh.numpy().reshape(b * H, S, P))):
        assert _rel(yy, yk) < 1e-4 and _rel(yy, yr) < 1e-4
        np.testing.assert_allclose(hhh, np.asarray(hk), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(hhh, np.asarray(hr), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_chunked_matches_reference(with_h0):
    """The port's ssd_chunked (b, T, H, P layout, B/C shared by the
    heads) against the reference's, with and without an initial state,
    across a ragged last chunk; and against the sequential oracle."""
    rng = np.random.default_rng(1)
    b, T, H, P, S, chunk = 2, 45, 3, 8, 16, 16
    x = rng.normal(size=(b, T, H, P)).astype(np.float32)
    dt = rng.uniform(0.01, 0.1, size=(b, T, H)).astype(np.float32)
    loga = (-dt * rng.uniform(0.5, 2.0, size=(1, 1, H))).astype(np.float32)
    B = (rng.normal(size=(b, T, S)) * 0.3).astype(np.float32)
    C = (rng.normal(size=(b, T, S)) * 0.3).astype(np.float32)
    h0 = (rng.normal(size=(b, H, S, P)).astype(np.float32)
          if with_h0 else None)
    jy, jh = j_ssm.ssd_chunked(*map(jnp.asarray, (x, dt, loga, B, C)),
                               h0=None if h0 is None else jnp.asarray(h0),
                               chunk=chunk)
    y, h = ssm.ssd_chunked(*map(torch.from_numpy, (x, dt, loga, B, C)),
                           h0=None if h0 is None else torch.from_numpy(h0),
                           chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=ATOL, rtol=0)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=ATOL, rtol=0)
    # the sequential oracle, heads folded into rows
    fold = lambda a: a.transpose(0, 2, 1, *range(3, a.ndim)).reshape(  # noqa
        b * H, T, *a.shape[3:])
    rep = lambda a: np.broadcast_to(a[:, None], (b, H, T, S)).reshape(  # noqa
        b * H, T, S)
    yr, hr = j_ref.ssd_scan_ref(
        jnp.asarray(fold(x)), jnp.asarray(fold(dt)), jnp.asarray(fold(loga)),
        jnp.asarray(rep(B)), jnp.asarray(rep(C)),
        h0=None if h0 is None else jnp.asarray(h0.reshape(b * H, S, P)))
    yr = np.asarray(yr).reshape(b, H, T, P).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(y.numpy(), yr, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(h.numpy().reshape(b * H, S, P),
                               np.asarray(hr), rtol=1e-4, atol=1e-4)


def _tiny_cfgs(**kw):
    over = dict(num_layers=2, d_model=64, d_ff=128, vocab_size=128)
    over.update(kw)
    return (get_arch("mamba2-370m").reduced(**over),
            j_get_arch("mamba2-370m").reduced(**over))


def _layer_params(seed=0):
    cfg, jcfg = _tiny_cfgs()
    jp, _ = j_split_tree(j_ssm.init_ssm(jax.random.PRNGKey(seed), jcfg))
    return cfg, jcfg, params_from_jax(jax.tree.map(np.asarray, jp),
                                      "cpu"), jp


@pytest.mark.parametrize("use_kernel", [False, True])
def test_apply_ssm_matches_reference(use_kernel):
    """apply_ssm through ssd_chunked, or through the ssd_scan wrapper
    (its plain version on the CPU), against the reference's apply_ssm
    with use_pallas the same (the Pallas kernel in interpret mode), over
    a ragged last chunk."""
    cfg, jcfg, p, jp = _layer_params()
    x = (np.random.default_rng(4).normal(size=(2, 45, cfg.d_model))
         * 0.3).astype(np.float32)
    ref = j_ssm.apply_ssm(jp, jcfg, jnp.asarray(x), use_pallas=use_kernel)
    with torch.no_grad():
        out = ssm.apply_ssm(p, cfg, torch.from_numpy(x),
                            use_kernel=use_kernel)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)


def test_decode_ssm_matches_full_forward():
    """decode_ssm stepped token by token equals the full-sequence
    apply_ssm (tests/test_ssm_rglru.py), and each step equals the
    reference's decode_ssm, caches included."""
    cfg, jcfg, p, jp = _layer_params()
    B, T = 2, 12
    x = (np.random.default_rng(1).normal(size=(B, T, cfg.d_model))
         * 0.3).astype(np.float32)
    xt = torch.from_numpy(x)
    full = ssm.apply_ssm(p, cfg, xt)
    cache = ssm.init_ssm_cache(cfg, B, torch.float32, device="cpu")
    jcache = j_ssm.init_ssm_cache(jcfg, B, jnp.float32)
    outs = []
    for t in range(T):
        y, cache = ssm.decode_ssm(p, cfg, xt[:, t:t + 1], cache)
        jy, jcache = j_ssm.decode_ssm(jp, jcfg, jnp.asarray(x[:, t:t + 1]),
                                      jcache)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=ATOL,
                                   rtol=0)
        outs.append(y)
    for name, leaf in cache.items():
        np.testing.assert_allclose(leaf.numpy(), np.asarray(jcache[name]),
                                   atol=ATOL, rtol=0)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                               rtol=1e-3, atol=1e-4)


def _model_pair():
    cfg, jcfg = _tiny_cfgs()
    jm = j_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    return cfg, jcfg, build_model(cfg), jm, params_from_jax(
        jax.tree.map(np.asarray, jp), "cpu"), jp


def test_model_params_match_reference_tree():
    """The full-size mamba2-370m's parameter tree: the reference's leaves,
    axes and shapes (368,285,184 parameters), made on the meta device."""
    cfg = get_arch("mamba2-370m")
    params, axes = build_model(cfg).abstract_params()
    jparams, jaxes = j_build_model(j_get_arch("mamba2-370m")).abstract_params()
    assert [(path, tuple(v.shape)) for path, v in tree_items(params)] == \
        [(path, tuple(v.shape)) for path, v in tree_items(jparams)]
    assert tree_items(axes) == tree_items(jaxes)
    assert sum(v.numel() for _, v in tree_items(params)) == 368_285_184


def test_loss_and_gradient_match_reference():
    """The reduced mamba2's float32 loss and its gradient through
    ssd_chunked against jax.value_and_grad, over a sequence with a
    ragged last chunk."""
    cfg, jcfg, m, jm, p, jp = _model_pair()
    rng = np.random.default_rng(3)
    toks, labels = (rng.integers(1, cfg.vocab_size, size=(2, 40))
                    .astype(np.int32) for _ in range(2))
    jl, jg = jax.value_and_grad(lambda q: jm.loss(
        q, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)},
        dtype=jnp.float32))(jp)
    pg = tree_map(lambda t: t.clone().requires_grad_(), p)
    loss = m.loss(pg, {"tokens": torch.from_numpy(toks),
                       "labels": torch.from_numpy(labels)},
                  dtype=torch.float32)
    items = tree_items(pg)
    grads = torch.autograd.grad(loss, [v for _, v in items])
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    jitems = tree_items(jax.tree.map(np.asarray, jg))
    assert [path for path, _ in items] == [path for path, _ in jitems]
    for (path, ref), g in zip(jitems, grads):
        err = float(np.abs(g.numpy() - ref).max())
        assert err <= 1e-4 * float(np.abs(ref).max()), (path, err)


def test_forward_through_the_kernel_matches_reference():
    """ModelApi.forward(use_kernel=True) against the reference's
    forward(use_pallas=True), and against the port's plain forward."""
    cfg, jcfg, m, jm, p, jp = _model_pair()
    toks = np.random.default_rng(5).integers(
        1, cfg.vocab_size, size=(2, 70)).astype(np.int32)
    jl, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)}, dtype=jnp.float32,
                       use_pallas=True)
    with torch.no_grad():
        lk, _ = m.forward(p, {"tokens": torch.from_numpy(toks)},
                          dtype=torch.float32, use_kernel=True)
        lp, _ = m.forward(p, {"tokens": torch.from_numpy(toks)},
                          dtype=torch.float32)
    np.testing.assert_allclose(lk.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    np.testing.assert_allclose(lk.numpy(), lp.numpy(), atol=ATOL, rtol=0)


def test_ssd_scan_refuses_a_gradient():
    """The kernel is forward only, as the TPU kernel: asking the wrapper
    for a gradient raises, the model's kernel path too; under no_grad it
    runs, and the default path has a gradient."""
    x, dt, loga, B, C = (torch.from_numpy(a) for a in
                         _scan_inputs(1, 32, 16, 16))
    with pytest.raises(RuntimeError, match="forward only"):
        ssd_scan(x.requires_grad_(), dt, loga, B, C, chunk=16)
    with torch.no_grad():
        ssd_scan(x, dt, loga, B, C, chunk=16)
    cfg, _, p, _ = _layer_params()
    pg = tree_map(lambda t: t.clone().requires_grad_(), p)
    h = torch.zeros((1, 8, cfg.d_model))
    with pytest.raises(RuntimeError, match="forward only"):
        ssm.apply_ssm(pg, cfg, h, use_kernel=True)
    ssm.apply_ssm(pg, cfg, h).sum().backward()
    assert pg["w_in"].grad is not None
    with pytest.raises(ValueError, match="zero state"):
        ssm.ssm_sequence(p, cfg, h, h0=torch.zeros(
            (1, cfg.ssm_num_heads, cfg.ssm_state_dim, cfg.ssm_head_dim)),
            use_kernel=True)


def test_scale_mode_still_refuses_the_ssm_kind():
    """Kept under its old name: scale mode now runs the ssm kind (held to
    the reference in tests/test_torch_scale.py), the hybrid kind
    (tests/test_torch_scale_hybrid.py) and the moe kind
    (tests/test_torch_scale_moe.py; a reduced llama4-scout runs here);
    the vlm and audio kinds, once refused where the model was built
    (item 6c), are ported: their parameter trees build (held to the
    reference's in tests/test_torch_vlm_audio.py), and scale mode refuses
    them at the trainer."""
    for arch in ("mamba2-370m", "llama4-scout-17b-a16e"):
        assert train_cli.main(["--mode", "scale", "--arch", arch,
                               "--reduced", "--steps", "1", "--tau", "1",
                               "--batch", "1", "--seq", "8",
                               "--device", "cpu"]) == 0
    for arch in ("paligemma-3b", "whisper-small"):
        cfg = get_arch(arch).reduced()
        shapes, axes = build_model(cfg).abstract_params()
        assert shapes["embed"].shape == (cfg.padded_vocab, cfg.d_model)
        assert ("enc_layers" in shapes) == (cfg.kind == "audio")
