"""Scale-mode TT-HF of the port against ``repro.core.distributed`` and
``repro.train`` on the CPU: the same numpy-made tokens, the reference's
parameters carried across by ``params_from_jax``, and the reference's
per-interval picks replayed through the port's draw source.

The step configuration is ``tests/test_fused_interval.py``'s: a 2-layer
qwen cut to d 64 (its leaves are not lane-aligned), R 4 in clusters of
2, tau 4, consensus every 2, Γ 2, lr 0.05. The helpers take ``arch``:
``tests/test_torch_scale_ssm.py`` runs the same steps on a reduced
mamba2, ``tests/test_torch_scale_hybrid.py`` on a reduced
recurrentgemma.

Tolerances, and why:
- token streams, flat-buffer offsets and padding, round-trips and the
  ledger: exact (numpy, integer layout and host bookkeeping);
- the per-leaf steps and the fused interval over 2 intervals: loss
  rtol 1e-4, parameters atol 1e-5 (float32 products summed in another
  order on the two sides);
- the fused interval's kernel block-end (here the kernel's plain
  version) against the reference's ``fused_kernel=True`` path in
  interpret mode, 1 interval: atol 1e-6, the reference's own bound
  (``tests/test_fused_interval.py:158``);
- the two plain kernels against ``repro.kernels.ops`` (interpret):
  1e-6 in float32 and 1e-2 in bfloat16, ``tests/test_kernels.py``'s.
"""
import _torch_threads  # noqa: F401  (torch threads per xdist worker)
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.configs.base import HierarchyConfig
from repro.core import sampling as j_smp
from repro.core import distributed as j_dist
from repro.core.topology import geometric_adjacency, metropolis_weights
from repro.data.tokens import synthetic_token_batches as j_tokens
from repro.kernels import ops as j_ops
from repro.launch import train as j_train_cli
from repro.models import build_model as j_build_model
from repro.train import ScaleTrainer as JScaleTrainer
from repro.train import TrainerConfig as JTrainerConfig

from repro_torch.configs import get_arch
from repro_torch.core import distributed as dist
from repro_torch.data.tokens import synthetic_token_batches
from repro_torch.kernels.fused_consensus_sgd import fused_consensus_sgd_plain
from repro_torch.kernels.fused_sgd import fused_sgd_plain
from repro_torch.launch import train as train_cli
from repro_torch.models import build_model, params_from_jax
from repro_torch.models.common import tree_leaves
from repro_torch.rounds import RoundProgram, RoundResolver
from repro_torch.train import PrefetchLoader, ScaleTrainer, TrainerConfig

_KW = dict(num_layers=2, d_model=64, d_ff=128, vocab_size=128)
ARCH_HYBRID = "recurrentgemma-9b"
_JCFG = j_get_arch("qwen1.5-0.5b").reduced(**_KW)
_CFG = get_arch("qwen1.5-0.5b").reduced(**_KW)
_ARCHS = {"qwen": (_JCFG, _CFG),
          "mamba2": (j_get_arch("mamba2-370m").reduced(**_KW),
                     get_arch("mamba2-370m").reduced(**_KW)),
          # one (rec, rec, attn) group and a tail of two, the window
          # below the 16-token sequences
          "hybrid": tuple(dataclasses.replace(
              get(ARCH_HYBRID).reduced(**dict(_KW, num_layers=5)),
              attention_window=8) for get in (j_get_arch, get_arch))}
_R, _TAU = 4, 4


def _scale(cls, **kw):
    for k, v in dict(replicas=_R, cluster_size=2, tau=_TAU,
                     consensus_every=2, gamma_d2d=2, lr=0.05).items():
        kw.setdefault(k, v)
    return cls(**kw)


def _batches(seed=1, T=16):
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(seed),
                                         (_TAU, _R, 2, T), 0,
                                         _CFG.vocab_size))
    return ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)},
            {"tokens": torch.from_numpy(toks.copy()),
             "labels": torch.from_numpy(toks.copy())})


def _w0(seed=0, arch="qwen"):
    return j_build_model(_ARCHS[arch][0]).init(jax.random.PRNGKey(seed))


def _carried(w0):
    return params_from_jax(jax.tree.map(np.asarray, w0), "cpu")


def _max_err(port_leaves, ref_leaves):
    return max(float(np.max(np.abs(a.numpy() - np.asarray(b))))
               for a, b in zip(port_leaves, ref_leaves))


class JaxScaleDraws:
    """Draw source replaying the reference trainer's key schedule: the
    key starts at ``PRNGKey(seed)``, every interval splits it into
    (key, kp), and the interval's picks are ``sample_devices(kp, N, s)``."""

    def __init__(self, seed):
        self.key = jax.random.PRNGKey(seed)

    def picks(self, num_clusters, cluster_size, k):
        self.key, kp = jax.random.split(self.key)
        return torch.from_numpy(np.array(
            j_smp.sample_devices_multi(kp, num_clusters, cluster_size, k)
            if k > 1 else
            j_smp.sample_devices(kp, num_clusters, cluster_size))).long()


# ---------------------------------------------------------------------------
# token streams
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,shard", [(0, 0), (3, 1), (10_000, 99)])
def test_token_stream_equals_reference_and_seeks(seed, shard):
    ref = j_tokens(2, 16, 128, seed=seed, shard_id=shard)
    got = synthetic_token_batches(2, 16, 128, seed=seed, shard_id=shard)
    want = [next(ref) for _ in range(6)]
    for w in want:
        g = next(got)
        for k in ("tokens", "labels"):
            assert g[k].dtype == np.int32
            np.testing.assert_array_equal(g[k], w[k])
    for start in (1, 4):
        seeked = next(synthetic_token_batches(2, 16, 128, seed=seed,
                                              shard_id=shard, start=start))
        np.testing.assert_array_equal(seeked["tokens"],
                                      want[start]["tokens"])


# ---------------------------------------------------------------------------
# FlatParamSpec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg_pair", ["d64", "qwen-full"])
def test_flat_spec_layout_equals_reference(cfg_pair):
    jcfg, cfg = ((_JCFG, _CFG) if cfg_pair == "d64" else
                 (j_get_arch("qwen1.5-0.5b"), get_arch("qwen1.5-0.5b")))
    ref = j_dist.FlatParamSpec.for_model(j_build_model(jcfg))
    spec = dist.FlatParamSpec.for_model(build_model(cfg))
    assert spec.shapes == ref.shapes and spec.sizes == ref.sizes
    assert spec.offsets == ref.offsets
    assert (spec.total, spec.padded) == (ref.total, ref.padded)
    assert spec.padded % dist.LANE == 0 and spec.dtype == torch.float32
    if cfg_pair == "qwen-full":
        assert spec.total == spec.padded == 464_118_784
    else:
        assert spec.padded > spec.total          # not lane-aligned


def test_flat_spec_roundtrip_views_and_padding():
    spec = dist.FlatParamSpec.for_model(build_model(_CFG))
    w0 = _w0()
    params = dist.stack_replicas(_carried(w0), _R)
    flat = spec.flatten(params)
    ref = j_dist.FlatParamSpec.for_model(j_build_model(_JCFG)).flatten(
        j_dist.stack_replicas(w0, _R))
    assert np.array_equal(flat.numpy(), np.asarray(ref))
    assert flat.shape == (_R, spec.padded)
    assert not flat[:, spec.total:].any()
    for a, b in zip(tree_leaves(spec.unflatten(flat)), tree_leaves(params)):
        assert torch.equal(a, b)
        assert a.untyped_storage().data_ptr() == \
            flat.untyped_storage().data_ptr()
    for a, b in zip(tree_leaves(spec.unflatten_one(flat[2])),
                    tree_leaves(params)):
        assert torch.equal(a, b[2])
    with pytest.raises(TypeError, match="uniform param dtype"):
        dist.FlatParamSpec.for_tree(
            {"a": torch.zeros(3), "b": torch.zeros(3, dtype=torch.bfloat16)})


# ---------------------------------------------------------------------------
# aggregations
# ---------------------------------------------------------------------------

def test_aggregations_equal_reference():
    net = _scale(dist.TTHFScaleConfig).network()
    jnet = _scale(j_dist.TTHFScaleConfig).network()
    assert np.array_equal(np.asarray(net.varrho), np.asarray(jnet.varrho))
    rng = np.random.default_rng(0)
    tree = {"a": rng.normal(size=(_R, 3, 5)).astype(np.float32),
            "b": {"c": rng.normal(size=(_R, 7)).astype(np.float32)}}
    picks = np.array([1, 0], np.int32)
    ttree = params_from_jax(tree, "cpu")
    jtree = jax.tree.map(jnp.asarray, tree)
    for got, want in [
            (dist.sampled_aggregation(ttree, net, torch.from_numpy(picks)),
             j_dist.sampled_aggregation(jtree, jnet, jnp.asarray(picks))),
            (dist.full_aggregation(ttree, net),
             j_dist.full_aggregation(jtree, jnet))]:
        for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)
            assert a.is_contiguous()
    flat = np.concatenate([tree["a"].reshape(_R, -1), tree["b"]["c"]], 1)
    for got, want in [
            (dist.sampled_aggregation_flat(torch.from_numpy(flat), net,
                                           torch.from_numpy(picks)),
             j_dist.sampled_aggregation_flat(jnp.asarray(flat), jnet,
                                             jnp.asarray(picks))),
            (dist.full_aggregation_flat(torch.from_numpy(flat), net),
             j_dist.full_aggregation_flat(jnp.asarray(flat), jnet))]:
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# the interval step
# ---------------------------------------------------------------------------

_REF_RUNS = {}


def _reference_run(sync, mode, fused_interval=False, fused_kernel=None,
                   intervals=2, arch="qwen"):
    """The reference step over ``intervals`` intervals, cached."""
    key = (sync, mode, fused_interval, fused_kernel, intervals, arch)
    if key not in _REF_RUNS:
        jm = j_build_model(_ARCHS[arch][0])
        step, _ = j_dist.make_tthf_train_step(
            jm, _scale(j_dist.TTHFScaleConfig, consensus_mode=mode),
            dtype=jnp.float32, sync=sync, fused_interval=fused_interval,
            fused_kernel=fused_kernel)
        params = j_dist.stack_replicas(_w0(arch=arch), _R)
        if fused_interval:
            params = step.spec.flatten(params)
        jbatch, _ = _batches()
        jstep = jax.jit(step)
        losses = []
        for i in range(intervals):
            params, loss = jstep(params, jbatch,
                                 jnp.asarray([1, 0], jnp.int32),
                                 jnp.asarray(i))
            losses.append(float(loss))
        if fused_interval:
            params = step.spec.unflatten(params)
        _REF_RUNS[key] = (jax.tree.leaves(params), losses)
    return _REF_RUNS[key]


def _port_run(sync, mode, fused_interval=False, fused_kernel=None,
              intervals=2, arch="qwen"):
    step, _ = dist.make_tthf_train_step(
        build_model(_ARCHS[arch][1]),
        _scale(dist.TTHFScaleConfig, consensus_mode=mode),
        dtype=torch.float32, sync=sync, fused_interval=fused_interval,
        fused_kernel=fused_kernel, device="cpu")
    params = dist.stack_replicas(_carried(_w0(arch=arch)), _R)
    if fused_interval:
        params = step.spec.flatten(params)
    _, tbatch = _batches()
    losses = []
    for i in range(intervals):
        params, loss = step(params, tbatch, torch.tensor([1, 0]), i)
        losses.append(float(loss))
    if fused_interval:
        assert not params[:, step.spec.total:].any()   # pad stays zero
        params = step.spec.unflatten(params)
    return tree_leaves(params), losses


@pytest.mark.parametrize("mode", ["fused", "rounds"])
@pytest.mark.parametrize("sync", ["tthf", "star", "local"])
def test_per_leaf_step_matches_reference(sync, mode):
    ref_leaves, ref_losses = _reference_run(sync, mode)
    leaves, losses = _port_run(sync, mode)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)
    assert _max_err(leaves, ref_leaves) <= 1e-5


@pytest.mark.parametrize("mode", ["fused", "rounds"])
@pytest.mark.parametrize("sync", ["tthf", "star", "local"])
def test_fused_interval_matches_reference_per_leaf_step(sync, mode):
    """The port's flat carrier (kernel block-end on the CPU = the
    kernel's plain version) against the reference's per-leaf step."""
    ref_leaves, ref_losses = _reference_run(sync, mode)
    leaves, losses = _port_run(sync, mode, fused_interval=True)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)
    assert _max_err(leaves, ref_leaves) <= 1e-5


def test_fused_interval_einsum_block_end_matches_reference():
    """``fused_kernel=False``: the whole-buffer einsum block-end."""
    ref_leaves, ref_losses = _reference_run("tthf", "fused",
                                            fused_interval=True)
    leaves, losses = _port_run("tthf", "fused", fused_interval=True,
                               fused_kernel=False)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)
    assert _max_err(leaves, ref_leaves) <= 1e-5


def test_fused_interval_kernel_path_matches_reference_kernel_path():
    """The reference's ``fused_kernel=True`` (Pallas, interpret mode)
    against the port's kernel block-end (its plain version on the CPU):
    the reference's own bound, test_fused_interval.py:158."""
    ref_leaves, ref_losses = _reference_run(
        "tthf", "fused", fused_interval=True, fused_kernel=True, intervals=1)
    leaves, losses = _port_run("tthf", "fused", fused_interval=True,
                               intervals=1)
    assert _max_err(leaves, ref_leaves) <= 1e-6
    assert abs(losses[0] - ref_losses[0]) < 1e-6


def test_unported_aggregation_forms_raise():
    # the weights and matrix forms are ported (tests/test_torch_scale_
    # forms.py); the step raises what the reference asserts against
    m = build_model(_CFG)
    h = HierarchyConfig(levels=3, taus=(_TAU, 2 * _TAU), sample=(1, 0))
    with pytest.raises(ValueError, match="fan-in"):
        dist.make_tthf_train_step(
            m, _scale(dist.TTHFScaleConfig, sample_per_cluster=2),
            hierarchy=h, device="cpu")
    with pytest.raises(ValueError, match="tier-1 period"):
        dist.make_tthf_train_step(m, _scale(dist.TTHFScaleConfig, tau=2,
                                            consensus_every=2),
                                  hierarchy=h, device="cpu")
    with pytest.raises(ValueError, match="implies tthf"):
        dist.make_tthf_train_step(m, _scale(dist.TTHFScaleConfig),
                                  hierarchy=h, sync="star", device="cpu")
    with pytest.raises(ValueError, match="divide"):
        dist.make_tthf_train_step(
            m, _scale(dist.TTHFScaleConfig, consensus_every=3), device="cpu")


# ---------------------------------------------------------------------------
# the fused kernels' plain versions against the reference kernels
# ---------------------------------------------------------------------------

def _V(N, s, seed=0):
    rng = np.random.default_rng(seed)
    return np.stack([metropolis_weights(geometric_adjacency(s, 0.9, rng))
                     for _ in range(N)]).astype(np.float32)


@pytest.mark.parametrize("shape", [(8,), (127,), (129,), (1000, 37),
                                   (3, 5, 7, 11)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("wd", [0.0, 0.1])
def test_fused_sgd_plain_matches_reference_kernel(shape, dtype, wd):
    rng = np.random.default_rng(0)
    w, g = rng.normal(size=shape), rng.normal(size=shape)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = j_ops.fused_sgd(jnp.asarray(w, jdt), jnp.asarray(g, jdt), 0.01,
                           weight_decay=wd)
    got = fused_sgd_plain(torch.tensor(w, dtype=tdt),
                          torch.tensor(g, dtype=tdt), 0.01, weight_decay=wd)
    assert got.dtype == tdt and tuple(got.shape) == shape
    tol = 1e-6 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol)


@pytest.mark.parametrize("N,s,M", [(2, 4, 64), (4, 2, 937), (1, 8, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("wd", [0.0, 0.1])
def test_fused_consensus_sgd_plain_matches_reference_kernel(N, s, M, dtype,
                                                            wd):
    rng = np.random.default_rng(3)
    w, g = rng.normal(size=(N, s, M)), rng.normal(size=(N, s, M))
    V = _V(N, s)
    W = np.stack([np.linalg.matrix_power(V[c].astype(np.float64), 2)
                  for c in range(N)]).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = j_ops.fused_consensus_sgd(jnp.asarray(w, jdt), jnp.asarray(g, jdt),
                                     jnp.asarray(W), 0.01, weight_decay=wd)
    got = fused_consensus_sgd_plain(
        torch.tensor(w, dtype=tdt), torch.tensor(g, dtype=tdt),
        torch.from_numpy(W), 0.01, weight_decay=wd)
    assert got.dtype == tdt and tuple(got.shape) == (N, s, M)
    tol = 1e-6 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


# ---------------------------------------------------------------------------
# the resolver, the trainer and the CLI
# ---------------------------------------------------------------------------

def test_resolver_bills_the_static_interval():
    scale = _scale(dist.TTHFScaleConfig)
    net = scale.network()
    res = RoundResolver.for_scale(net, scale, RoundProgram())
    ev = res.resolve_interval(0, JaxScaleDraws(0))
    kp = jax.random.split(jax.random.PRNGKey(0))[1]
    assert ev.agg.tolist() == np.asarray(
        j_smp.sample_devices(kp, 2, 2)).tolist()
    b = ev.billing
    assert b.local_devices == _R * _TAU and b.consensus_repeats == 2
    assert b.uplinks_by_level == {1: 2}
    assert b.consensus_gammas.tolist() == [2, 2]
    # two picks per cluster: the (N, s) weights form, N * k uplinks
    ev = RoundResolver.for_scale(
        net, _scale(dist.TTHFScaleConfig, sample_per_cluster=2),
        RoundProgram()).resolve_interval(0, JaxScaleDraws(0))
    assert ev.agg.shape == (2, 2) and ev.billing.uplinks_by_level == {1: 4}


def _trainers(fused_interval, arch="qwen", **kw):
    tk = dict(batch_per_replica=2, seq_len=16, intervals=3, eval_every=3,
              eval_batches=1, **kw)
    jcfg, cfg = _ARCHS[arch]
    jt = JScaleTrainer(jcfg, _scale(j_dist.TTHFScaleConfig),
                       JTrainerConfig(fused_interval=fused_interval, **tk))
    pt = ScaleTrainer(cfg, _scale(dist.TTHFScaleConfig),
                      TrainerConfig(fused_interval=fused_interval, **tk),
                      device="cpu")
    return jt, pt


def _ledger(tr):
    led = tr.ledger
    return (led.uplinks, led.broadcasts, led.d2d_msgs, led.d2d_rounds,
            led.local_steps, dict(led.uplinks_by_level))


def _losses(capsys):
    return [float(x) for x in re.findall(r"train_loss=(\S+)",
                                         capsys.readouterr().out)]


@pytest.mark.parametrize("fused_interval", [False, True])
def test_scale_trainer_matches_reference(fused_interval, capsys):
    _check_scale_trainer(fused_interval, capsys, "qwen")


def _check_scale_trainer(fused_interval, capsys, arch):
    jt, pt = _trainers(fused_interval, arch=arch)
    jt.init().run()
    ref_losses = _losses(capsys)
    pt.init(w0=_carried(jt.model.init(jax.random.PRNGKey(0))),
            draws=JaxScaleDraws(0)).run()
    losses = _losses(capsys)
    assert len(losses) == len(ref_losses) == 3
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)
    assert _ledger(pt) == _ledger(jt)
    assert pt.interval == jt.interval == 3
    assert pt._train_draws == jt._train_draws
    assert pt._eval_draws == jt._eval_draws == 1
    ref = jax.tree.leaves(jt._replica0())
    got = tree_leaves(pt._global_params())
    assert _max_err(got, ref) <= 1e-5
    assert sum(l.numel() for l in got) == \
        sum(int(np.prod(l.shape)) for l in ref)
    np.testing.assert_allclose(pt.evaluate(), jt.evaluate(), rtol=1e-4)


def test_prefetched_run_matches_synchronous():
    _, a = _trainers(True, prefetch=False)
    _, b = _trainers(True, prefetch=True)
    a.init().run()
    b.init().run()
    assert torch.equal(a.params, b.params)
    assert a._train_draws == b._train_draws
    assert _ledger(a) == _ledger(b)


def test_prefetch_loader_preserves_order_and_end():
    src = iter(range(7))
    with PrefetchLoader(lambda: next(src), depth=2) as loader:
        assert [loader.get() for _ in range(7)] == list(range(7))
        with pytest.raises(StopIteration):
            loader.get()


def test_prefetch_loader_surfaces_worker_error():
    def boom():
        raise ValueError("bad batch")
    loader = PrefetchLoader(boom)
    with pytest.raises(ValueError, match="bad batch"):
        loader.get()
    loader.close()


def test_trainer_refuses_unported_options():
    # checkpoints and the observability sink are ported
    # (tests/test_torch_ckpt.py, tests/test_torch_obs.py); a kind fed a
    # frontend is refused (the interval batch holds tokens only, and the
    # reference's trainer fails on whisper's frames). donate=False is
    # ported too: the step works on a copy, and the tensors the trainer
    # held before the interval keep their values (tests/test_torch_remat.py
    # holds it to donate=True)
    sc = _scale(dist.TTHFScaleConfig)
    with pytest.raises(ValueError, match="token batches only"):
        ScaleTrainer(get_arch("whisper-small").reduced(**_KW), sc,
                     TrainerConfig(), device="cpu")
    with pytest.raises(ValueError, match="unknown dtype"):
        TrainerConfig(dtype="float16")
    tr = ScaleTrainer(_CFG, sc, TrainerConfig(
        batch_per_replica=2, seq_len=16, eval_every=0, prefetch=False,
        donate=False), device="cpu").init()
    given = tree_leaves(tr.params)
    before = [t.clone() for t in given]
    tr.run(1)
    assert all(torch.equal(a, b) for a, b in zip(given, before))
    assert not all(torch.equal(a, b)
                   for a, b in zip(tree_leaves(tr.params), before))


def test_scale_cli_summary_line_matches_reference(capsys):
    argv = ["--mode", "scale", "--arch", "qwen1.5-0.5b", "--reduced",
            "--steps", "2", "--tau", "4", "--consensus-every", "3",
            "--batch", "2", "--seq", "16"]
    assert j_train_cli.main(argv) == 0
    ref = capsys.readouterr().out.strip().splitlines()
    assert train_cli.main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out.strip().splitlines()
    pattern = (r"intervals=2 wall=\S+s (uplinks=\d+ L1=\d+ d2d_msgs=\d+ "
               r"\(tau=4 local steps per interval, sync=tthf\))")
    m_ref, m_got = re.fullmatch(pattern, ref[-1]), re.fullmatch(pattern,
                                                                got[-1])
    assert m_ref and m_got, (ref[-1], got[-1])
    assert m_got.group(1) == m_ref.group(1)
    # consensus every 3 snaps to 2 (a divisor of tau): 2 intervals x 2
    # events x Γ 2 rounds x 2 messages per edge x 2 edges (one per ring
    # cluster of 2)
    assert "d2d_msgs=32 " in got[-1]
    # the per-interval metric lines: same steps, uplinks and messages
    def counts(lines):
        return [re.sub(r"^\[\s*\S+s\] |train_loss=\S+ ", "", l)
                for l in lines]
    assert counts(got[:-1]) == counts(ref[:-1])
    assert len(got) == 3
