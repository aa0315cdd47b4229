"""Scale-mode TT-HF of the port for the moe kind (llama4-scout: an MoE FFN
in every layer; llama4-maverick: ``groups`` of ``{dense_0, moe}``),
against ``repro.train.ScaleTrainer`` on the CPU, with the reduced
configs of ``tests/test_torch_moe.py`` (d 64, 4 experts, vocabulary 128;
scout 2 layers, maverick 5: two groups and a dropped remainder).

The loss carries both aux terms, so the gradient runs through the
router, the gate and the experts on both sides. The ``ScaleTrainer``
runs 4 replicas in clusters of 2, τ 2, consensus every 2, Γ 2, lr 0.05,
batch 2 x 16, 2 intervals, in each aggregation form: ``picks`` (one
sampled replica a cluster), ``weights`` (two) and ``matrix`` (the
``fog3`` tree), through the per-leaf step and the fused interval (its
kernel block-end's plain version on the CPU), from the reference's
weights and draws, against the reference's per-leaf trainer (its fused
matrix path is no oracle: ROADMAP.md Queue 3). Then a moe checkpoint's
round trip and the scale CLI's counts.

Tolerances: losses rtol 1e-4, every parameter of every replica and the
served model within 1e-5, the ledger exactly (as
``tests/test_torch_scale_forms.py``); a checkpoint and a resumed run
exactly (a checkpoint moves bytes); the divergence probe over a fleet
of maverick replicas rtol 1e-4 (as ``tests/test_torch_scale_hybrid_
trainer.py``: float32 sums over every leaf in another order).
"""
import _torch_threads  # noqa: F401  (torch threads per xdist worker)
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _jax_draws import JaxScaleReplayDraws

from repro.core import distributed as j_dist
from repro.hierarchy import presets as j_presets
from repro.launch import train as j_train_cli
from repro.models import build_model as j_build_model
from repro.obs import telemetry as j_tel
from repro.rounds import RoundProgram as JRoundProgram
from repro.train import ScaleTrainer as JScaleTrainer
from repro.train import TrainerConfig as JTrainerConfig

from repro_torch.core import distributed as dist
from repro_torch.hierarchy import presets
from repro_torch.launch import train as train_cli
from repro_torch.models import build_model, params_from_jax
from repro_torch.models.common import tree_leaves
from repro_torch.obs import telemetry
from repro_torch.rounds import RoundProgram
from repro_torch.train import ScaleTrainer, TrainerConfig

from test_torch_moe import MAVERICK, SCOUT, _cfgs

_SCALE = dict(replicas=4, cluster_size=2, tau=2, consensus_every=2,
              gamma_d2d=2, lr=0.05)
_TCFG = dict(batch_per_replica=2, seq_len=16, intervals=2, eval_every=0,
             eval_batches=1)
# aggregation form -> (scale overrides, hierarchy preset)
FORMS = {"picks": ({}, None),
         "weights": (dict(sample_per_cluster=2), None),
         "matrix": ({}, "fog3")}


def _ledger(tr):
    led = tr.ledger
    return (led.uplinks, led.broadcasts, led.d2d_msgs, led.d2d_rounds,
            led.local_steps, dict(led.uplinks_by_level))


_REF = {}


def _reference(arch, form):
    """The reference's per-leaf ScaleTrainer, cached: its parameters,
    losses, ledger, served model and starting weights."""
    if (arch, form) not in _REF:
        over, hier = FORMS[form]
        tr = JScaleTrainer(
            _cfgs(arch)[1], j_dist.TTHFScaleConfig(**_SCALE, **over),
            JTrainerConfig(**_TCFG), program=JRoundProgram(
                hierarchy=j_presets.get(hier, tau=_SCALE["tau"])
                if hier else None))
        tr.init().run()
        _REF[arch, form] = dict(
            leaves=[np.asarray(l) for l in jax.tree.leaves(tr.params)],
            losses=list(tr.metrics._recent["train_loss"]),
            ledger=_ledger(tr),
            served=[np.asarray(l)
                    for l in jax.tree.leaves(tr._global_params())],
            w0=jax.tree.map(np.asarray,
                            tr.model.init(jax.random.PRNGKey(0))))
    return _REF[arch, form]


def _max_err(got, want):
    return max(float(np.max(np.abs(a.numpy() - b)))
               for a, b in zip(got, want))


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("arch", [SCOUT, MAVERICK])
def test_scale_trainer_matches_reference_per_leaf(arch, form, fused):
    ref = _reference(arch, form)
    over, hier = FORMS[form]
    tr = ScaleTrainer(
        _cfgs(arch)[0], dist.TTHFScaleConfig(**_SCALE, **over),
        TrainerConfig(**_TCFG, fused_interval=fused),
        program=RoundProgram(hierarchy=presets.get(
            hier, tau=_SCALE["tau"]) if hier else None), device="cpu")
    tr.init(w0=params_from_jax(ref["w0"], "cpu"),
            draws=JaxScaleReplayDraws(0))
    tr.run()
    np.testing.assert_allclose(list(tr.metrics._recent["train_loss"]),
                               ref["losses"], rtol=1e-4)
    assert len(ref["losses"]) == _TCFG["intervals"]
    params = tr._spec.unflatten(tr.params) if fused else tr.params
    assert len(tree_leaves(params)) == len(ref["leaves"])
    assert _max_err(tree_leaves(params), ref["leaves"]) <= 1e-5
    assert _ledger(tr) == ref["ledger"]
    assert _max_err(tree_leaves(tr._global_params()), ref["served"]) <= 1e-5
    if fused:
        assert not tr.params[:, tr._spec.total:].any()   # pad stays zero


def _trainer(tmp_path, fused, **kw):
    return ScaleTrainer(
        _cfgs(MAVERICK)[0], dist.TTHFScaleConfig(**_SCALE),
        TrainerConfig(batch_per_replica=1, seq_len=16, intervals=3,
                      eval_every=3, eval_batches=1, fused_interval=fused,
                      ckpt_dir=str(tmp_path), **kw), device="cpu")


@pytest.mark.parametrize("fused", [False, True])
def test_moe_checkpoint_round_trip(tmp_path, fused):
    """Maverick's ``groups`` tree: the checkpoint of interval 2 restored
    into a fresh trainer runs interval 3 as the straight run does
    (parameters bitwise, losses and draw counters equal); the file holds
    the reference's tree (restored by the reference's trainer
    bitwise)."""
    straight = _trainer(tmp_path / "s", fused).init()
    straight.run(3)
    first = _trainer(tmp_path, fused, ckpt_every=2).init()
    first.run(2)
    path = str(tmp_path / "interval_000002.npz")
    resumed = _trainer(tmp_path / "r", fused).restore(path)
    assert resumed.interval == 2
    resumed.run(1)
    a = [straight.params] if fused else tree_leaves(straight.params)
    b = [resumed.params] if fused else tree_leaves(resumed.params)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert list(straight.metrics._recent["train_loss"])[-1] == \
        list(resumed.metrics._recent["train_loss"])[-1]
    assert (straight._train_draws, straight._eval_draws) == \
        (resumed._train_draws, resumed._eval_draws)
    jt = JScaleTrainer(_cfgs(MAVERICK)[1], j_dist.TTHFScaleConfig(**_SCALE),
                       JTrainerConfig(batch_per_replica=1, seq_len=16,
                                      intervals=3, eval_every=3,
                                      eval_batches=1)).restore(path)
    params = first._spec.unflatten(first.params) if fused else first.params
    assert len(tree_leaves(params)) == len(jax.tree.leaves(jt.params))
    for x, y in zip(tree_leaves(params), jax.tree.leaves(jt.params)):
        assert x.numpy().tobytes() == np.asarray(y).tobytes()


@pytest.mark.parametrize("arch", [SCOUT, MAVERICK])
def test_scale_cli_counts_match_reference(arch, capsys):
    """``--mode scale --arch <llama4> --reduced``: the same per-interval
    counts and summary line as the reference CLI (wall time and losses
    aside: each CLI starts from its own package's random weights), and
    finite losses."""
    argv = ["--mode", "scale", "--arch", arch, "--reduced", "--steps", "2",
            "--tau", "2", "--consensus-every", "1", "--batch", "1",
            "--seq", "16"]
    assert j_train_cli.main(argv) == 0
    ref = capsys.readouterr().out.strip().splitlines()
    assert train_cli.main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out.strip().splitlines()
    strip = r"^\[\s*\S+s\] |train_loss=\S+ | wall=\S+s"
    assert [re.sub(strip, "", l) for l in got] == \
        [re.sub(strip, "", l) for l in ref]
    assert got[-1].startswith("intervals=2 ")
    losses = [float(x) for x in re.findall(r"train_loss=(\S+)",
                                           "\n".join(got))]
    assert len(losses) == 2 and np.isfinite(losses).all()


def test_divergence_probe_takes_the_moe_tree():
    """The observability sink's divergence probe over a fleet of 4
    maverick replicas (``groups`` of ``{dense_0, moe}``: the router and
    expert leaves) and over its flat (R, P) carrier, against the
    reference's probe of the same tree."""
    cfg, jcfg = _cfgs(MAVERICK)
    shapes, _ = j_build_model(jcfg).abstract_params()
    rng = np.random.default_rng(0)
    jfleet = jax.tree.map(
        lambda v: rng.normal(size=(4,) + v.shape).astype(np.float32),
        shapes)
    fleet = params_from_jax(jfleet, "cpu")
    assert sorted(fleet["groups"]["moe"]["moe"]) == [
        "router", "w_down", "w_gate", "w_up"]
    varrho = np.full(2, 0.5)
    probe = telemetry.make_divergence_probe(2, 2, varrho)
    want = j_tel.make_divergence_probe(2, 2, varrho)(
        jax.tree.map(jnp.asarray, jfleet))
    spec = dist.FlatParamSpec.for_model(build_model(cfg))
    for got in (probe(fleet), probe(spec.flatten(fleet)[:, :spec.total])):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-4)
