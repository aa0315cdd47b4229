"""Scale mode's ``weights`` and ``matrix`` aggregation forms and the
per-interval refreshes in the port, against ``repro.core.distributed``
and ``repro.train`` on the CPU.

The setup is the reference's own (``tests/test_hierarchy.py``,
``tests/test_control.py``): a 2-layer qwen cut to d 64, 8 replicas in
clusters of 2, τ 2, consensus every 2, Γ 2, lr 0.05, batch 2 × 16, 4
intervals. Cases: two sampled replicas per cluster, ``device_churn``,
``fog3``, ``fog3`` under churn, and the ``connectivity`` policy. Each
runs through the port's per-leaf step and its fused interval (the
kernel block-end; on the CPU the kernel's plain version), from the
reference's weights and draws, and is
held to the reference's per-leaf ``ScaleTrainer``: every parameter of
every replica to 1e-5, the losses to rtol 1e-4, the ledger exactly. The
reference's fused matrix path is no oracle (its own
``test_fused_interval_bitwise_matrix_agg`` fails, ROADMAP.md Queue 3),
so both of the port's paths are held to the per-leaf one.
"""
import _torch_threads  # noqa: F401  (torch threads per xdist worker)
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _jax_draws import JaxScaleReplayDraws

from repro.configs import get_arch as j_get_arch
from repro.control import get_policy as j_get_policy
from repro.core import distributed as j_dist
from repro.hierarchy import presets as j_presets
from repro.launch import train as j_train_cli
from repro.netsim import scenarios as j_scenarios
from repro.rounds import RoundProgram as JRoundProgram
from repro.train import ScaleTrainer as JScaleTrainer
from repro.train import TrainerConfig as JTrainerConfig

from repro_torch.configs import get_arch
from repro_torch.configs.base import ControlConfig
from repro_torch.control import get_policy
from repro_torch.core import distributed as dist
from repro_torch.hierarchy import presets
from repro_torch.launch import train as train_cli
from repro_torch.models import params_from_jax
from repro_torch.models.common import tree_leaves
from repro_torch.netsim import scenarios
from repro_torch.rounds import RoundProgram
from repro_torch.train import ScaleTrainer, TrainerConfig

_KW = dict(num_layers=2, d_model=64, d_ff=128, vocab_size=128)
_SCALE = dict(replicas=8, cluster_size=2, tau=2, consensus_every=2,
              gamma_d2d=2, lr=0.05)
_TCFG = dict(batch_per_replica=2, seq_len=16, intervals=4, eval_every=0,
             eval_batches=1)
_INTERVALS = 4

# name -> (scale overrides, dynamics scenario and seed, hierarchy, policy)
CASES = {
    "multi": (dict(sample_per_cluster=2), None, None, None),
    "churn": ({}, ("device_churn", 0), None, None),
    "fog3": ({}, None, "fog3", None),
    "fog3_churn": ({}, ("device_churn", 3), "fog3", None),
    "connectivity": ({}, None, None, "connectivity"),
}


def _program(mod_scen, mod_presets, policy_fn, cls, name, control=None):
    _, dyn, hier, policy = CASES[name]
    return cls(
        dynamics=mod_scen.get(dyn[0], seed=dyn[1]) if dyn else None,
        hierarchy=mod_presets.get(hier, tau=_SCALE["tau"]) if hier else None,
        control=control or (policy_fn(policy) if policy else None))


def _ledger(tr):
    led = tr.ledger
    return (led.uplinks, led.broadcasts, led.d2d_msgs, led.d2d_rounds,
            led.local_steps, dict(led.uplinks_by_level))


_REF = {}


def _reference(name):
    """The reference's per-leaf ScaleTrainer, cached: its parameters,
    losses, ledger, served model and starting weights."""
    if name not in _REF:
        over = CASES[name][0]
        tr = JScaleTrainer(
            j_get_arch("qwen1.5-0.5b").reduced(**_KW),
            j_dist.TTHFScaleConfig(**_SCALE, **over),
            JTrainerConfig(**_TCFG),
            program=_program(j_scenarios, j_presets, j_get_policy,
                             JRoundProgram, name))
        tr.init().run()
        w0 = jax.tree.map(np.asarray, tr.model.init(jax.random.PRNGKey(0)))
        ctl = tr._resolver.controller
        _REF[name] = dict(
            leaves=[np.asarray(l) for l in jax.tree.leaves(tr.params)],
            losses=list(tr.metrics._recent["train_loss"]),
            ledger=_ledger(tr), delay=tr.ledger.delay(0.1),
            served=[np.asarray(l)
                    for l in jax.tree.leaves(tr._global_params())],
            w0=w0, counters=ctl.counters() if ctl else None)
    return _REF[name]


def _port(name, fused, w0, control=None):
    over = CASES[name][0]
    tr = ScaleTrainer(
        get_arch("qwen1.5-0.5b").reduced(**_KW),
        dist.TTHFScaleConfig(**_SCALE, **over),
        TrainerConfig(**_TCFG, fused_interval=fused),
        program=_program(scenarios, presets, get_policy, RoundProgram, name,
                         control=control), device="cpu")
    draws = JaxScaleReplayDraws(0)
    tr.init(w0=params_from_jax(w0, "cpu"), draws=draws)
    tr.run()
    return tr, draws


def _leaves(tr):
    params = tr._spec.unflatten(tr.params) if tr._spec else tr.params
    return tree_leaves(params)


def _max_err(got, want):
    return max(float(np.max(np.abs(a.numpy() - b)))
               for a, b in zip(got, want))


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("name", list(CASES))
def test_scale_trainer_matches_reference_per_leaf(name, fused):
    ref = _reference(name)
    tr, draws = _port(name, fused, ref["w0"])
    np.testing.assert_allclose(list(tr.metrics._recent["train_loss"]),
                               ref["losses"], rtol=1e-4)
    assert len(ref["losses"]) == _INTERVALS
    assert _max_err(_leaves(tr), ref["leaves"]) <= 1e-5
    assert _ledger(tr) == ref["ledger"]
    assert tr.ledger.delay(0.1) == pytest.approx(ref["delay"], rel=1e-12)
    assert _max_err(tree_leaves(tr._global_params()), ref["served"]) <= 1e-5
    # a host seed an interval where the reference seeds a host generator
    # (dynamics, a fog tree, the controller); static picks otherwise
    assert draws.host_seeds == (0 if name == "multi" else _INTERVALS)
    if fused:
        assert not tr.params[:, tr._spec.total:].any()   # pad stays zero
    ctl = tr._resolver.controller
    assert (ctl.counters() if ctl else None) == ref["counters"]
    if name == "connectivity":
        # pairs average exactly in one round: the controller's Γ is 1,
        # half the static schedule's messages
        assert tr.ledger.d2d_msgs * 2 == _reference("multi")["ledger"][2]
        assert ctl.decisions == _INTERVALS and ctl.fallbacks == 0


def test_fog3_serves_the_root_model():
    """Between root events the served model is the last root snapshot
    (a copy: the step updates the replicas in place), not replica 0."""
    ref = _reference("fog3")
    tr = ScaleTrainer(get_arch("qwen1.5-0.5b").reduced(**_KW),
                      dist.TTHFScaleConfig(**_SCALE),
                      TrainerConfig(**_TCFG),
                      hierarchy=presets.get("fog3", tau=2), device="cpu")
    tr.init(w0=params_from_jax(ref["w0"], "cpu"),
            draws=JaxScaleReplayDraws(0))
    init = [l.clone() for l in tree_leaves(tr._global_params())]
    tr.run(1)                       # tier 1 only: the root has not fired
    assert all(torch.equal(a, b)
               for a, b in zip(tree_leaves(tr._global_params()), init))
    tr.run(1)                       # interval 2 is a root event
    served = [l.clone() for l in tree_leaves(tr._global_params())]
    assert all(torch.equal(a, b[0]) for a, b in
               zip(served, tree_leaves(tr.params)))
    assert not all(torch.equal(a, b) for a, b in zip(served, init))
    tr.run(1)                       # tier 1 again: the snapshot holds
    assert all(torch.equal(a, b)
               for a, b in zip(tree_leaves(tr._global_params()), served))
    assert tr.ledger.uplinks_by_level == {1: 12, 2: 2}


@pytest.mark.parametrize("name", [None, "churn"])
def test_static_policy_is_bitwise_the_run_without_one(name):
    w0 = _reference("churn")["w0"]
    runs = []
    for control in (None, ControlConfig()):
        tr = ScaleTrainer(
            get_arch("qwen1.5-0.5b").reduced(**_KW),
            dist.TTHFScaleConfig(**_SCALE), TrainerConfig(**_TCFG),
            program=RoundProgram(
                dynamics=scenarios.get("device_churn", seed=0)
                if name else None, control=control), device="cpu")
        tr.init(w0=params_from_jax(w0, "cpu"), draws=JaxScaleReplayDraws(0))
        runs.append(tr.run(2))
    assert runs[1]._resolver.controller is None
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(runs[0].params), tree_leaves(runs[1].params)))
    assert runs[0].ledger == runs[1].ledger


# ---------------------------------------------------------------------------
# the forms' functions
# ---------------------------------------------------------------------------

def _weights(rng, dark):
    w = rng.random((4, 2)) * (rng.random((4, 2)) < 0.8)
    w[1] = 0.0                              # a dark cluster
    if dark:
        w[:] = 0.0                          # an all-dark event
    return (w / max(w.sum(), 1e-30)).astype(np.float32)


@pytest.mark.parametrize("dark", [False, True])
def test_weighted_aggregation_equals_the_reference(dark):
    net = dist.TTHFScaleConfig(**_SCALE).network()
    jnet = j_dist.TTHFScaleConfig(**_SCALE).network()
    rng = np.random.default_rng(4)
    tree = {"a": rng.normal(size=(8, 3, 5)).astype(np.float32),
            "b": rng.normal(size=(8, 7)).astype(np.float32)}
    w = _weights(rng, dark)
    got = dist.weighted_aggregation(params_from_jax(tree, "cpu"), net,
                                    torch.from_numpy(w))
    want = j_dist.weighted_aggregation(
        {k: jnp.asarray(v) for k, v in tree.items()}, jnet, jnp.asarray(w))
    flat = np.concatenate([tree["a"].reshape(8, -1), tree["b"]], 1)
    got_flat = dist.weighted_aggregation_flat(torch.from_numpy(flat.copy()),
                                              net, torch.from_numpy(w))
    want_flat = j_dist.weighted_aggregation_flat(jnp.asarray(flat), jnet,
                                                 jnp.asarray(w))
    for k in tree:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-6)
    np.testing.assert_allclose(got_flat.numpy(), np.asarray(want_flat),
                               atol=1e-6)
    if dark:
        np.testing.assert_array_equal(got_flat.numpy(), flat)


@pytest.mark.parametrize("block", [7, 1 << 22])
def test_device_matrix_in_column_blocks_equals_the_reference(block,
                                                             monkeypatch):
    from repro.hierarchy import aggregate as j_agg
    from repro.hierarchy import build_tree as j_build_tree
    monkeypatch.setattr(dist, "MATRIX_BLOCK_COLS", block)
    cfg = j_presets.get("fog3", tau=2)
    ev = j_agg.build_event(np.random.default_rng(2),
                           j_build_tree(cfg, 4, 2), cfg, 4,
                           np.random.default_rng(3).random((4, 2)) < 0.7,
                           receive_offline=True)
    M = ev.device_matrix
    rng = np.random.default_rng(5)
    flat = rng.normal(size=(8, 101)).astype(np.float32)
    tree = {"a": rng.normal(size=(8, 3, 11)).astype(np.float32)}
    got = dist.apply_device_matrix_flat(torch.from_numpy(flat.copy()),
                                        torch.from_numpy(M))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(j_dist.apply_device_matrix_flat(
            jnp.asarray(flat), jnp.asarray(M))), atol=1e-6)
    gt = dist.apply_device_matrix_pytree(params_from_jax(tree, "cpu"),
                                         torch.from_numpy(M))
    np.testing.assert_allclose(
        gt["a"].numpy(), np.asarray(j_agg.apply_device_matrix_pytree(
            {"a": jnp.asarray(tree["a"])}, jnp.asarray(M))["a"]), atol=1e-6)


def test_trainer_refuses_what_the_reference_asserts():
    cfg = get_arch("qwen1.5-0.5b").reduced(**_KW)
    scale = dist.TTHFScaleConfig(**_SCALE)
    fog = presets.get("fog3", tau=2)
    with pytest.raises(ValueError, match="fan-in"):
        ScaleTrainer(cfg, dataclasses.replace(scale, sample_per_cluster=2),
                     TrainerConfig(**_TCFG), hierarchy=fog, device="cpu")
    with pytest.raises(ValueError, match="implies tthf"):
        ScaleTrainer(cfg, scale, TrainerConfig(**_TCFG), hierarchy=fog,
                     sync="star", device="cpu")
    with pytest.raises(ValueError, match="fused_power"):
        ScaleTrainer(cfg, dataclasses.replace(scale, consensus_mode="rounds"),
                     TrainerConfig(**_TCFG), device="cpu",
                     program=RoundProgram(
                         control=get_policy("connectivity")))
    with pytest.raises(ValueError, match="not composed yet"):
        ScaleTrainer(cfg, scale, TrainerConfig(**_TCFG), device="cpu",
                     program=RoundProgram(control=get_policy("remark1"),
                                          hierarchy=fog))


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("more", [
    ["--scenario", "device_churn", "--hierarchy", "fog3"],
    ["--scenario", "device_churn", "--control", "connectivity"],
])
def test_scale_cli_counts_match_reference(more, capsys):
    argv = ["--mode", "scale", "--arch", "qwen1.5-0.5b", "--reduced",
            "--steps", "2", "--tau", "2", "--consensus-every", "2",
            "--replicas", "8", "--batch", "2", "--seq", "16"] + more
    assert j_train_cli.main(argv) == 0
    ref = capsys.readouterr().out.strip().splitlines()
    assert train_cli.main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out.strip().splitlines()

    def counts(lines):
        return [re.sub(r"^\[\s*\S+s\] |train_loss=\S+ |wall=\S+s ", "", l)
                for l in lines]
    assert len(got) == len(ref) == 3
    assert counts(got) == counts(ref)
    assert "uplinks=" in got[-1] and "intervals=2" in got[-1]
