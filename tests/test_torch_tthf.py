"""The slice end to end: the port's Algorithm-1 trainer against
``repro.core.TTHFTrainer`` on the CPU, with the same data, the same
starting weights (``params_from_jax``) and the same random draws (a
draw source that replays the reference's JAX key schedule).

Compared: the loss history to rtol 1e-4 (``tests/test_kernels.py``),
the accuracy to within one sample, ``gamma_used`` and the ledger counts
exactly, the dispersion and consensus error to rtol 1e-3 above an
atol of 1e-9 (they are differences of nearly equal float32 models).
The reference's masked_loop run is the oracle for the port with the
kernel on and off (``tests/test_kernels.py`` holds the reference's own
two backends to each other).
"""
import _torch_threads  # noqa: F401  (torch threads per xdist worker)
import dataclasses
import re

import numpy as np
import pytest
import torch

from _jax_draws import JaxReplayDraws

from repro.configs import TopologyConfig as JTopologyConfig
from repro.configs import TTHFConfig as JTTHFConfig
from repro.core import TTHFTrainer as JTTHFTrainer
from repro.core import make_baseline_config as j_baseline
from repro.data import fashion_synth, partition_noniid_labels
from repro.models import make_sim_model as j_make_sim_model
from repro.netsim import scenarios as j_scenarios

from repro_torch.configs import TopologyConfig, TTHFConfig
from repro_torch.core import TTHFTrainer, make_baseline_config
from repro_torch.core.topology import build_network
from repro_torch.kernels.sim_nn_step import sim_nn_forward, sim_nn_update
from repro_torch.launch import train as train_cli
from repro_torch.models import make_sim_model, params_from_jax
from repro_torch.models.simple import SimModel
from repro_torch.netsim import scenarios
from repro_torch.rounds import RoundProgram
from repro_torch.configs.base import HierarchyConfig


# (setup, algo) -> the setup of tests/test_kernels.py (SVM, 10 devices in
# 2 ring clusters) and a 25-device / 5-cluster geometric NN setup
SETUPS = {
    "kernels_svm": dict(devices=10, clusters=2, graph="ring", model="svm",
                        hidden=0, points=800, batch=8, steps=10),
    "geo_nn": dict(devices=25, clusters=5, graph="geometric", model="nn",
                   hidden=32, points=2000, batch=8, steps=10),
}
ALGOS = {
    "tthf": dict(tau=5, consensus_every=2, gamma_d2d=2, constant_lr=0.002),
    "adaptive": dict(tau=5, consensus_every=2, gamma_d2d=-1,
                     constant_lr=0.002),
    "tthf_k2": dict(tau=5, consensus_every=2, gamma_d2d=1,
                    constant_lr=0.002, sample_per_cluster=2),
    "fedavg": "fedavg",
    "centralized": "centralized",
}
_REF_CACHE = {}


def _algo(cls_cfg, baseline, name):
    spec = ALGOS[name]
    if isinstance(spec, str):
        return dataclasses.replace(baseline(spec, 5), constant_lr=0.002)
    return cls_cfg(**spec)


def _setup(setup):
    cfg = SETUPS[setup]
    x, y = fashion_synth(num_points=cfg["points"], seed=0)
    data = partition_noniid_labels(x, y, num_devices=cfg["devices"])
    topo = dict(num_devices=cfg["devices"], num_clusters=cfg["clusters"],
                graph=cfg["graph"])
    return cfg, data, topo


def _reference(setup, algo):
    """The reference run (masked_loop), cached per (setup, algo)."""
    if (setup, algo) not in _REF_CACHE:
        cfg, data, topo = _setup(setup)
        tr = JTTHFTrainer(
            j_make_sim_model(cfg["model"], 784, 10, cfg["hidden"] or 7840),
            data, JTopologyConfig(**topo), _algo(JTTHFConfig, j_baseline, algo),
            batch_size=cfg["batch"])
        _, hist = tr.run(steps=cfg["steps"], eval_every=5, seed=0)
        w0 = {k: np.asarray(v) for k, v in tr.init(0).global_params.items()}
        _REF_CACHE[setup, algo] = (tr, hist, w0)
    return _REF_CACHE[setup, algo]


def _port(setup, algo, use_kernel, w0):
    cfg, data, topo = _setup(setup)
    tr = TTHFTrainer(
        make_sim_model(cfg["model"], 784, 10, cfg["hidden"] or 7840), data,
        TopologyConfig(**topo),
        _algo(TTHFConfig, make_baseline_config, algo),
        batch_size=cfg["batch"], use_kernel=use_kernel, device="cpu")
    st = tr.init(0, w0=params_from_jax(w0, "cpu"), draws=JaxReplayDraws(0))
    st, hist = tr.run(steps=cfg["steps"], eval_every=5, state=st)
    return tr, st, hist


CASES = [("kernels_svm", a) for a in ("tthf", "adaptive", "fedavg",
                                      "centralized")] + \
        [("geo_nn", a) for a in ("tthf", "adaptive", "tthf_k2")]


@pytest.mark.parametrize("setup,algo", CASES)
@pytest.mark.parametrize("use_kernel", [False, True])
def test_trainer_matches_reference(setup, algo, use_kernel):
    jtr, jh, w0 = _reference(setup, algo)
    tr, st, h = _port(setup, algo, use_kernel, w0)
    assert tr.backend == ("pallas" if use_kernel else "masked_loop")
    assert h.ts == jh.ts
    np.testing.assert_allclose(h.global_loss, jh.global_loss, rtol=1e-4)
    n_eval = tr.y.numel()
    np.testing.assert_allclose(h.global_acc, jh.global_acc,
                               atol=1.0 / n_eval + 1e-7)
    for name in ("dispersion", "consensus_err"):
        np.testing.assert_allclose(getattr(h, name), getattr(jh, name),
                                   rtol=1e-3, atol=1e-9)
    assert [g.tolist() for g in h.gamma_used] == \
        [np.asarray(g).tolist() for g in jh.gamma_used]
    assert h.gamma_saturated == jh.gamma_saturated
    assert h.uplinks == jh.uplinks and h.d2d_msgs == jh.d2d_msgs
    assert h.active_devices == jh.active_devices
    for name in ("uplinks", "broadcasts", "d2d_msgs", "d2d_rounds",
                 "local_steps", "uplinks_by_level"):
        assert getattr(tr.ledger, name) == getattr(jtr.ledger, name), name
    assert tr.model_dim == jtr.model_dim
    assert st.t == SETUPS[setup]["steps"]


def _counted_grads(monkeypatch):
    """Count the autograd calls (``SimModel.grads``)."""
    calls = []
    real = SimModel.grads

    def grads(self, *a, **k):
        calls.append(None)
        return real(self, *a, **k)
    monkeypatch.setattr(SimModel, "grads", grads)
    return calls


@pytest.mark.parametrize("scenario", ["static", "device_churn"])
def test_nn_fused_step_matches_autograd_and_reference(scenario, monkeypatch):
    """``nn`` under ``use_kernel=True`` takes the model's fused step (the
    closed-form gradient; its plain versions on the CPU) and no autograd
    call; it matches the port's autograd path and the reference's run,
    static and under device churn, at the tolerances above."""
    cfg, data, topo = _setup("geo_nn")
    algo = _algo(TTHFConfig, make_baseline_config, "tthf")
    dyn = None if scenario == "static" else scenarios.get(scenario, seed=1)
    jtr = JTTHFTrainer(
        j_make_sim_model("nn", 784, 10, cfg["hidden"]), data,
        JTopologyConfig(**topo), _algo(JTTHFConfig, j_baseline, "tthf"),
        batch_size=cfg["batch"],
        dynamics=None if dyn is None else j_scenarios.get(scenario, seed=1))
    _, jh = jtr.run(steps=cfg["steps"], eval_every=5, seed=0)
    w0 = {k: np.asarray(v) for k, v in jtr.init(0).global_params.items()}
    runs = {}
    calls = _counted_grads(monkeypatch)
    for use_kernel in (False, True):
        tr = TTHFTrainer(make_sim_model("nn", 784, 10, cfg["hidden"]), data,
                         TopologyConfig(**topo), algo,
                         batch_size=cfg["batch"], use_kernel=use_kernel,
                         dynamics=dyn, device="cpu")
        st = tr.init(0, w0=params_from_jax(w0, "cpu"),
                     draws=JaxReplayDraws(0))
        del calls[:]
        st, h = tr.run(steps=cfg["steps"], eval_every=5, state=st)
        assert len(calls) == (0 if use_kernel else cfg["steps"])
        assert tr._fused_step() == use_kernel
        runs[use_kernel] = (tr, st, h)
    if scenario != "static":
        assert min(h.active_devices) < cfg["devices"]
    n_eval = runs[True][0].y.numel()
    for tr, st, h in runs.values():
        np.testing.assert_allclose(h.global_loss, jh.global_loss, rtol=1e-4)
        np.testing.assert_allclose(h.global_acc, jh.global_acc,
                                   atol=1.0 / n_eval + 1e-7)
        for name in ("dispersion", "consensus_err"):
            np.testing.assert_allclose(getattr(h, name), getattr(jh, name),
                                       rtol=1e-3, atol=1e-9)
        assert h.active_devices == jh.active_devices
        assert tr.ledger.local_steps == jtr.ledger.local_steps
        assert tr.ledger.d2d_msgs == jtr.ledger.d2d_msgs
    (_, st0, h0), (_, st1, h1) = runs[False], runs[True]
    np.testing.assert_allclose(h1.global_loss, h0.global_loss, rtol=1e-4)
    for k in st0.params:
        np.testing.assert_allclose(st1.params[k].numpy(),
                                   st0.params[k].numpy(), rtol=1e-4,
                                   atol=1e-6)


def test_svm_keeps_autograd_under_use_kernel(monkeypatch):
    """``svm`` has no fused step: ``use_kernel=True`` still runs one
    autograd call an iteration, and the sim step's kernels never launch."""
    cfg, data, topo = _setup("kernels_svm")
    model = make_sim_model("svm", 784, 10)
    assert model.step is None
    tr = TTHFTrainer(model, data, TopologyConfig(**topo),
                     TTHFConfig(**ALGOS["tthf"]), batch_size=8,
                     use_kernel=True, device="cpu")
    calls = _counted_grads(monkeypatch)
    before = (sim_nn_forward.launches, sim_nn_update.launches)
    st, h = tr.run(steps=10, eval_every=5, seed=0)
    assert len(calls) == 10 and not tr._fused_step()
    assert (sim_nn_forward.launches, sim_nn_update.launches) == before
    assert np.isfinite(h.global_loss).all()


@pytest.mark.parametrize("use_kernel", [False, True])
def test_trainer_checks_the_fused_step_when_built(use_kernel):
    """A trainer that will take the model's fused step asks the model, when
    it is built, whether the step runs on its device, so that a width the
    kernels cannot take is refused before a run starts."""
    cfg, data, topo = _setup("geo_nn")
    seen = []
    model = dataclasses.replace(
        make_sim_model("nn", 784, 10, cfg["hidden"]), step_check=seen.append)
    TTHFTrainer(model, data, TopologyConfig(**topo),
                TTHFConfig(**ALGOS["tthf"]), batch_size=8,
                use_kernel=use_kernel, device="cpu")
    assert seen == ([torch.device("cpu")] if use_kernel else [])


def test_default_draws_run_and_resume():
    """Without carried weights or draws the port seeds its own generator;
    a run split in two equals one straight run."""
    cfg, data, topo = _setup("kernels_svm")
    kw = dict(batch_size=8, use_kernel=True, device="cpu")
    algo = TTHFConfig(**ALGOS["tthf"])
    model = make_sim_model("svm", 784, 10)
    _, h1 = TTHFTrainer(model, data, TopologyConfig(**topo), algo,
                        **kw).run(steps=10, eval_every=5, seed=4)
    tr = TTHFTrainer(model, data, TopologyConfig(**topo), algo, **kw)
    st, a = tr.run(steps=5, eval_every=5, seed=4)
    st, b = tr.run(steps=5, eval_every=5, state=st)
    assert a.global_loss + b.global_loss == h1.global_loss
    assert np.isfinite(h1.global_loss).all() and st.t == 10


def test_entry_points_refuse_quietly_running_elsewhere(monkeypatch):
    cfg, data, topo = _setup("kernels_svm")
    args = (make_sim_model("svm", 784, 10), data, TopologyConfig(**topo),
            TTHFConfig())
    # the fog hierarchy runs in sim mode; a calendar the reference
    # rejects raises
    with pytest.raises(ValueError, match="tier-1 period"):
        TTHFTrainer(*args, device="cpu", program=RoundProgram(
            hierarchy=HierarchyConfig(levels=3, taus=(5, 10),
                                      sample=(1, 0))))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TTHFTrainer(*args)
    # scale mode runs the dense, moe, ssm and hybrid kinds (a reduced
    # llama4-maverick here); it feeds token batches only, so it refuses
    # the vlm and audio kinds (the reference's fails on them)
    assert train_cli.main(["--mode", "scale", "--arch",
                           "llama4-maverick-400b-a17b", "--reduced",
                           "--steps", "1", "--tau", "1", "--batch", "1",
                           "--seq", "8", "--device", "cpu"]) == 0
    for arch in ("paligemma-3b", "whisper-small"):
        with pytest.raises(ValueError, match="token batches only"):
            train_cli.main(["--mode", "scale", "--arch", arch,
                            "--reduced", "--device", "cpu"])
    # --scenario, --hierarchy and --control run in both modes; the CLI
    # refuses only what the reference rejects: control with a hierarchy,
    # and control of a star baseline or of star sync
    with pytest.raises(ValueError, match="not composed yet"):
        train_cli.main(["--mode", "scale", "--hierarchy", "fog3",
                        "--control", "connectivity", "--reduced",
                        "--device", "cpu"])
    with pytest.raises(ValueError, match="star baselines"):
        train_cli.main(["--control", "connectivity", "--baseline",
                        "fedavg", "--device", "cpu"])
    with pytest.raises(ValueError, match="star/local"):
        train_cli.main(["--mode", "scale", "--control", "connectivity",
                        "--sync", "star", "--reduced", "--device", "cpu"])


def test_train_cli_summary_line(capsys):
    argv = ["--mode", "sim", "--model", "svm", "--devices", "10",
            "--clusters", "2", "--points", "800", "--steps", "10",
            "--tau", "5", "--consensus-every", "2", "--gamma", "2",
            "--eval-every", "5", "--device", "cpu"]
    assert train_cli.main(argv) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    m = re.fullmatch(r"steps=10 wall=\S+s final_loss=(\S+) final_acc=(\S+) "
                     r"uplinks=(\d+) L1=(\d+) d2d_msgs=(\d+)", line)
    assert m, line
    assert np.isfinite(float(m.group(1)))
    # static schedule: 2 aggregations x 2 clusters; 5 consensus events x
    # Γ=2 rounds x 2 messages per edge
    edges = build_network(TopologyConfig(
        num_devices=10, num_clusters=2, graph="geometric")).num_d2d_edges()
    assert int(m.group(3)) == int(m.group(4)) == 4
    assert int(m.group(5)) == 5 * 2 * 2 * int(edges.sum())
