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

from repro_torch.configs import TopologyConfig, TTHFConfig
from repro_torch.core import TTHFTrainer, make_baseline_config
from repro_torch.core.topology import build_network
from repro_torch.launch import train as train_cli
from repro_torch.models import make_sim_model, params_from_jax
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
