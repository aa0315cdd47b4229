"""The port's three example twins, run small on the CPU, against the
reference: the uplink and D2D counts exactly, the losses to rtol 1e-4
(``tests/test_kernels.py``). The twins start from the reference's
weights and replay its JAX draws (``init=``, ``params=``/``draws=``), so
the adaptive Remark-1 Γ of the Sec.-IV run, which follows the
trajectory, bills the same D2D rounds.
"""
import _torch_threads  # noqa: F401  (torch threads per xdist worker)
import dataclasses
import importlib.util
import re
import runpy
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from _jax_draws import JaxReplayDraws

from repro.configs import TopologyConfig as JTopologyConfig
from repro.configs import TTHFConfig as JTTHFConfig
from repro.core import TTHFTrainer as JTTHFTrainer
from repro.core import make_baseline_config as j_baseline
from repro.data import fashion_synth, partition_noniid_labels
from repro.models import build_model as j_build_model
from repro.models import make_sim_model as j_make_sim_model

from repro_torch.models import params_from_jax

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _load(name):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _replay_init(w0):
    def init(tr, seed):
        return tr.init(seed, w0=params_from_jax(w0, "cpu"),
                       draws=JaxReplayDraws(seed))
    return init


def test_quickstart_twin_counts_and_losses(capsys):
    steps, points = 20, 2000
    x, y = fashion_synth(num_points=points, seed=0)
    data = partition_noniid_labels(x, y, num_devices=25, labels_per_device=3)
    topo = JTopologyConfig(num_devices=25, num_clusters=5, graph="geometric",
                           target_spectral_radius=0.7, seed=0)
    model = j_make_sim_model("svm", data.feature_dim, data.num_classes)
    ref = []
    for algo in [
            JTTHFConfig(tau=20, consensus_every=5, gamma_d2d=2,
                        constant_lr=0.002),
            dataclasses.replace(j_baseline("fedavg", 20), constant_lr=0.002),
            dataclasses.replace(j_baseline("centralized", 1),
                                constant_lr=0.002)]:
        tr = JTTHFTrainer(model, data, topo, algo, batch_size=16)
        _, h = tr.run(steps=steps, eval_every=steps)
        ref.append((h.global_loss[-1], tr.ledger.uplinks,
                    tr.ledger.d2d_msgs))
    w0 = {k: np.asarray(v) for k, v in tr.init(0).global_params.items()}
    rows = _load("torch_quickstart").main(
        ["--steps", str(steps), "--points", str(points), "--device", "cpu"],
        init=_replay_init(w0))
    out = capsys.readouterr().out.splitlines()
    assert out[0].split() == ["method", "loss", "acc", "uplinks", "d2d"]
    assert [r["method"] for r in rows] == ["tthf", "fl_tau20", "fl_tau1"]
    for row, (loss, ups, d2d), line in zip(rows, ref, out[1:4]):
        assert (row["uplinks"], row["d2d_msgs"]) == (ups, d2d)
        np.testing.assert_allclose(row["loss"], loss, rtol=1e-4)
        assert line.split()[0] == row["method"]
        assert line.split()[3:] == [str(ups), str(d2d)]


def _ledger_lines(text):
    ups = re.search(r"^uplinks=(\d+) .* would be (\d+)\)$", text, re.M)
    d2d = re.search(r"^d2d messages=(\d+), d2d rounds=(\d+)$", text, re.M)
    return ups.groups(), d2d.groups()


def test_image_classification_twin_matches_the_reference_script(
        capsys, monkeypatch):
    argv = ["--fast", "--steps", "20"]
    monkeypatch.setattr(sys, "argv", ["federated_image_classification.py"]
                        + argv)
    runpy.run_path(str(EXAMPLES / "federated_image_classification.py"),
                   run_name="__main__")
    ref_out = capsys.readouterr().out
    # the reference script's trainer starts from seed 0: its weights
    x, y = fashion_synth(num_points=6000, seed=0, unit_norm=True)
    data = partition_noniid_labels(x, y, num_devices=25, labels_per_device=3)
    w0 = j_make_sim_model("svm", data.feature_dim, data.num_classes).init(
        jax.random.split(jax.random.PRNGKey(0))[0])
    w0 = {k: np.asarray(v) for k, v in w0.items()}
    tr, hist = _load("torch_federated_image_classification").main(
        argv + ["--device", "cpu"], init=_replay_init(w0))
    out = capsys.readouterr().out
    assert _ledger_lines(out) == _ledger_lines(ref_out)
    assert out.splitlines()[0] == ref_out.splitlines()[0]   # avg lambda
    # the table: t, loss (rtol 1e-4 through 4 decimals), mean Gamma_c
    def table(text):
        return [l.split() for l in text.splitlines()
                if re.match(r"^\s+\d+ ", l)]
    ref_rows, rows = table(ref_out), table(out)
    assert [r[0] for r in rows] == [r[0] for r in ref_rows]
    assert [r[5] for r in rows] == [r[5] for r in ref_rows]
    np.testing.assert_allclose([float(r[1]) for r in rows],
                               [float(r[1]) for r in ref_rows],
                               atol=1.5e-4)
    assert sum(np.sum(g) for g in hist.gamma_used) > 0
    assert out.splitlines()[-1] == ref_out.splitlines()[-1]


def test_lm_pretrain_twin_matches_the_reference_script(capsys, monkeypatch):
    argv = ["--dim", "64", "--layers", "1", "--d-ff", "128", "--vocab",
            "256", "--seq", "16", "--batch", "2", "--tau", "2"]
    monkeypatch.setattr(sys, "argv", ["tthf_lm_pretrain.py"] + argv)
    runpy.run_path(str(EXAMPLES / "tthf_lm_pretrain.py"),
                   run_name="__main__")
    ref_out = capsys.readouterr().out
    ref_losses = [float(m) for m in
                  re.findall(r"^interval +\d+: loss=(\S+) ", ref_out, re.M)]
    mod = _load("torch_tthf_lm_pretrain")
    # the reference script's weights (model.init(PRNGKey(0))) and picks
    # (key = PRNGKey(1); key, kp = split(key); randint(kp, (N,), 0, s))
    from repro.configs import get_arch
    cfg = dataclasses.replace(
        get_arch("qwen1.5-0.5b"), num_layers=1, d_model=64, d_ff=128,
        num_heads=4, num_kv_heads=4, head_dim=64, vocab_size=256,
        max_seq_len=4096)
    w0 = j_build_model(cfg).init(jax.random.PRNGKey(0))

    class Picks:
        key = jax.random.PRNGKey(1)

        def picks(self, num_clusters, cluster_size, k):
            Picks.key, kp = jax.random.split(Picks.key)
            return torch.from_numpy(np.array(jax.random.randint(
                kp, (num_clusters,), 0, cluster_size))).long()

    losses = mod.main(argv + ["--device", "cpu"],
                      params=params_from_jax(w0, "cpu"), draws=Picks())
    out = capsys.readouterr().out
    assert len(losses) == len(ref_losses) == 2
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)
    assert out.splitlines()[0] == ref_out.splitlines()[0]
    trailer = [l for l in out.splitlines() if l.startswith("uplink traffic")]
    assert trailer == [l for l in ref_out.splitlines()
                       if l.startswith("uplink traffic")]
    assert "(2) vs full participation (4)" in trailer[0]


@pytest.mark.parametrize("name", ["torch_quickstart",
                                  "torch_federated_image_classification",
                                  "torch_tthf_lm_pretrain"])
def test_twins_need_the_card_unless_asked_for_the_cpu(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _load(name).main(["--steps", "1"] if name != "torch_tthf_lm_pretrain"
                         else ["--intervals", "1"])
