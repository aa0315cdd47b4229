"""The port's observability (``repro_torch.obs``) against ``repro.obs`` on
the CPU: the tracer, the manifest, the sink, the divergence probe and the
theory gauges, and the instrumented trainers and serve CLI.

Tolerances, and why:
- the gauges, the comm records, the counters' values and the record
  keys: exact (the same float64 host arithmetic, the same integer
  bookkeeping);
- the divergence probe on one fleet from numpy: rtol 1e-5 (float32 sums
  in another order);
- the probes of an instrumented run against the reference's: rtol 1e-4,
  as the trainers' losses are held, with atol 1e-6 for the values that
  are float32 rounding noise of models that agree exactly (Υ and the
  residuals right after a broadcast);
- an instrumented run against the bare port run: bitwise.
"""
import _torch_threads  # noqa: F401  (torch threads per xdist worker)
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _jax_draws import JaxReplayDraws, JaxScaleReplayDraws

from repro.configs import TopologyConfig as JTopologyConfig
from repro.configs import TTHFConfig as JTTHFConfig
from repro.configs import get_arch as j_get_arch
from repro.control import get_policy as j_get_policy
from repro.core import TTHFTrainer as JTTHFTrainer
from repro.core.distributed import TTHFScaleConfig as JTTHFScaleConfig
from repro.data import fashion_synth, partition_noniid_labels
from repro.launch import serve as j_serve_cli
from repro.models import make_sim_model as j_make_sim_model
from repro.obs import manifest as j_manifest
from repro.obs import sink as j_sink
from repro.obs import telemetry as j_tel
from repro.obs import trace as j_trace
from repro.rounds import RoundProgram as JRoundProgram
from repro.train import ScaleTrainer as JScaleTrainer
from repro.train import TrainerConfig as JTrainerConfig

from repro_torch.configs import TopologyConfig, TTHFConfig, get_arch
from repro_torch.control import get_policy
from repro_torch.core import TTHFTrainer
from repro_torch.core.distributed import TTHFScaleConfig
from repro_torch.core.theory import ProblemConstants
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import make_sim_model, params_from_jax
from repro_torch.models.common import tree_leaves
from repro_torch.obs import manifest, telemetry
from repro_torch.obs.sink import NULL_OBS, make_obs
from repro_torch.obs.trace import (
    Tracer, profiler_trace, validate_chrome_trace)
from repro_torch.rounds import RoundProgram
from repro_torch.train import ScaleTrainer, TrainerConfig


def _records(d: Path) -> list:
    return [json.loads(l) for l in
            (d / "metrics.jsonl").read_text().splitlines()]


def _trace(d: Path) -> dict:
    doc = json.loads((d / "trace.json").read_text())
    assert validate_chrome_trace(doc) == []
    assert j_trace.validate_chrome_trace(doc) == []
    return doc


def _shape(doc: dict) -> list:
    """A trace without its clock: each event's name, phase and args
    (counters' values included), in order."""
    return [(e["name"], e["ph"], e.get("args")) for e in doc["traceEvents"]
            if e["ph"] != "M"]


# ===========================================================================
# tracer, manifest, sink
# ===========================================================================

def _spans(tr):
    with tr.span("run", intervals=2):
        with tr.span("round", interval=0):
            with tr.span("interval", tau=4, eta=np.float32(0.5)):
                pass
            tr.instant("consensus_event", repeats=2,
                       gammas=np.array([1, 2]))
            tr.counter("ledger", uplinks=3, d2d_msgs=12)


def test_tracer_nesting_export_and_validator_match_reference(tmp_path):
    tr, jtr = Tracer(), j_trace.Tracer()
    _spans(tr)
    _spans(jtr)
    doc = json.loads(Path(tr.export(str(tmp_path / "t.json"))).read_text())
    jdoc = json.loads(Path(jtr.export(str(tmp_path / "j.json"))).read_text())
    assert validate_chrome_trace(doc) == j_trace.validate_chrome_trace(
        doc) == []
    assert _shape(doc) == _shape(jdoc)
    assert [e["name"] for e in doc["traceEvents"] if e["ph"] == "M"] == \
        [e["name"] for e in jdoc["traceEvents"] if e["ph"] == "M"]
    spans = {e["name"]: e for e in doc["traceEvents"] if e["ph"] == "X"}
    for outer, inner in (("run", "round"), ("round", "interval")):
        o, i = spans[outer], spans[inner]
        assert o["ts"] <= i["ts"] and \
            o["ts"] + o["dur"] >= i["ts"] + i["dur"]
    # a 0-d tensor argument becomes a number, a tensor a list
    tr.instant("x", a=torch.tensor(1.5), b=torch.tensor([1, 2]))
    assert tr.events[-1]["args"] == {"a": 1.5, "b": [1, 2]}
    bad = {"traceEvents": [{"ph": "X", "pid": 1, "name": "x", "ts": 0.0,
                            "dur": -1.0}, {"ph": "i"}]}
    assert validate_chrome_trace(bad) == j_trace.validate_chrome_trace(bad)
    assert validate_chrome_trace({}) == ["missing traceEvents"]


def test_manifest_keys_and_config_hash_match_reference(tmp_path):
    for port_cfg, ref_cfg in (
            (TTHFConfig(tau=4, gamma_d2d=-1, constant_lr=0.01),
             JTTHFConfig(tau=4, gamma_d2d=-1, constant_lr=0.01)),
            (TrainerConfig(batch_per_replica=2, ckpt_every=3,
                           fused_interval=True, trace_dir="d"),
             JTrainerConfig(batch_per_replica=2, ckpt_every=3,
                            fused_interval=True, trace_dir="d"))):
        assert manifest.config_hash(port_cfg) == \
            j_manifest.config_hash(ref_cfg)
    assert manifest.config_hash(TTHFConfig(tau=4)) != \
        manifest.config_hash(TTHFConfig(tau=5))
    cfg = {"algo": TTHFConfig(), "argv": ["--steps", 2]}
    doc = json.loads(Path(manifest.write_manifest(
        str(tmp_path / "p"), config=cfg, extra={"mode": "sim"})).read_text())
    jdoc = json.loads(Path(j_manifest.write_manifest(
        str(tmp_path / "j"), config={"algo": JTTHFConfig(),
                                     "argv": ["--steps", 2]},
        extra={"mode": "sim"})).read_text())
    assert set(doc) == set(jdoc)
    assert set(doc["mesh"]) == set(jdoc["mesh"])
    assert doc["mesh"] == {"backend": "cpu", "device_count": 1,
                           "device_kinds": ["cpu"]}
    assert doc["config_hash"] == jdoc["config_hash"]
    assert doc["config"] == jdoc["config"] and doc["mode"] == "sim"
    empty = json.loads(Path(manifest.write_manifest(
        str(tmp_path / "e"))).read_text())
    assert empty["config"] is None and empty["config_hash"] is None


def test_sink_artifacts_and_null_obs(tmp_path):
    assert make_obs(None) is NULL_OBS and not NULL_OBS.enabled
    with NULL_OBS.span("x"):
        NULL_OBS.emit("round", 1, a=1)
    obs = make_obs(str(tmp_path / "o"), run_name="r", config={"a": 1},
                   extra={"arch": "x"})
    with obs.span("run"):
        obs.counter("ledger", uplinks=1)
        obs.emit("round", 3, upsilon=torch.tensor([0.5, 0.25]),
                 eta=np.float32(0.5), by_level={1: 2})
    obs.close()
    obs.close()                          # idempotent
    d = tmp_path / "o"
    assert json.loads((d / "manifest.json").read_text())["run"] == "r"
    (rec,) = _records(d)
    assert rec["kind"] == "round" and rec["step"] == 3
    assert rec["upsilon"] == [0.5, 0.25] and rec["by_level"] == {"1": 2}
    assert {e["name"] for e in _trace(d)["traceEvents"]} >= {"run",
                                                             "ledger"}
    assert not (d / "torch_profile").exists()
    with pytest.raises(ValueError, match="trace_dir"):
        from repro_torch.obs.sink import Observability, ObsConfig
        Observability(ObsConfig())


def test_profile_writes_a_torch_profiler_trace(tmp_path):
    obs = make_obs(str(tmp_path / "o"), profile=True)
    with obs.span("work"):
        torch.ones(64, 64) @ torch.ones(64, 64)
    obs.close()
    doc = json.loads((tmp_path / "o" / "torch_profile" /
                      "trace.json").read_text())
    names = {e.get("name") for e in doc["traceEvents"]}
    # the span's record_function annotation and the op under it
    assert "work" in names and "aten::mm" in names
    # the same profiler as a context, or none without a trace dir
    with profiler_trace(str(tmp_path / "c")):
        torch.ones(8) + 1
    assert (tmp_path / "c" / "torch_profile" / "trace.json").exists()
    with profiler_trace(None):
        pass


# ===========================================================================
# probes and gauges
# ===========================================================================

@pytest.mark.parametrize("block", [None, 8])
def test_divergence_probe_matches_reference(block, monkeypatch):
    """A two-leaf fleet and a flat (R, P) carrier with pad columns (the
    port's probe reads it without the pad, the reference's with the
    zero pad); ``block`` cuts the leaves into column blocks."""
    if block:
        monkeypatch.setattr(telemetry, "_BLOCK", block)
    N, s = 3, 4
    rng = np.random.default_rng(0)
    tree = {"a": rng.normal(size=(N * s, 7)).astype(np.float32),
            "b": {"c": rng.normal(size=(N * s, 2, 5)).astype(np.float32)}}
    varrho = np.array([0.5, 0.3, 0.2])
    probe = telemetry.make_divergence_probe(N, s, varrho)
    jprobe = j_tel.make_divergence_probe(N, s, varrho)
    flat = np.concatenate([tree["a"], tree["b"]["c"].reshape(N * s, -1),
                           np.zeros((N * s, 3), np.float32)], axis=1)
    for got, want in (
            (probe(params_from_jax(tree, "cpu")),
             jprobe(jax.tree.map(jnp.asarray, tree))),
            (probe(torch.from_numpy(flat)[:, :17]),
             jprobe(jnp.asarray(flat)))):
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == torch.float32
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-5)


def test_theory_gauges_equal_reference():
    k = telemetry.default_constants(0.2)
    jk = j_tel.default_constants(0.2)
    assert k == ProblemConstants(**vars(jk))
    for kw in (dict(gamma=2.0, alpha=50.0), dict(lr=0.01)):
        g = telemetry.TheoryGauges(constants=k, tau=5, model_dim=7850,
                                   phi=0.5, **kw)
        jg = j_tel.TheoryGauges(constants=jk, tau=5, model_dim=7850,
                                phi=0.5, **kw)
        for t, prev in ((5, 0), (7, 5), (20, 10)):
            assert g.round_gauges(t, prev) == jg.round_gauges(t, prev)
            assert g.eta(t) == jg.eta(t)
        args = (np.array([0.9, 0.5, 0.7]), np.array([2, 0, 3]), 5,
                np.array([0.1, 0.2, 0.05]))
        assert np.array_equal(g.lemma1(*args), jg.lemma1(*args))
    assert telemetry.sigma_t_general(1.0, lambda j: 2.0 / (j + 50), 9, 3) \
        == j_tel.sigma_t_general(1.0, lambda j: 2.0 / (j + 50), 9, 3)
    with pytest.raises(ValueError, match="XOR"):
        telemetry.TheoryGauges(constants=k, tau=5, model_dim=1)


# ===========================================================================
# the instrumented sim trainer (svm, 8 devices in 2 clusters; static and
# under the remark1 control policy)
# ===========================================================================

_SIM_STEPS = 8


def _sim_world():
    x, y = fashion_synth(num_points=400, seed=0)
    return partition_noniid_labels(x, y, num_devices=8, labels_per_device=3,
                                   seed=0)


_TOPO = dict(num_devices=8, num_clusters=2, graph="geometric", seed=0)
_ALGO = dict(tau=4, consensus_every=2, gamma_d2d=2, constant_lr=0.01)


def _ref_sim(policy, d):
    tr = JTTHFTrainer(j_make_sim_model("svm", 784, 10), _sim_world(),
                      JTopologyConfig(**_TOPO), JTTHFConfig(**_ALGO),
                      batch_size=8,
                      program=JRoundProgram(
                          control=j_get_policy(policy) if policy else None))
    obs = j_sink.make_obs(str(d), run_name="sim")
    try:
        tr.run(steps=_SIM_STEPS, seed=0, eval_every=4, obs=obs)
    finally:
        obs.close()
    return {k: np.asarray(v) for k, v in tr.init(0).global_params.items()}


def _port_sim(policy, w0, obs=None):
    tr = TTHFTrainer(make_sim_model("svm", 784, 10), _sim_world(),
                     TopologyConfig(**_TOPO), TTHFConfig(**_ALGO),
                     batch_size=8, use_kernel=True,
                     program=RoundProgram(
                         control=get_policy(policy) if policy else None),
                     device="cpu")
    st = tr.init(0, w0=params_from_jax(w0, "cpu"), draws=JaxReplayDraws(0))
    st, hist = tr.run(steps=_SIM_STEPS, eval_every=4, state=st, obs=obs)
    return tr, st, hist


_NOISY = ("upsilon", "consensus_err", "mix_residual", "dispersion",
          "upsilon_pre", "lemma1_bound")


def _assert_records_match(got: list, want: list) -> None:
    assert [(r["kind"], r["step"]) for r in got] == \
        [(r["kind"], r["step"]) for r in want]
    for g, w in zip(got, want):
        assert set(g) == set(w), (g["kind"], set(g) ^ set(w))
        for key, val in w.items():
            if key == "wall_s":
                continue
            if isinstance(val, float) or (isinstance(val, list) and val
                                          and isinstance(val[0], float)):
                atol = 1e-6 if key in _NOISY else 0.0
                np.testing.assert_allclose(g[key], val, rtol=1e-4,
                                           atol=atol, err_msg=key)
            else:
                assert g[key] == val, (g["kind"], key)


_GAUGES = ("sigma_t", "dispersion_bound", "eps0", "eta", "gamma_used",
           "gamma_saturated", "gamma_saturated_total", "active_devices")


@pytest.mark.parametrize("policy", [None, "remark1"])
def test_instrumented_sim_run_is_bare_and_matches_reference(policy,
                                                            tmp_path):
    w0 = _ref_sim(policy, tmp_path / "ref")
    _, bare, bare_hist = _port_sim(policy, w0)
    obs = make_obs(str(tmp_path / "port"), run_name="sim")
    try:
        tr, st, hist = _port_sim(policy, w0, obs)
    finally:
        obs.close()
    for a, b in zip(tree_leaves(bare.params), tree_leaves(st.params)):
        assert torch.equal(a, b)
    assert hist.global_loss == bare_hist.global_loss

    got, want = _records(tmp_path / "port"), _records(tmp_path / "ref")
    _assert_records_match(got, want)
    rounds = [r for r in got if r["kind"] == "round"]
    assert [r["step"] for r in rounds] == [2, 4, 6, 8]
    for g, w in zip(rounds, [r for r in want if r["kind"] == "round"]):
        for key in _GAUGES:
            assert g[key] == w[key], key          # the gauges exactly
    assert sum(r["d2d_msgs"] for r in got if r["kind"] == "comm") == \
        tr.ledger.d2d_msgs
    assert {r["kind"] for r in got} == {"round", "comm", "eval"}
    assert all(np.isfinite(r["grad_norm"]) for r in got
               if r["kind"] == "eval")

    doc, jdoc = _trace(tmp_path / "port"), _trace(tmp_path / "ref")
    # the same spans, instants and counters, in the same order; counters
    # (resolver, control, ledger) with the reference's values
    assert [(n, ph) for n, ph, _ in _shape(doc)] == \
        [(n, ph) for n, ph, _ in _shape(jdoc)]
    assert [a for _, ph, a in _shape(doc) if ph == "C"] == \
        [a for _, ph, a in _shape(jdoc) if ph == "C"]
    names = {n for n, _, _ in _shape(doc)}
    assert {"run", "round", "interval", "resolve", "consensus_event",
            "aggregation", "resolver", "ledger"} <= names
    assert ("control" in names) == (policy is not None)


def test_train_cli_trace_dir_and_profile_in_sim_mode(tmp_path, capsys):
    argv = ["--mode", "sim", "--model", "svm", "--devices", "8",
            "--clusters", "2", "--points", "400", "--steps", "4",
            "--tau", "2", "--consensus-every", "1", "--eval-every", "2",
            "--device", "cpu"]
    assert train_cli.main(argv) == 0
    bare = capsys.readouterr().out.split()[2:]
    d = tmp_path / "sim"
    assert train_cli.main(argv + ["--trace-dir", str(d), "--profile"]) == 0
    assert capsys.readouterr().out.split()[2:] == bare
    assert json.loads((d / "manifest.json").read_text())["mode"] == "sim"
    assert {r["kind"] for r in _records(d)} == {"round", "comm", "eval"}
    assert (d / "torch_profile" / "trace.json").stat().st_size > 0
    _trace(d)


# ===========================================================================
# the instrumented scale trainer
# ===========================================================================

_SCALE_CFG = dict(num_layers=1, d_model=32, d_ff=64, vocab_size=128)
_SCALE = dict(replicas=4, cluster_size=2, tau=2, consensus_every=1,
              gamma_d2d=1, lr=0.05)
_TCFG = dict(batch_per_replica=2, seq_len=8, intervals=2, eval_every=2,
             eval_batches=1)


def _scale_port(fused, trace_dir=None, w0=None):
    tr = ScaleTrainer(get_arch("qwen1.5-0.5b").reduced(**_SCALE_CFG),
                      TTHFScaleConfig(**_SCALE),
                      TrainerConfig(fused_interval=fused,
                                    trace_dir=trace_dir, **_TCFG),
                      device="cpu")
    tr.init(w0=w0, draws=JaxScaleReplayDraws(0))
    tr.run()
    tr.close()
    return tr


def test_instrumented_scale_trainer_is_bare_and_matches_reference(
        tmp_path):
    jt = JScaleTrainer(j_get_arch("qwen1.5-0.5b").reduced(**_SCALE_CFG),
                       JTTHFScaleConfig(**_SCALE),
                       JTrainerConfig(trace_dir=str(tmp_path / "ref"),
                                      **_TCFG))
    w0 = params_from_jax(jax.tree.map(
        np.asarray, jt.model.init(jax.random.PRNGKey(0))), "cpu")
    jt.init().run()
    jt.close()
    want = _records(tmp_path / "ref")
    for fused in (False, True):
        d = tmp_path / f"port{int(fused)}"
        bare = _scale_port(fused, w0=w0)
        tr = _scale_port(fused, str(d), w0=w0)
        if fused:
            assert torch.equal(bare.params, tr.params)
        else:
            for a, b in zip(tree_leaves(bare.params),
                            tree_leaves(tr.params)):
                assert torch.equal(a, b)
        for key in ("train_loss", "eval_loss"):
            assert bare.metrics._recent[key] == tr.metrics._recent[key]
        got = _records(d)
        _assert_records_match(got, want)
        assert [r["kind"] for r in got] == \
            ["round", "comm", "round", "comm", "eval"]
        assert np.isfinite(got[-1]["grad_norm"])
        doc, jdoc = _trace(d), _trace(tmp_path / "ref")
        assert [(n, ph) for n, ph, _ in _shape(doc)] == \
            [(n, ph) for n, ph, _ in _shape(jdoc)]
        assert [a for _, ph, a in _shape(doc) if ph == "C"] == \
            [a for _, ph, a in _shape(jdoc) if ph == "C"]
        man = json.loads((d / "manifest.json").read_text())
        assert man["run"] == "train-scale" and man["sync"] == "tthf"


# ===========================================================================
# the serve CLI
# ===========================================================================

def test_serve_cli_request_records_match_reference(tmp_path, capsys):
    argv = ["--arch", "qwen1.5-0.5b", "--reduced", "--scheduler",
            "continuous", "--batch", "2", "--prompt-len", "16", "--gen",
            "4", "--requests", "4", "--temperature", "0"]
    assert j_serve_cli.main(argv + ["--trace-dir",
                                    str(tmp_path / "ref")]) == 0
    ref_out = capsys.readouterr().out.splitlines()
    assert serve_cli.main(argv + ["--device", "cpu"]) == 0
    bare_out = capsys.readouterr().out.splitlines()
    d = tmp_path / "port"
    assert serve_cli.main(argv + ["--device", "cpu", "--trace-dir",
                                  str(d)]) == 0
    got_out = capsys.readouterr().out.splitlines()

    def counts(lines):              # the summary without the rate
        return [l.split(" (")[0] for l in lines]
    assert counts(got_out) == counts(bare_out) == counts(ref_out)
    got, want = _records(d), _records(tmp_path / "ref")
    assert len(got) == 4 and {r["kind"] for r in got} == {"request"}
    _assert_records_match(got, want)
    doc = _trace(d)
    names = {e["name"] for e in doc["traceEvents"]}
    assert {"run", "admission", "decode_step", "prefill",
            "scheduler"} <= names
    man = json.loads((d / "manifest.json").read_text())
    assert man["run"] == "serve" and man["scheduler"] == "continuous"
