"""The scale driver's model plug-ins (``models/<kind>.py``).

* A configuration whose ``model.kind`` names a plug-in that only this
  test provides runs through ``drivers/scale.py``'s ``setup`` and ``follow`` and
  passes ``compare``: a further model needs new files only.
* The ``ssm`` plug-in reads what the benchmark read before the scale
  driver took plug-ins: its ``window_flops`` is ``counts/mamba2_train.py``'s,
  and the tiny training cell's weights, reference losses and change
  norms are bitwise those read on the commit before the split (the
  literals below), the control's and the faults' too (digests).
"""
import hashlib
import json
import shutil
import sys

import pytest

from perfbench import harness, inputs
from perfbench.counts import mamba2_train
from perfbench.drivers import scale
from perfbench.drivers.common import compare
from perfbench.harness import passed

from conftest import CPU

# read with drivers/scale.py before the split, on the tiny training cell
# (conftest.tiny_train) on the CPU
PARENT = {
    7: {
        "losses": [6.235106468200684, 6.249881267547607],
        "first": {
            "embed": 0.00214576572012885,
            "layers.ln.scale": 3.7295699886990215e-05,
            "layers.ssm.A_log": 3.7331170561720663e-10,
            "layers.ssm.D": 2.6612589486090995e-05,
            "layers.ssm.conv_B": 1.815068355961552e-06,
            "layers.ssm.conv_C": 1.6363628019494678e-06,
            "layers.ssm.conv_x": 0.0002963878753722427,
            "layers.ssm.dt_bias": 2.384185791015625e-07,
            "layers.ssm.w_in": 0.0003391185283605702,
            "layers.ssm.w_out": 0.0003306414945391065,
            "ln_final.scale": 2.1363344947361574e-05},
        "last": {
            "embed": 0.003074633638201503,
            "layers.ln.scale": 5.828229618846218e-05,
            "layers.ssm.A_log": 5.700738120025764e-10,
            "layers.ssm.D": 3.992901762677801e-05,
            "layers.ssm.conv_B": 2.090453777537516e-06,
            "layers.ssm.conv_C": 2.142844647820575e-06,
            "layers.ssm.conv_x": 0.0004401652247376584,
            "layers.ssm.dt_bias": 2.384185791015625e-07,
            "layers.ssm.w_in": 0.0004839058742120766,
            "layers.ssm.w_out": 0.0004771867560422821,
            "ln_final.scale": 4.3012168036260315e-05},
        "weights_sha256": "54d47ba215f1816c4c419685dd42d7a1"
                          "8666b40b3a504afa281200178cc922ee"},
    2**33 + 5: {
        "losses": [6.240309715270996, 6.25041389465332],
        "first": {
            "embed": 0.0021530190865676696,
            "layers.ln.scale": 4.436577431045363e-05,
            "layers.ssm.A_log": 3.5193116637103225e-11,
            "layers.ssm.D": 2.902030122150727e-05,
            "layers.ssm.conv_B": 1.4957624244518703e-06,
            "layers.ssm.conv_C": 1.402544723638507e-06,
            "layers.ssm.conv_x": 0.0003245933337937074,
            "layers.ssm.dt_bias": 4.1295309247228556e-07,
            "layers.ssm.w_in": 0.0003368104435810357,
            "layers.ssm.w_out": 0.0003195584723216039,
            "ln_final.scale": 2.275360854291848e-05},
        "last": {
            "embed": 0.003084639952837829,
            "layers.ln.scale": 6.2031759887608e-05,
            "layers.ssm.A_log": 5.733353608544878e-10,
            "layers.ssm.D": 3.7097750868029456e-05,
            "layers.ssm.conv_B": 1.9389078654311913e-06,
            "layers.ssm.conv_C": 2.0150059335879285e-06,
            "layers.ssm.conv_x": 0.000450787982131704,
            "layers.ssm.dt_bias": 4.76837158203125e-07,
            "layers.ssm.w_in": 0.0004744434900626569,
            "layers.ssm.w_out": 0.0004634990314661152,
            "ln_final.scale": 3.504474608551117e-05},
        "weights_sha256": "07ff1d6a41e9ee8e9505b8c4f07a6b1b"
                          "7b54bcc618531269fd0af419a09e2027"},
}
LEDGER = {"uplinks": 4, "d2d_msgs": 16, "d2d_rounds": 8, "local_steps": 16}
# seed 7's control and faults, as :func:`_digest` reads them
PARENT_DIGESTS = {("highest", "half_batch"): "116499e55aff3f5f",
                  ("highest", "no_consensus"): "40d35ae9451c9764",
                  ("tf32", None): "58b27c1c360db046"}
# the model operations of one interval of the full mamba2-370m
PARENT_FLOPS = {"tthf.r4.t2.b16x1024": 330407539113984.0,
                "tthf.r4.t2.c1.g4.b4x256": 20650471194624.0}


def _digest(f) -> str:
    return hashlib.sha256(json.dumps(
        [[repr(x) for x in f.losses],
         sorted((k, repr(v)) for k, v in f.first.items()),
         sorted((k, repr(v)) for k, v in f.last.items()),
         sorted(f.ledger.items())]).encode()).hexdigest()[:16]


def _weights_sha256(tree) -> str:
    h = hashlib.sha256()
    for path, v in inputs.tree_items(tree):
        h.update(".".join(path).encode())
        h.update(v.contiguous().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("seed", sorted(PARENT))
def test_ssm_reference_reads_as_before_the_split(seed, train):
    want = PARENT[seed]
    model = harness.model_plugin(train.config)
    assert _weights_sha256(model.weights(train.config, seed, CPU)) \
        == want["weights_sha256"]
    got = scale.follow(train, seed, CPU)
    assert got.losses == want["losses"]
    assert got.first == want["first"]
    assert got.last == want["last"]
    assert got.ledger == LEDGER


@pytest.mark.parametrize("prec,fault", sorted(PARENT_DIGESTS, key=str))
def test_ssm_control_and_faults_read_as_before_the_split(prec, fault,
                                                         train):
    got = scale.follow(train, 7, CPU, prec=prec, fault=fault)
    assert _digest(got) == PARENT_DIGESTS[(prec, fault)]


@pytest.mark.parametrize("traffic", sorted(PARENT_FLOPS))
def test_ssm_window_flops_are_the_frozen_count(traffic):
    cfg = harness.load_json(harness.HERE / "configs/mamba2-370m.json")
    tr = harness.load_json(harness.HERE / f"traffic/{traffic}.json")
    model = harness.model_plugin(cfg)
    for k in (1, 3):
        assert model.window_flops(cfg, tr, k, {"kind": "scale"}) \
            == mamba2_train.window_flops(cfg, tr, k) \
            == k * PARENT_FLOPS[traffic]


def test_a_model_kind_needs_only_its_plug_in(train, tmp_path,
                                             monkeypatch):
    """A copy of the ``ssm`` plug-in under another name, in a directory
    of its own that the loader is pointed at, drives the scale driver
    with no edit to it."""
    shutil.copy(harness.MODELS / "ssm.py", tmp_path / "foreign.py")
    monkeypatch.setattr(harness, "MODELS", tmp_path)
    monkeypatch.delitem(sys.modules, "perfbench_model_ssm", raising=False)
    train.config["model"]["kind"] = "foreign"
    seed = 2**31 + 3
    _, _, got = scale.setup(train, seed, CPU)
    chk = compare(got, scale.follow(train, seed, CPU), train.limits)
    assert passed(chk), chk
    assert sys.modules["perfbench_model_foreign"].__file__ \
        == str(tmp_path / "foreign.py")
    assert "perfbench_model_ssm" not in sys.modules
