"""Every cell, configuration, traffic mix, limit set and per-layer
metric of BENCHMARK.json resolves by name to its own file, and the file
keeps to the benchmark's contract."""
import json
import re

import pytest

from perfbench import harness

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_workload_resolves(w):
    cell = harness.Cell.load(w["name"], BENCH)
    assert cell.chips == 1
    # the contract of a driver and, for the scale driver, of the model
    # plug-in of the configuration's model kind
    kind = cell.config["kind"]
    driver = harness.load_module(harness.HERE / "drivers" / f"{kind}.py",
                                 f"perfbench_driver_{kind}")
    for name in ("run", "setup", "follow"):
        assert callable(getattr(driver, name, None)), (kind, name)
    if kind == "scale":
        model = harness.model_plugin(cell.config)
        for name in ("model_config", "weights", "loss", "window_flops"):
            assert callable(getattr(model, name, None)), (
                cell.config["model"]["kind"], name)
    assert {"loss_gap", "ledger_mismatch"} <= set(cell.limits) <= {
        "loss_gap", "grad_gap", "change_gap", "grad_gap_median",
        "change_gap_median", "ledger_mismatch"}
    assert cell.limits["ledger_mismatch"] == 0
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer, "every cell reports a per-layer metric"
    for m in cell.per_layer:
        assert m["moves"] in names, (m["name"], m["moves"])
    assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    assert 1 <= len(w["why"]) <= 200


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_resolves(c):
    cfg = harness.load_json(harness.ROOT / c["file"])
    assert cfg["name"] == c["name"]
    assert cfg["reduced"] == c["reduced"]
    for key in c["reduced"]:
        assert key in cfg and not key.endswith(("_dim", "_rank")), key
    assert bool(c["reduced"]) == ("reduced_why" in cfg)
    assert cfg["dtype"] == "float32" and cfg["tf32"] is False
    assert c["file"].startswith("perfbench/configs/")
    assert any(w["config"] == c["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    if m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        reader = harness.load_module(
            harness.HERE / "metrics" / f"{m['name']}.py", "reader")
        assert callable(reader.read)
        assert reader.read({"kind": "none"}, None, None) is None
        assert set(m["workloads"]) <= {w["name"] for w in
                                       BENCH["workloads"]}
