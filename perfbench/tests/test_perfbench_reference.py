"""The reference and the program agree at a tiny size on the CPU: the
numbers ``correct`` is decided by stay far under the cells' limits, and
the communication counts are equal."""
import pytest

from perfbench.drivers import scale, sim
from perfbench.drivers.common import compare
from perfbench.harness import passed

from conftest import CPU

SEEDS = [7, 2**33 + 5]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("which", ["sim_static", "sim_churn"])
def test_sim_agrees(which, seed, request):
    cell = request.getfixturevalue(which)
    _, _, got, _ = sim.setup(cell, seed, CPU)
    chk = compare(got, sim.follow(cell, seed, CPU), cell.limits)
    assert passed(chk), chk
    assert chk["ledger_mismatch"]["value"] == 0
    for k in ("loss_gap", "grad_gap", "change_gap"):
        assert chk[k]["value"] <= cell.limits[k] / 10, chk
    assert got.ledger["local_steps"] > 0


def test_churn_darkens_devices(sim_churn):
    _, _, got, _ = sim.setup(sim_churn, SEEDS[0], CPU)
    steps = sim_churn.traffic["warmup_chunks"] \
        * sim_churn.config["schedule"]["tau"]
    assert got.ledger["local_steps"] < 20 * steps


@pytest.mark.parametrize("which", ["train", "sync"])
def test_train_agrees(which, request):
    cell = request.getfixturevalue(which)
    _, _, got = scale.setup(cell, SEEDS[1], CPU)
    chk = compare(got, scale.follow(cell, SEEDS[1], CPU), cell.limits)
    assert passed(chk), chk
    assert got.ledger["uplinks"] == 2 * cell.traffic["warmup_intervals"]
