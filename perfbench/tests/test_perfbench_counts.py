"""The frozen formulas against the bounds the kernel table records:
``consensus_mix`` at (25, 5, 6,146,560) and ``fused_consensus_sgd`` at
mamba2's (2, 2, 368,285,184), f32, at 3.35 TB/s."""
import pytest

from perfbench import harness
from perfbench.counts import (consensus_mix, fused_consensus_sgd,
                              mamba2_train, peaks, sim_step)


def test_consensus_mix_bound():
    ms = consensus_mix.call_bytes(25, 5, 6_146_560) \
        / peaks.HBM_BYTES_PER_S * 1e3
    assert ms == pytest.approx(1.835, abs=5e-4)


def test_fused_consensus_sgd_bound():
    ms = fused_consensus_sgd.call_bytes(2, 2, 368_285_184) \
        / peaks.HBM_BYTES_PER_S * 1e3
    assert ms == pytest.approx(5.277, abs=5e-4)


def test_mamba2_counts():
    cfg = harness.load_json(harness.HERE / "configs/mamba2-370m.json")
    m = cfg["model"]
    # the weights of the products: all but the convolutions, the norms
    # and the per-head A, D and dt bias
    rest = m["num_layers"] * (4 * (2048 + 256) + 1024 + 3 * 32) + 1024
    assert mamba2_train.matmul_weights(m) + rest == cfg["parameters"]
    assert mamba2_train.flops_per_token(m) == pytest.approx(2.5208e9,
                                                            rel=1e-4)


def test_sim_counts():
    cfg = harness.load_json(harness.HERE / "configs/tthf-sim-nn7840.json")
    d = sim_step.dims(cfg)
    assert d["P"] == cfg["parameters_per_device"]
    flops, nbytes = sim_step.window_work(cfg, 1, 0, 0, 0)
    assert flops == 6 * 125 * 16 * (784 * 7840 + 7840 * 10)
    assert nbytes == 2 * 125 * d["P"] * 4 + 125 * 16 * 785 * 4
