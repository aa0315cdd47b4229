"""Tiny cells for the benchmark's CPU tests: the cells' own files with
the sizes cut so that a test run holds them (the program takes the
plain versions of its kernels on the CPU)."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

from perfbench import harness  # noqa: E402
from perfbench.inputs import ssm_dims  # noqa: E402

CPU = torch.device("cpu")


def tiny_sim(traffic: str, limits: str) -> harness.Cell:
    cfg = harness.load_json(harness.HERE / "configs/tthf-sim-nn7840.json")
    m = cfg["model"]
    m["hidden"] = 64
    cfg["parameters_per_device"] = m["dim"] * 64 + 64 + 64 * 10 + 10
    cfg["data"]["points"] = 1000
    cfg["topology"].update(devices=20, clusters=4)
    return harness.Cell(
        name="tiny", config=cfg,
        traffic=harness.load_json(harness.HERE / f"traffic/{traffic}.json"),
        limits=harness.load_json(harness.HERE / f"limits/{limits}.json"),
        chips=1, end_to_end=[], per_layer=[])


def tiny_train(traffic: str = "tthf.r4.t2.b16x1024",
               limits: str = "train.mamba2-370m.tthf") -> harness.Cell:
    cfg = harness.load_json(harness.HERE / "configs/mamba2-370m.json")
    cfg["model"].update(num_layers=2, d_model=64, vocab_size=500,
                        vocab_rows=512, ssm_state_dim=16, ssm_head_dim=32,
                        ssm_num_heads=4, ssm_chunk=32)
    d, d_in, H, P, S, K, L = ssm_dims(cfg["model"])
    cfg["parameters"] = 512 * d + d + L * (
        d + d * (2 * d_in + 2 * S + H) + d_in * d + K * (d_in + 2 * S)
        + 3 * H)
    traffic = harness.load_json(harness.HERE / f"traffic/{traffic}.json")
    traffic.update(batch_per_replica=2, seq_len=64, trace_intervals=2)
    return harness.Cell(
        name="tiny", config=cfg, traffic=traffic,
        limits=harness.load_json(harness.HERE / f"limits/{limits}.json"),
        chips=1, end_to_end=[], per_layer=[])


@pytest.fixture
def sim_static():
    return tiny_sim("static", "sim.nn7840.static")


@pytest.fixture
def sim_churn():
    return tiny_sim("device_churn", "sim.nn7840.churn")


@pytest.fixture
def train():
    return tiny_train()


@pytest.fixture
def sync():
    """The traffic and limits kept for the cell ``train.mamba2-370m.sync``
    (not in ``BENCHMARK.json`` yet): a consensus after every step."""
    return tiny_train("tthf.r4.t2.c1.g4.b4x256", "train.mamba2-370m.sync")


@pytest.fixture
def card():
    """The CUDA device; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
