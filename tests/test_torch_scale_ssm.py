"""Scale-mode TT-HF of the port for the ssm kind, against the reference
on the CPU, with the helpers and configuration of
``tests/test_torch_scale.py`` (a file of its own, so that it runs beside
that one): a 2-layer mamba2 cut to d 64 (4 SSD heads of 32, state 32,
chunk 32: the 16-token sequences pad to one chunk, as the full model's
128 pad to 256), R 4 in clusters of 2, tau 4, consensus every 2, Γ 2,
lr 0.05. The training gradient goes through the plain chunked scan on
both sides. Loss rtol 1e-4, parameters atol 1e-5, the ledger exactly.
"""
import _torch_threads  # noqa: F401  (torch threads per xdist worker)
import re

import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.core import distributed as j_dist
from repro.launch import train as j_train_cli
from repro.models import build_model as j_build_model

from repro_torch.configs import get_arch
from repro_torch.core import distributed as dist
from repro_torch.launch import train as train_cli
from repro_torch.models import build_model

from test_torch_scale import (
    _check_scale_trainer, _max_err, _port_run, _reference_run)


@pytest.mark.parametrize("fused_interval", [False, True])
def test_ssm_step_matches_reference(fused_interval):
    """The ssm kind (reduced mamba2) through the per-leaf step and the
    fused interval (its kernel block-end's plain version on the CPU)
    against the reference's per-leaf step; the gradient goes through
    the plain chunked scan on both sides."""
    ref_leaves, ref_losses = _reference_run("tthf", "fused", arch="mamba2")
    leaves, losses = _port_run("tthf", "fused", arch="mamba2",
                               fused_interval=fused_interval)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)
    assert _max_err(leaves, ref_leaves) <= 1e-5
    assert len(leaves) == len(ref_leaves)


def test_ssm_flat_spec_equals_reference_at_full_width():
    """The full mamba2-370m's flat buffer: one f32 dtype over every leaf
    (A_log, D, dt_bias, conv and norm weights), 368,285,184 columns, a
    multiple of 128 already, so no pad."""
    ref = j_dist.FlatParamSpec.for_model(
        j_build_model(j_get_arch("mamba2-370m")))
    spec = dist.FlatParamSpec.for_model(build_model(get_arch("mamba2-370m")))
    assert spec.shapes == ref.shapes and spec.offsets == ref.offsets
    assert spec.dtype == torch.float32
    assert spec.total == spec.padded == ref.padded == 368_285_184


@pytest.mark.parametrize("fused_interval", [False, True])
def test_ssm_scale_trainer_matches_reference(fused_interval, capsys):
    _check_scale_trainer(fused_interval, capsys, "mamba2")


def test_scale_cli_summary_line_matches_reference_ssm(capsys):
    """``--arch mamba2-370m --reduced``: the same summary line and the
    same per-interval counts as the reference CLI (wall time and losses
    aside: each CLI starts from its own package's random weights)."""
    argv = ["--mode", "scale", "--arch", "mamba2-370m", "--reduced",
            "--steps", "2", "--tau", "2", "--consensus-every", "1",
            "--batch", "1", "--seq", "16"]
    assert j_train_cli.main(argv) == 0
    ref = capsys.readouterr().out.strip().splitlines()
    assert train_cli.main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out.strip().splitlines()
    strip = r"^\[\s*\S+s\] |train_loss=\S+ | wall=\S+s"
    assert [re.sub(strip, "", l) for l in got] == \
        [re.sub(strip, "", l) for l in ref]
    assert got[-1].startswith("intervals=2 ")
    assert "uplinks=4 L1=4 d2d_msgs=32 (tau=2 " in got[-1]
