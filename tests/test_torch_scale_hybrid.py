"""Scale-mode TT-HF of the port for the hybrid kind (recurrentgemma-9b),
against the reference on the CPU, with the helpers and configuration of
``tests/test_torch_scale.py``: a 5-layer recurrentgemma cut to d 64 (one
``(rec, rec, attn)`` group and a tail of two, the full model's
structure), its attention window 8 below the 16-token sequences, R 4 in
clusters of 2, tau 4, consensus every 2, Γ 2, lr 0.05. Then a hybrid
checkpoint's round trip and the scale CLI's summary line (the
ScaleTrainer and the divergence probe are in
``tests/test_torch_scale_hybrid_trainer.py``).

Tolerances: loss rtol 1e-4, parameters atol 1e-5, the ledger exactly
(as ``tests/test_torch_scale.py``); a checkpoint and a resumed run
exactly (a checkpoint moves bytes); the probe rtol 1e-5 (as
``tests/test_torch_obs.py``).
"""
import _torch_threads  # noqa: F401  (torch threads per xdist worker)
import dataclasses
import re

import jax
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
from repro_torch.models.common import tree_leaves
from repro_torch.train import ScaleTrainer, TrainerConfig

from test_torch_scale import (
    _ARCHS, _max_err, _port_run, _reference_run, _scale)

ARCH = "recurrentgemma-9b"


@pytest.mark.parametrize("fused_interval", [False, True])
def test_hybrid_step_matches_reference(fused_interval):
    """The per-leaf step and the fused interval (its kernel block-end's
    plain version on the CPU) over the hybrid tree against the
    reference's per-leaf step: the gradient through the RG-LRU scans and
    the local attention on both sides."""
    ref_leaves, ref_losses = _reference_run("tthf", "fused", arch="hybrid")
    leaves, losses = _port_run("tthf", "fused", arch="hybrid",
                               fused_interval=fused_interval)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)
    assert len(leaves) == len(ref_leaves)
    assert _max_err(leaves, ref_leaves) <= 1e-5


@pytest.mark.parametrize("num_layers", [5, 38])
def test_hybrid_flat_spec_equals_reference_at_full_width(num_layers):
    """The flat (R, P) carrier's leaves, in the reference's order
    (``groups`` then ``tail``), shapes and offsets at full width: depth 5
    (2,174,906,368 parameters a replica, the chip's scale cell) and the
    full 38 layers (9,396,301,824)."""
    def make(get):
        return dataclasses.replace(get(ARCH), num_layers=num_layers)
    ref = j_dist.FlatParamSpec.for_model(j_build_model(make(j_get_arch)))
    spec = dist.FlatParamSpec.for_model(build_model(make(get_arch)))
    assert spec.shapes == ref.shapes and spec.offsets == ref.offsets
    assert spec.padded == ref.padded and spec.dtype == torch.float32
    assert spec.total == {5: 2_174_906_368, 38: 9_396_301_824}[num_layers]


def _trainer(tmp_path, fused, **kw):
    return ScaleTrainer(
        _ARCHS["hybrid"][1], _scale(dist.TTHFScaleConfig, tau=2),
        TrainerConfig(batch_per_replica=1, seq_len=16, intervals=3,
                      eval_every=3, eval_batches=1, fused_interval=fused,
                      ckpt_dir=str(tmp_path), **kw), device="cpu")


@pytest.mark.parametrize("fused", [False, True])
def test_hybrid_checkpoint_round_trip(tmp_path, fused):
    """The checkpoint of interval 2 restored into a fresh trainer runs
    interval 3 as the straight run does: parameters bitwise, losses and
    draw counters equal; the file holds the reference's tree (restored
    by the reference's trainer bitwise)."""
    from repro.core.distributed import TTHFScaleConfig as JTTHFScaleConfig
    from repro.train import ScaleTrainer as JScaleTrainer
    from repro.train import TrainerConfig as JTrainerConfig

    straight = _trainer(tmp_path / "s", fused).init()
    straight.run(3)
    first = _trainer(tmp_path, fused, ckpt_every=2).init()
    first.run(2)
    path = str(tmp_path / "interval_000002.npz")
    resumed = _trainer(tmp_path / "r", fused).restore(path)
    assert resumed.interval == 2
    resumed.run(1)
    a = [straight.params] if fused else tree_leaves(straight.params)
    b = [resumed.params] if fused else tree_leaves(resumed.params)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert list(straight.metrics._recent["train_loss"])[-1] == \
        list(resumed.metrics._recent["train_loss"])[-1]
    assert (straight._train_draws, straight._eval_draws) == \
        (resumed._train_draws, resumed._eval_draws)
    jt = JScaleTrainer(_ARCHS["hybrid"][0],
                       _scale(JTTHFScaleConfig, tau=2),
                       JTrainerConfig(batch_per_replica=1, seq_len=16,
                                      intervals=3, eval_every=3,
                                      eval_batches=1)).restore(path)
    params = first._spec.unflatten(first.params) if fused else first.params
    for x, y in zip(tree_leaves(params), jax.tree.leaves(jt.params)):
        assert x.numpy().tobytes() == np.asarray(y).tobytes()


def test_scale_cli_summary_line_matches_reference_hybrid(capsys):
    """``--arch recurrentgemma-9b --reduced``: the same summary line and
    per-interval counts as the reference CLI (wall time and losses
    aside: each CLI starts from its own package's random weights)."""
    argv = ["--mode", "scale", "--arch", ARCH, "--reduced", "--steps", "2",
            "--tau", "2", "--consensus-every", "1", "--batch", "1",
            "--seq", "16"]
    assert j_train_cli.main(argv) == 0
    ref = capsys.readouterr().out.strip().splitlines()
    assert train_cli.main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out.strip().splitlines()
    strip = r"^\[\s*\S+s\] |train_loss=\S+ | wall=\S+s"
    assert [re.sub(strip, "", l) for l in got] == \
        [re.sub(strip, "", l) for l in ref]
    assert got[-1].startswith("intervals=2 ")


