"""The port's checkpoints (``repro_torch.checkpoint`` and ``ScaleTrainer.
save``/``restore``) on the CPU: the reference's file format in both
directions, and save -> restore -> run equal to the straight run.

Everything here is held exactly: a checkpoint moves bytes, and a resumed
run repeats the straight run's arithmetic step for step (parameters
bitwise, losses and ledger counters equal).
"""
import _torch_threads  # noqa: F401  (torch threads per xdist worker)
import dataclasses

import jax
import numpy as np
import pytest
import torch

from _jax_draws import JaxScaleReplayDraws

from repro.checkpoint import restore_pytree as j_restore_pytree
from repro.checkpoint import save_pytree as j_save_pytree
from repro.configs import get_arch as j_get_arch
from repro.core.distributed import TTHFScaleConfig as JTTHFScaleConfig
from repro.train import ScaleTrainer as JScaleTrainer
from repro.train import TrainerConfig as JTrainerConfig

from repro_torch.checkpoint import (
    restore_pytree, restore_train_state, save_pytree)
from repro_torch.configs import get_arch
from repro_torch.core.distributed import TTHFScaleConfig
from repro_torch.core.sampling import TorchDraws
from repro_torch.hierarchy import presets
from repro_torch.models import params_from_jax
from repro_torch.models.common import tree_leaves
from repro_torch.rounds import RoundProgram
from repro_torch.train import ScaleTrainer, TrainerConfig


# ===========================================================================
# the file format
# ===========================================================================

def _tree():
    rng = np.random.default_rng(0)
    return {"w": {"b": rng.normal(size=(3, 4)).astype(np.float32),
                  "a": np.arange(5, dtype=np.int32)},
            "seq": [np.ones(2, np.float64), (np.asarray(7),
                                             np.zeros((0, 3), np.float32))],
            "step": np.asarray(3)}


def _assert_same(got, want):
    assert type(got) is type(want)
    if isinstance(want, dict):
        assert list(got) == sorted(want)
        for k in want:
            _assert_same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
    else:
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()


def test_format_crosses_both_ways_bitwise(tmp_path):
    tree = _tree()
    j_save_pytree(str(tmp_path / "ref"), tree)        # .npz appended
    _assert_same(restore_pytree(str(tmp_path / "ref")), tree)
    torch_tree = {"w": {"b": torch.from_numpy(tree["w"]["b"]),
                        "a": torch.from_numpy(tree["w"]["a"])},
                  "seq": tree["seq"], "step": tree["step"]}
    save_pytree(str(tmp_path / "port.npz"), torch_tree)
    _assert_same(j_restore_pytree(str(tmp_path / "port.npz")), tree)
    # the two files are the same: leaf names, leaf bytes and index
    with np.load(tmp_path / "ref.npz") as a, \
            np.load(tmp_path / "port.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            assert a[k].tobytes() == b[k].tobytes(), k


def test_save_copies_the_value_at_save_time(tmp_path):
    w = torch.ones(4)
    save_pytree(str(tmp_path / "s"), {"w": w})
    w.add_(1.0)                      # the step updates in place
    assert restore_pytree(str(tmp_path / "s"))["w"].tolist() == [1.0] * 4


# ===========================================================================
# ScaleTrainer: save -> restore -> run
# ===========================================================================

_CFG = dict(num_layers=1, d_model=32, d_ff=64, vocab_size=128)
_SCALE = dict(replicas=4, cluster_size=2, tau=2, consensus_every=2,
              gamma_d2d=1, lr=0.05)


def _trainer(tmp_path, fused, replicas=4, program=None, **kw):
    return ScaleTrainer(
        get_arch("qwen1.5-0.5b").reduced(**_CFG),
        TTHFScaleConfig(**dict(_SCALE, replicas=replicas)),
        TrainerConfig(batch_per_replica=2, seq_len=8, intervals=4,
                      eval_every=2, eval_batches=1, fused_interval=fused,
                      ckpt_dir=str(tmp_path), **kw),
        program=program, device="cpu")


def _params(tr):
    return [tr.params] if tr._spec is not None else tree_leaves(tr.params)


def _assert_equal_runs(a, b):
    for x, y in zip(_params(a), _params(b)):
        assert torch.equal(x, y)
    for key in ("train_loss", "eval_loss"):
        assert list(a.metrics._recent[key])[-1] == \
            list(b.metrics._recent[key])[-1]
    assert (a.interval, a._train_draws, a._eval_draws) == \
        (b.interval, b._train_draws, b._eval_draws)


@pytest.mark.parametrize("draws", ["torch", "replay"])
@pytest.mark.parametrize("fused", [False, True])
def test_resume_equals_straight_through_run(tmp_path, fused, draws):
    """The checkpoint of interval 2 (written by ``ckpt_every``) restored
    into a fresh trainer runs intervals 3-4 exactly as the straight run:
    parameters, losses, draw counters, the ledger's counters; then the
    in-process rollback of ``tests/test_trainer_fixes.py``."""
    def init(tr):
        return tr.init(draws=JaxScaleReplayDraws(0)
                       if draws == "replay" else None)

    straight = init(_trainer(tmp_path / "s", fused))
    straight.run(4)
    first = init(_trainer(tmp_path, fused, ckpt_every=2))
    first.run(2)
    path = str(tmp_path / "interval_000002.npz")
    resumed = _trainer(tmp_path / "r", fused)
    if draws == "replay":
        init(resumed)                # the source to load the key into
    resumed.restore(path)
    assert resumed.interval == 2
    assert isinstance(resumed.draws, TorchDraws) == (draws == "torch")
    if fused:
        assert not resumed.params[:, resumed._spec.total:].any()
    resumed.run(2)
    _assert_equal_runs(straight, resumed)
    sd = dataclasses.asdict(straight.ledger)
    rd = dataclasses.asdict(resumed.ledger)
    s_rows, r_rows = sd.pop("events"), rd.pop("events")
    assert sd == rd
    assert r_rows == s_rows[-len(r_rows):]

    # in-process rollback: the streams have advanced past the checkpoint
    first.run(1)
    first.restore(path)
    first.run(2)
    _assert_equal_runs(straight, first)


def test_restore_crosses_with_the_reference_trainer(tmp_path):
    """A reference trainer's checkpoint restores into the port (the
    parameters bitwise, the interval, the stream positions and the
    ledger's counters), and the port's into the reference."""
    jt = JScaleTrainer(j_get_arch("qwen1.5-0.5b").reduced(**_CFG),
                       JTTHFScaleConfig(**_SCALE),
                       JTrainerConfig(batch_per_replica=2, seq_len=8,
                                      intervals=2, eval_every=2,
                                      eval_batches=1))
    jt.init().run()
    ref_path = jt.save(str(tmp_path / "ref.npz"))
    for fused in (False, True):
        tr = _trainer(tmp_path, fused).restore(ref_path)
        assert tr.interval == 2
        assert (tr._train_draws, tr._eval_draws) == \
            (jt._train_draws, jt._eval_draws)
        for f in ("uplinks", "d2d_msgs", "d2d_rounds", "local_steps"):
            assert getattr(tr.ledger, f) == getattr(jt.ledger, f)
        assert tr.ledger.uplinks_by_level == jt.ledger.uplinks_by_level
        params = tr._spec.unflatten(tr.params) if fused else tr.params
        for a, b in zip(tree_leaves(params), jax.tree.leaves(jt.params)):
            assert a.numpy().tobytes() == np.asarray(b).tobytes()
        port_path = tr.save(str(tmp_path / f"port{int(fused)}"))
        back = JScaleTrainer(jt.cfg, jt.scale, jt.tcfg).restore(port_path)
        assert back.interval == 2
        for a, b in zip(jax.tree.leaves(back.params),
                        jax.tree.leaves(jt.params)):
            assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    _, _, step, extra = restore_train_state(port_path)
    assert step == 2 and set(extra) == {
        "draws", "train_draws", "eval_draws", "ledger", "uplinks_by_level"}


@pytest.mark.parametrize("fused", [False, True])
def test_hierarchical_resume_serves_the_restored_root_snapshot(tmp_path,
                                                                fused):
    """fog3 over 8 replicas: the root fires every 2 intervals. Resumed
    after interval 2, interval 3 serves the root's snapshot of interval
    2 (not replica 0), as the straight run does."""
    def program():
        return RoundProgram(hierarchy=presets.get("fog3", tau=2))

    straight = _trainer(tmp_path / "s", fused, 8, program()).init()
    straight.run(3)
    first = _trainer(tmp_path / "f", fused, 8, program()).init()
    first.run(2)
    path = first.save()
    resumed = _trainer(tmp_path / "r", fused, 8, program()).restore(path)
    resumed.run(1)
    for a, b in zip(_params(straight), _params(resumed)):
        assert torch.equal(a, b)
    served = tree_leaves(resumed._global_params())
    for a, b in zip(tree_leaves(straight._global_params()), served):
        assert torch.equal(a, b)
    assert not all(torch.equal(a, b) for a, b in
                   zip(served, tree_leaves(resumed._replica0())))
    assert resumed.ledger.uplinks_by_level == \
        straight.ledger.uplinks_by_level
