"""The check's control and its faults come out not correct.

* The control: the reference in the next precision below the
  configuration's (TF32 products for float32 with TF32 off), put in the
  program's place, at a size a test run holds (on the CPU the operands
  are rounded to TF32). The card's readings at the cells' own sizes come
  from ``perfbench/calibrate.py`` (``test_control_fails_on_card``).
* The faults: a run of each tiny cell with the timed path broken
  underneath (the program patched): a step that returns its state
  unchanged; half of every minibatch left out, the mean taken over the
  rest; the D2D exchange left out. ``correct`` comes out false.
"""
import time

import pytest

from perfbench.drivers import scale, sim
from perfbench.drivers.common import Run, compare
from perfbench.harness import passed

from conftest import CPU


@pytest.mark.parametrize("which", ["sim_static", "sim_churn", "train",
                                   "sync"])
def test_control_fails(which, request):
    cell = request.getfixturevalue(which)
    drv = sim if which.startswith("sim") else scale
    seed = 11
    ref = drv.follow(cell, seed, CPU)
    chk = compare(drv.follow(cell, seed, CPU, prec="tf32"), ref,
                  cell.limits)
    assert not passed(chk), chk


def _unchanged_sim(mp):
    from repro_torch.core.tthf import TTHFTrainer
    mp.setattr(TTHFTrainer, "_local_step", lambda self, *a, **k: None)


def _half_sim(mp):
    from repro_torch.core.tthf import TTHFTrainer
    real = TTHFTrainer._local_step

    def half(self, params, idx, eta, dark=None):
        return real(self, params, idx[:, :idx.shape[1] // 2], eta, dark)
    mp.setattr(TTHFTrainer, "_local_step", half)


def _no_exchange_sim(mp):
    from repro_torch.core import mixing
    mp.setattr(mixing, "mix_pytree", lambda params, *a, **k: dict(params))


def _unchanged_train(mp):
    from repro_torch.train import trainer
    real = trainer.make_tthf_train_step

    def build(*a, **k):
        step, net = real(*a, **k)

        def unchanged(params, *b, **c):
            keep = params.clone()
            return keep, step(params, *b, **c)[1]
        unchanged.spec = step.spec
        return unchanged, net
    mp.setattr(trainer, "make_tthf_train_step", build)


def _half_train(mp):
    from repro_torch.core import distributed
    mp.setattr(distributed, "_replica", lambda mb, r: {
        k: v[r][:v.shape[1] // 2] for k, v in mb.items()})


def _no_exchange_train(mp):
    from repro_torch.core import distributed
    mp.setattr(distributed, "fused_consensus_sgd",
               lambda w, g, W, lr: w - lr.to(w.dtype) * g)


FAULTS = {"sim_static": [_unchanged_sim, _half_sim, _no_exchange_sim],
          "train": [_unchanged_train, _half_train, _no_exchange_train],
          "sync": [_unchanged_train, _half_train, _no_exchange_train]}


@pytest.mark.parametrize("which,fault", [
    (w, f) for w, fs in FAULTS.items() for f in fs],
    ids=lambda x: x if isinstance(x, str) else x.__name__)
def test_fault_is_caught(which, fault, request, monkeypatch):
    cell = request.getfixturevalue(which)
    fault(monkeypatch)
    drv = sim if which.startswith("sim") else scale
    out = drv.run(Run(cell=cell, seed=5, seconds=0.1, trace=False,
                      device=CPU, t_start=time.perf_counter()))
    assert not passed(out.checks), out.checks


@pytest.mark.cuda
def test_control_fails_on_card(card):
    """The static sim cell at its own size: the TF32 control fails."""
    from perfbench import harness
    cell = harness.Cell.load("sim.nn7840.static")
    seed = 2**31 + 77
    ref = sim.follow(cell, seed, card)
    chk = compare(sim.follow(cell, seed, card, prec="tf32"), ref,
                  cell.limits)
    assert not passed(chk), chk
