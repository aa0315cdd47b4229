"""Simulation-mode models (paper Sec. IV-A) — the port of ``repro/
models/simple.py``, batched over the device axis.

* ``svm``: regularized (squared-hinge) multiclass SVM — mu-strongly
  convex + beta-smooth, the regime of Assumption 1 / Theorem 2.
* ``nn``: one-hidden-layer fully-connected network (paper: 7840 neurons).

Params are dicts of tensors. ``init(generator, device)`` returns ONE
model (leaves without a device axis). ``predict``/``loss`` take a fleet:
every leaf carries a leading device axis I, inputs are ``x (I, B, m)``
and ``y (I, B)``, and ``loss`` returns the (I,) per-device losses. The
reference's ``vmap(grad(loss))`` becomes :meth:`SimModel.grads`: one
autograd call on the summed per-device losses, whose gradient with
respect to device i's leaves is exactly the gradient of device i's loss.

``nn`` also has a fused ``step``: one SGD iteration of every device in
place from the closed-form gradient, its two passes over the fleet's w1
through the hand-written kernels of :mod:`repro_torch.kernels.
sim_nn_step` (their plain versions on the CPU). The trainer takes it
under ``use_kernel=True``, after ``step_check`` has said that the
kernels take the width on its device; ``svm`` has none (``step`` is
None).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.sim_nn_step import sim_nn_step, sim_nn_step_check
from repro_torch.models.common import params_from_jax


@dataclass(frozen=True)
class SimModel:
    init: Callable          # (generator, device) -> params (no device axis)
    loss: Callable          # (params, x, y) -> (I,) per-device losses
    predict: Callable       # (params, x) -> (I, B, C) scores
    reg: float
    name: str
    # (params, x, y, eta, dark) -> None: one SGD iteration of every device
    # in place, dark (I,) bool or None; None where the model has no fused
    # step
    step: Optional[Callable] = None
    # (device) -> None: raises where ``step`` cannot run on the device
    step_check: Optional[Callable] = None

    def accuracy(self, params: dict, x: torch.Tensor,
                 y: torch.Tensor) -> torch.Tensor:
        """Share of correct predictions over every device's points."""
        pred = torch.argmax(self.predict(params, x), dim=-1)
        return (pred == y).float().mean()

    def grads(self, params: dict, x: torch.Tensor,
              y: torch.Tensor) -> dict:
        """Per-device gradients of the per-device losses, leaves (I, ...)."""
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        losses = self.loss(leaves, x, y)
        grads = torch.autograd.grad(losses.sum(), list(leaves.values()))
        return dict(zip(leaves, grads))


def _linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """x (I, B, m) @ w (I, m, n) + b (I, n)."""
    return torch.bmm(x, w) + b[:, None, :]


def svm(dim: int, num_classes: int, reg: float = 0.1) -> SimModel:
    """Multiclass squared-hinge SVM with L2 regularization.

    loss = (1/B) sum_b sum_{c != y_b} max(0, 1 + s_c - s_y)^2 / C
           + (reg/2) ||W||^2
    """
    def init(generator, device):
        w = torch.randn((dim, num_classes), generator=generator,
                        device=device) * 0.01
        b = torch.zeros((num_classes,), device=device)
        return {"b": b, "w": w}

    def predict(params, x):
        return _linear(x, params["w"], params["b"])

    def loss(params, x, y):
        s = predict(params, x)                              # (I, B, C)
        C = s.shape[-1]
        sy = torch.gather(s, 2, y[..., None])               # (I, B, 1)
        margins = torch.clamp(1.0 + s - sy, min=0.0)
        margins = margins * (1 - F.one_hot(y, C).to(s.dtype))
        data = (margins ** 2).sum(dim=-1).mean(dim=-1) / C
        l2 = 0.5 * reg * ((params["w"] ** 2).sum(dim=(1, 2))
                          + (params["b"] ** 2).sum(dim=1))
        return data + l2

    return SimModel(init, loss, predict, reg, "svm")


def nn(dim: int, num_classes: int, hidden: int = 7840,
       reg: float = 1e-4) -> SimModel:
    """One-hidden-layer fully-connected net (paper: 7840 neurons)."""
    def init(generator, device):
        def normal(shape):
            return torch.randn(shape, generator=generator, device=device)
        return {
            "b1": torch.zeros((hidden,), device=device),
            "b2": torch.zeros((num_classes,), device=device),
            "w1": normal((dim, hidden)) * math.sqrt(2.0 / dim),
            "w2": normal((hidden, num_classes)) * math.sqrt(1.0 / hidden),
        }

    def predict(params, x):
        h = torch.relu(_linear(x, params["w1"], params["b1"]))
        return _linear(h, params["w2"], params["b2"])

    def loss(params, x, y):
        logp = torch.log_softmax(predict(params, x), dim=-1)
        nll = -torch.gather(logp, 2, y[..., None])[..., 0].mean(dim=-1)
        l2 = 0.5 * reg * ((params["w1"] ** 2).sum(dim=(1, 2))
                          + (params["w2"] ** 2).sum(dim=(1, 2)))
        return nll + l2

    def step(params, x, y, eta, dark=None):
        sim_nn_step(params, x, y, eta, reg, dark)

    def step_check(device):
        sim_nn_step_check(hidden, device)

    return SimModel(init, predict=predict, loss=loss, reg=reg, name="nn",
                    step=step, step_check=step_check)


def make_sim_model(name: str, dim: int, num_classes: int,
                   hidden: int = 7840) -> SimModel:
    if name == "svm":
        return svm(dim, num_classes)
    if name == "nn":
        return nn(dim, num_classes, hidden)
    raise ValueError(f"unknown sim model {name!r}")


__all__ = ["SimModel", "make_sim_model", "nn", "params_from_jax", "svm"]
