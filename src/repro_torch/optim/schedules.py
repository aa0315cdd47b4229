"""Step-size schedules. ``paper_schedule`` is the paper's
eta_t = gamma / (t + alpha) (Theorem 2). Each returns a function of the
iteration that gives a float32 0-d tensor, as the reference gives a
float32 scalar."""
from __future__ import annotations

import math

import torch


def _f32(t) -> torch.Tensor:
    return torch.as_tensor(t, dtype=torch.float32)


def paper_schedule(gamma: float, alpha: float):
    """eta_t = gamma / (t + alpha)  (Proposition 1 / Theorem 2)."""
    def eta(t):
        # a true float32 division (a Python scalar over a tensor would
        # multiply by the reciprocal and round differently)
        return _f32(gamma) / (_f32(t) + alpha)
    return eta


def constant(lr: float):
    def eta(t):
        return torch.full((), lr, dtype=torch.float32)
    return eta


def cosine(peak: float, total_steps: int, floor: float = 0.0):
    def eta(t):
        frac = torch.clamp(_f32(t) / total_steps, 0.0, 1.0)
        return floor + 0.5 * (peak - floor) * (1 + torch.cos(math.pi * frac))
    return eta


def warmup_cosine(peak: float, warmup: int, total_steps: int,
                  floor: float = 0.0):
    cos = cosine(peak, max(total_steps - warmup, 1), floor)

    def eta(t):
        t = _f32(t)
        w = peak * t / max(warmup, 1)
        return torch.where(t < warmup, w, cos(t - warmup))
    return eta
