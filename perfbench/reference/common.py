"""What the references share: matrix products in a stated precision, and
the per-leaf norms of a change that the comparison reads."""
from __future__ import annotations

import contextlib

import torch


def to_tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to TF32 (10 mantissa bits, round to nearest)."""
    i = t.float().contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


@contextlib.contextmanager
def precision(name: str):
    """``"highest"``: float32 products; ``"tf32"``: TF32 tensor-core
    products on the card. On the CPU :func:`mm` rounds the operands to
    TF32 instead."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    tf32 = name == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def mm(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    """a @ b (batched where the operands are) in ``prec``. On the CPU,
    TF32 rounds the operands of the forward product (the gradient passes
    through the rounding unchanged)."""
    if prec == "tf32" and a.device.type == "cpu":
        a = a + (to_tf32(a) - a).detach()
        b = b + (to_tf32(b) - b).detach()
    return a @ b


def change_norms(now: dict, before: dict, rows: int = 8) -> dict:
    """{leaf name: ||now - before||} in float64, ``rows`` leading rows at a
    time (a leaf can be gigabytes)."""
    out = {}
    for k, v in now.items():
        b = before[k]
        if b.shape != v.shape:
            b = b.expand(v.shape)
        acc = 0.0
        for i in range(0, v.shape[0], rows):
            acc += float((v[i:i + rows].double()
                          - b[i:i + rows].double()).square().sum())
        out[k] = acc ** 0.5
    return out
