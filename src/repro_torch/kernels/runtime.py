"""Where the port runs: one device rule for every entry point.

The reference picks interpret mode off-TPU (``repro/kernels/runtime.py``).
The port's counterpart is the device: entry points run on ``cuda`` unless
the caller asks for another device by name. With no GPU and no explicit
request they raise — a run never carries on quietly on the CPU.

The dry run traces programs on fake tensors (shapes and dtypes, no
data). A kernel wrapper given one neither launches nor runs its plain
version: it returns a fake result of the right shape and charges its
work (:func:`charge`) to the cost recorders that listen
(``repro_torch.launch.cost``).
"""
from __future__ import annotations

import sys
from contextlib import contextmanager
from typing import Callable, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> the current CUDA device, or raise when there is none;
    an explicit device (``"cpu"``, ``"cuda:1"``) is taken as given."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: pass device='cpu' to run on "
            "the CPU explicitly")
    return torch.device("cuda", torch.cuda.current_device())


def is_fake(x) -> bool:
    """Is ``x`` a fake tensor (``torch._subclasses.FakeTensor``)? Nothing
    is fake before that module is imported, so a real run pays one dict
    lookup."""
    mod = sys.modules.get("torch._subclasses.fake_tensor")
    return mod is not None and isinstance(x, mod.FakeTensor)


# the cost recorders that take kernels' charges, innermost last
LISTENERS: list[Callable[[str, int, int], None]] = []
# the weight a cost recorder gives the ops it sees (see ``repeated``)
WEIGHT = [1]


@contextmanager
def repeated(n: int):
    """Count the ops run in this context ``n`` times: a loop on fake
    tensors whose iterations run the same ops on the same shapes is
    traced once and counted as all of them."""
    WEIGHT.append(WEIGHT[-1] * n)
    try:
        yield
    finally:
        WEIGHT.pop()


def charge(kernel: str, flops: int, bytes_moved: int) -> None:
    """A kernel's work on fake inputs: ``flops`` operations and
    ``bytes_moved`` bytes (each input read once, each output written
    once), to the innermost listener."""
    if LISTENERS:
        LISTENERS[-1](kernel, int(flops), int(bytes_moved))


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


__all__ = ["DeviceLike", "LISTENERS", "WEIGHT", "charge", "is_fake",
           "nbytes", "repeated", "resolve_device"]
