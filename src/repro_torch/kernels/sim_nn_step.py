"""The simulation's local SGD step of the one-hidden-layer network — two
Hopper kernels and their plain versions.

:func:`sim_nn_step` runs one SGD iteration (eqs. 8-9) of
:func:`repro_torch.models.simple.nn` for every device of the fleet, in
place, from the closed-form gradient of the per-device loss
``mean_b nll(relu(x W1 + b1) W2 + b2) + (reg/2)(|W1|^2 + |W2|^2)``:

1. :func:`sim_nn_forward`: ``H = relu(X W1 + b1)`` and the logits
   ``H W2 + b2``, one read of w1 (the kernel sums ``H W2`` over each
   column tile in its epilogue; the tiles' shares are summed here).
2. The backward to ``dH``, plain ``torch.bmm`` and elementwise calls on
   ``(I, B, hidden)`` tensors, through the ops autograd's backward runs:
   ``dlogits = (softmax - onehot) / B``, ``dW2 = H^T dlogits + reg W2``,
   ``db2``, ``dH = dlogits W2^T`` where ``H > 0``, ``db1 = sum_b dH``.
   On the CPU the plain step is bitwise the autograd path's.
3. :func:`sim_nn_update`: ``W1 <- W1 - eta (X^T dH + reg W1)`` in place,
   one read and one write of w1, with no gradient buffer.
4. ``w2``, ``b1`` and ``b2`` take the update arithmetic of the autograd
   path (``g * eta``, the dark rows filled with zeros, ``p - g``).

Neither kernel replaces a TPU kernel: the reference leaves the step to
XLA inside ``vmap(grad(loss))``. They were added because autograd's
backward and the update's elementwise passes took some 22 passes over
the fleet's 3.07 GB w1 a step where the step needs three. The source
note in ``csrc/sim_nn_step.cu`` gives the design. Bounds on an H100 SXM
at ``(I, B, m, hidden) = (125, 16, 784, 7840)``: the forward reads w1
once, 0.917 ms at 3.35 TB/s; the update reads and writes it, 1.835 ms.

A dark device (``dark[i]``, netsim churn) takes no step: its rows of H
are zeros, its w1 is not loaded, and its other leaves' updates are
filled with zeros, so its parameters stay bitwise as they were and a
non-finite value in its minibatch cannot reach them.

A kernel launch takes a batch tile of at most ``BATCH_TILE`` (16) rows,
the sim path's minibatch. A larger minibatch runs tile by tile, each
tile one more pass over w1: the forward's tiles are independent rows of
H, and the update takes the L2 term with the first tile and the other
tiles' ``x^T dH`` after it (the same sum, rounded once a tile). On the
card the kernels take a hidden width that is a multiple of 4 (a thread
owns one float4 of columns): :func:`sim_nn_step_check` refuses any other
before a run starts.

Each wrapper takes its plain version for CPU tensors and launches its
kernel for CUDA tensors (or raises: there is no fallback); on fake
tensors (the dry run) it launches nothing and charges its work.
``sim_nn_forward.launches`` and ``sim_nn_update.launches`` count
kernel launches (one a call at the sim path's minibatch of 16).
"""
from __future__ import annotations

import ctypes
from typing import Callable, Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.runtime import charge, is_fake, nbytes

BATCH_TILE = 16                # kBatchTile in csrc/sim_nn_step.cu
_COLS = 512                    # a column tile: kThreads x one float4
_MAX_DEVICES = 65_535          # the kernels' grid.y / grid.z


def sim_nn_forward_plain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                         w2: torch.Tensor, b2: torch.Tensor,
                         live: Optional[torch.Tensor] = None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (I, B, m), w1 (I, m, h), b1 (I, h), w2 (I, h, C), b2 (I, C) ->
    ``H = relu(x w1 + b1)`` (I, B, h), zeros on the devices that are not
    ``live``, and the logits ``H w2 + b2`` (I, B, C)."""
    h = torch.relu(torch.bmm(x, w1) + b1[:, None, :])
    if live is not None:
        h = torch.where(live[:, None, None], h, 0.0)
    return h, torch.bmm(h, w2) + b2[:, None, :]


def sim_nn_update_plain(w1: torch.Tensor, x: torch.Tensor, dh: torch.Tensor,
                        eta: float, reg: float,
                        live: Optional[torch.Tensor] = None) -> None:
    """In place: ``w1 <- w1 - eta (x^T dh + reg w1)`` on the ``live``
    devices, rounded as the autograd path rounds it."""
    g = torch.bmm(x.transpose(1, 2), dh) + reg * w1
    g.mul_(eta)
    if live is not None:
        g.masked_fill_(~live[:, None, None], 0)
    w1.sub_(g)


def _library() -> ctypes.CDLL:
    lib = build.load("sim_nn_step")
    lib.sim_nn_forward_f32.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.sim_nn_update_f32.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_float] * 2 + [ctypes.c_int] * 4
        + [ctypes.c_void_p])
    for fn in (lib.sim_nn_forward_f32, lib.sim_nn_update_f32):
        fn.restype = ctypes.c_int
    return lib


def _check(x: torch.Tensor, w1: torch.Tensor, other: torch.Tensor,
           other_shape: tuple, name: str,
           live: Optional[torch.Tensor]) -> None:
    if x.ndim != 3 or w1.ndim != 3:
        raise ValueError(f"x must be (I, B, m) and w1 (I, m, h), got "
                         f"{tuple(x.shape)} and {tuple(w1.shape)}")
    I, B, m = x.shape
    if w1.shape[:2] != (I, m):
        raise ValueError(f"w1 must be ({I}, {m}, h), got {tuple(w1.shape)}")
    if tuple(other.shape) != other_shape:
        raise ValueError(f"{name} must be {other_shape}, got "
                         f"{tuple(other.shape)}")
    for t in (x, w1, other):
        if t.dtype != torch.float32:
            raise TypeError(f"the sim step runs in float32, got {t.dtype}")
        if t.device != w1.device:
            raise ValueError(f"every input must be on {w1.device}, one is "
                             f"on {t.device}")
    if live is not None and (live.dtype != torch.bool
                             or tuple(live.shape) != (I,)
                             or live.device != w1.device
                             or not live.is_contiguous()):
        raise ValueError(f"live must be a contiguous ({I},) bool tensor on "
                         f"{w1.device}")


def sim_nn_step_check(hidden: int, device) -> None:
    """Raises unless :func:`sim_nn_step` can run a network of this hidden
    width on ``device``: on the card the kernels take a multiple of 4 (a
    thread owns one float4 of columns); the CPU's plain versions take any.
    The trainer calls it when it is built, so no run stops half way."""
    if torch.device(device).type == "cuda" and hidden % 4:
        raise ValueError(
            f"nn's fused step on the card needs a hidden width that is a "
            f"multiple of 4, got {hidden}; pick one, or train through "
            f"autograd (use_kernel=False)")


def _cuda_ready(name: str, x: torch.Tensor, w1: torch.Tensor,
                *tensors: torch.Tensor) -> None:
    """What the kernels need: contiguous inputs on the card, a grid the
    card takes, hidden a multiple of 4 and w1 16-byte aligned."""
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {x.device}")
    if x.shape[0] > _MAX_DEVICES:
        raise ValueError(f"{x.shape[0]} devices exceed the kernel's "
                         f"{_MAX_DEVICES}")
    if not all(t.is_contiguous() for t in (x, w1) + tensors):
        raise ValueError(f"{name} needs contiguous inputs")
    sim_nn_step_check(w1.shape[-1], w1.device)
    if w1.data_ptr() % 16:
        raise ValueError(f"{name} needs w1 16-byte aligned")


def _live_ptr(live: Optional[torch.Tensor]) -> Optional[int]:
    return None if live is None else live.data_ptr()


def _batch_tiles(*tensors: torch.Tensor):
    """Each tensor's rows (dim 1) in tiles of ``BATCH_TILE``, each tile
    contiguous (the whole tensor where it fits in one)."""
    B = tensors[0].shape[1]
    for b0 in range(0, B, BATCH_TILE):
        yield tuple(t if B <= BATCH_TILE else
                    t[:, b0:b0 + BATCH_TILE].contiguous() for t in tensors)


def sim_nn_forward(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                   w2: torch.Tensor, b2: torch.Tensor,
                   live: Optional[torch.Tensor] = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (I, B, m), w1 (I, m, h), b1 (I, h), w2 (I, h, C), b2 (I, C)
    float32; live: None or (I,) bool -> ``H = relu(x w1 + b1)`` (I, B, h),
    zeros on dark devices, and the logits ``H w2 + b2`` (I, B, C).

    CPU tensors take :func:`sim_nn_forward_plain`; CUDA tensors launch
    ``sim_nn_forward_kernel`` once a tile of ``BATCH_TILE`` rows
    (contiguous inputs, h a multiple of 4), which writes the tile's H and
    each column tile's share of ``H w2``; the shares are summed here."""
    I, B, m = x.shape
    hid = w1.shape[-1]
    _check(x, w1, b1, (I, hid), "b1", live)
    if w2.ndim != 3 or w2.shape[:2] != (I, hid) \
            or tuple(b2.shape) != (I, w2.shape[-1]):
        raise ValueError(f"w2 must be ({I}, {hid}, C) and b2 ({I}, C), got "
                         f"{tuple(w2.shape)} and {tuple(b2.shape)}")
    C = w2.shape[-1]
    if is_fake(w1):
        h, logits = x.new_empty((I, B, hid)), x.new_empty((I, B, C))
        charge("sim_nn_forward", 2 * I * B * (m + C) * hid,
               nbytes(x, b1, w2, b2, h, logits)
               + -(-B // BATCH_TILE) * nbytes(w1))
        return h, logits
    if w1.device.type == "cpu":
        return sim_nn_forward_plain(x, w1, b1, w2, b2, live)
    _cuda_ready("sim_nn_forward", x, w1, b1, w2, b2)
    hs, logits = [], []
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        for (xt,) in _batch_tiles(x):
            bt = xt.shape[1]
            h = torch.empty((I, bt, hid), dtype=x.dtype, device=x.device)
            part = torch.empty((I, -(-hid // _COLS), bt, C), dtype=x.dtype,
                               device=x.device)
            err = _library().sim_nn_forward_f32(
                xt.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                _live_ptr(live), h.data_ptr(), part.data_ptr(), I, bt, m,
                hid, C, stream)
            if err != 0:
                raise RuntimeError(f"sim_nn_forward kernel launch failed "
                                   f"with CUDA error {err}")
            sim_nn_forward.launches += 1
            hs.append(h)
            logits.append(part.sum(dim=1))
    if len(hs) > 1:
        hs, logits = [torch.cat(hs, dim=1)], [torch.cat(logits, dim=1)]
    return hs[0], logits[0] + b2[:, None, :]


def sim_nn_update(w1: torch.Tensor, x: torch.Tensor, dh: torch.Tensor,
                  eta: float, reg: float,
                  live: Optional[torch.Tensor] = None) -> None:
    """In place: ``w1 <- w1 - eta (x^T dh + reg w1)`` on the live devices.
    w1 (I, m, h), x (I, B, m), dh (I, B, h) float32; eta and reg host
    floats; live: None or (I,) bool (a dark device's w1 is not touched).

    CPU tensors take :func:`sim_nn_update_plain`; CUDA tensors launch
    ``sim_nn_update_kernel`` once a tile of ``BATCH_TILE`` rows
    (contiguous inputs, h a multiple of 4): the first tile's launch takes
    the L2 term, the others ``x^T dh`` of their rows alone."""
    I, B, m = x.shape
    _check(x, w1, dh, (I, B, w1.shape[-1]), "dh", live)
    hid = w1.shape[-1]
    tiles = -(-B // BATCH_TILE)
    if is_fake(w1):
        charge("sim_nn_update", 2 * I * B * m * hid + 4 * tiles * I * m * hid,
               nbytes(x, dh) + 2 * tiles * nbytes(w1))
        return
    if w1.device.type == "cpu":
        sim_nn_update_plain(w1, x, dh, eta, reg, live)
        return
    _cuda_ready("sim_nn_update", x, w1, dh)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        for n, (xt, dht) in enumerate(_batch_tiles(x, dh)):
            if dht.data_ptr() % 16:
                raise ValueError("sim_nn_update needs dh 16-byte aligned")
            err = _library().sim_nn_update_f32(
                w1.data_ptr(), xt.data_ptr(), dht.data_ptr(),
                _live_ptr(live), float(eta), float(reg) if n == 0 else 0.0,
                I, xt.shape[1], m, hid, stream)
            if err != 0:
                raise RuntimeError(f"sim_nn_update kernel launch failed "
                                   f"with CUDA error {err}")
            sim_nn_update.launches += 1


sim_nn_forward.launches = 0
sim_nn_update.launches = 0


def _step(params: dict, x: torch.Tensor, y: torch.Tensor, eta: float,
          reg: float, dark: Optional[torch.Tensor], forward: Callable,
          update: Callable) -> None:
    live = None if dark is None else ~dark
    w2 = params["w2"]
    h, logits = forward(x, params["w1"], params["b1"], w2, params["b2"],
                        live)
    logp = torch.log_softmax(logits, dim=-1)
    # d(mean_b nll)/dlogits = (softmax - onehot) / B, through the op that
    # autograd's log_softmax backward runs, so it rounds as autograd does
    go = torch.zeros_like(logp).scatter_(2, y[..., None], -1.0 / y.shape[1])
    dl = torch._log_softmax_backward_data(go, logp, -1, logp.dtype)
    # relu's backward, as autograd runs it: zero where h <= 0
    dh = torch.ops.aten.threshold_backward(
        torch.bmm(dl, w2.transpose(1, 2)), h, 0)
    small = {"b1": dh.sum(dim=1), "b2": dl.sum(dim=1),
             "w2": torch.bmm(h.transpose(1, 2), dl) + reg * w2}
    update(params["w1"], x, dh, eta, reg, live)
    for k, g in small.items():
        g.mul_(eta)
        if dark is not None:
            g.masked_fill_(dark.view((-1,) + (1,) * (g.ndim - 1)), 0)
        params[k].sub_(g)


def sim_nn_step_plain(params: dict, x: torch.Tensor, y: torch.Tensor,
                      eta: float, reg: float,
                      dark: Optional[torch.Tensor] = None) -> None:
    """One SGD iteration of ``nn`` for every device, in place, from the
    closed-form gradient (no autograd). params: ``b1 (I, h)``, ``b2 (I,
    C)``, ``w1 (I, m, h)``, ``w2 (I, h, C)``; x (I, B, m); y (I, B)
    labels; dark: None or (I,) bool, the devices that take no step."""
    _step(params, x, y, eta, reg, dark, sim_nn_forward_plain,
          sim_nn_update_plain)


def sim_nn_step(params: dict, x: torch.Tensor, y: torch.Tensor, eta: float,
                reg: float, dark: Optional[torch.Tensor] = None) -> None:
    """:func:`sim_nn_step_plain` with the two w1 passes through the
    kernels (CUDA tensors) or their plain versions (CPU tensors)."""
    _step(params, x, y, eta, reg, dark, sim_nn_forward, sim_nn_update)


__all__ = ["BATCH_TILE", "sim_nn_forward", "sim_nn_forward_plain",
           "sim_nn_step", "sim_nn_step_check", "sim_nn_step_plain",
           "sim_nn_update", "sim_nn_update_plain"]
