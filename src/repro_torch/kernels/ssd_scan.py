"""Mamba-2 SSD chunked scan from a zero state — the Hopper kernel and its
plain version.

:func:`ssd_scan` runs the SSD recurrence ``h_t = exp(loga_t) h_{t-1} +
dt_t B_t (x) x_t``, ``y_t = C_t h_t`` from ``h_0 = 0`` over rows of the
TPU kernel's layout (one row per batch element and head) and returns y
and the final state. It replaces the Pallas TPU kernel
``repro/kernels/ssd_scan.py::ssd_scan`` together with its padding
wrapper ``repro/kernels/ops.py::ssd_scan``: T is padded to a multiple of
``chunk`` with zeros (dt = loga = 0 freezes the state, so the final
state is exact) and y is trimmed. On a CUDA tensor it launches the
hand-written kernel of ``csrc/ssd_scan.cu`` (built for ``sm_90a`` at
first use by :mod:`repro_torch.kernels.build`); on a CPU tensor it runs
:func:`ssd_scan_plain`, which is :func:`ssd_chunked` (the model's plain
scan, kept here) with one head per row. There is no fallback from one to
the other: a CUDA tensor launches the kernel or raises.

The kernel is bound by its float32 operations, ``Q(Q+1)S + Q(Q+1)P +
4QSP`` per row and chunk (the causal halves of C Bᵀ and of M X, the
carried-state term and the state carry), at 67 TFLOP/s on an H100 SXM;
the source note in ``csrc/ssd_scan.cu`` gives the design. It is forward only, as the TPU
kernel (which has no VJP): the wrapper raises when a gradient is asked
for.

``ssd_scan.launches`` counts kernel launches (CPU calls do not count); a
caller resets it to 0 before a run it wants to read.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

P_TILE = 16                    # kPT in csrc/ssd_scan.cu: P is a multiple
MAX_STATE = 128                # kMaxState in csrc/ssd_scan.cu
_MAX_SMEM = 232_448            # a block's shared memory on an H100 (227 KB)
_ENTRY = {torch.float32: "ssd_scan_f32", torch.bfloat16: "ssd_scan_bf16"}


def smem_bytes(S: int, chunk: int) -> int:
    """The kernel's shared memory for state size S and chunk Q
    (``smem_floats`` in csrc/ssd_scan.cu)."""
    return 4 * (2 * 64 * (S + 4) + 64 * 65 + chunk * P_TILE + S * P_TILE
                + 4 * chunk)


def ssd_chunked(x, dt, loga, B, C, h0=None, chunk: int = 256):
    """Chunked SSD in torch ops (the same math as the ``ssd_scan``
    kernel, from any initial state).

    x: (b, T, H, P); dt/loga: (b, T, H); B/C: (b, T, S) (state shared
    across heads, per Mamba-2's single B/C group); h0: (b, H, S, P)
    (zeros if None). Returns (y: (b, T, H, P) in x's dtype, h: (b, H, S,
    P) float32)."""
    b, T, H, P = x.shape
    S = B.shape[-1]
    pad = (-T) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt, loga = F.pad(dt, (0, 0, 0, pad)), F.pad(loga, (0, 0, 0, pad))
        B, C = F.pad(B, (0, 0, 0, pad)), F.pad(C, (0, 0, 0, pad))
    h = (torch.zeros((b, H, S, P), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=x.device).tril()[None, :, :, None]
    ys = []
    for c0 in range(0, T + pad, chunk):
        sl = slice(c0, c0 + chunk)
        xc, dtc, lac, bc, cc = (t[:, sl].float() for t in (x, dt, loga, B, C))
        l = torch.cumsum(lac, dim=1)                          # (b, Q, H)
        # intra-chunk
        g = torch.einsum("bts,bus->btu", cc, bc)              # (b, Q, Q)
        # l is non-increasing, so causal (t >= u) exponents are <= 0;
        # clamping is exact there and keeps the non-causal entries
        # (discarded by the where) from overflowing exp in float32
        decay = torch.exp(torch.clamp(
            l[:, :, None, :] - l[:, None, :, :], max=0.0))    # (b, Q, Q, H)
        m = torch.where(causal, g[..., None] * decay * dtc[:, None, :, :],
                        0.0)
        y = torch.einsum("btuh,buhp->bthp", m, xc)
        # inter-chunk (carried state)
        cdec = cc[:, :, None, :] * torch.exp(l)[..., None]    # (b, Q, H, S)
        y = y + torch.einsum("bths,bhsp->bthp", cdec, h)
        # state update
        total = l[:, -1, :]                                   # (b, H)
        bdec = bc[:, :, None, :] * (torch.exp(total[:, None, :] - l)
                                    * dtc)[..., None]         # (b, Q, H, S)
        h = torch.exp(total)[..., None, None] * h + \
            torch.einsum("bths,bthp->bhsp", bdec, xc)
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :T]
    return y.to(x.dtype), h


def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, loga: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor, *, chunk: int = 256
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (BH, T, P); dt/loga: (BH, T); B/C: (BH, T, S) -> (y: (BH, T, P)
    in x's dtype, h_final: (BH, S, P) float32).

    :func:`ssd_chunked` with one head per row, from a zero state."""
    y, h = ssd_chunked(x[:, :, None], dt[..., None], loga[..., None], B, C,
                       chunk=chunk)
    return y[:, :, 0], h[:, 0]


def _library() -> ctypes.CDLL:
    lib = build.load("ssd_scan")
    for entry in _ENTRY.values():
        fn = getattr(lib, entry)
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check(x, dt, loga, B, C, chunk: int) -> None:
    if x.ndim != 3:
        raise ValueError(f"x must be (BH, T, P), got {tuple(x.shape)}")
    BH, T, _ = x.shape
    for name, t in (("dt", dt), ("loga", loga)):
        if tuple(t.shape) != (BH, T):
            raise ValueError(f"{name} must be ({BH}, {T}), got "
                             f"{tuple(t.shape)}")
    if B.ndim != 3 or tuple(B.shape[:2]) != (BH, T):
        raise ValueError(f"B must be ({BH}, {T}, S), got {tuple(B.shape)}")
    if C.shape != B.shape:
        raise ValueError(f"C must match B's {tuple(B.shape)}, got "
                         f"{tuple(C.shape)}")
    if x.dtype not in _ENTRY:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"B and C must be {x.dtype} like x, got {B.dtype} "
                        f"and {C.dtype}")
    if dt.dtype != torch.float32 or loga.dtype != torch.float32:
        raise TypeError(f"dt and loga must be float32, got {dt.dtype} and "
                        f"{loga.dtype}")
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    devices = {t.device for t in (x, dt, loga, B, C)}
    if len(devices) != 1:
        raise ValueError(f"all inputs must share a device, got "
                         f"{sorted(map(str, devices))}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, loga, B, C)):
        raise RuntimeError(
            "ssd_scan is forward only (the TPU kernel has no VJP): call it "
            "under torch.no_grad(), or take the plain ssd_chunked for a "
            "gradient")


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, loga: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *, chunk: int = 256
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (BH, T, P) float32 or bfloat16; dt/loga: (BH, T) float32;
    B/C: (BH, T, S) in x's dtype -> (y: (BH, T, P) in x's dtype,
    h_final: (BH, S, P) float32), from a zero initial state.

    CPU tensors take :func:`ssd_scan_plain`; CUDA tensors launch the
    kernel, which needs contiguous inputs, x, B and C aligned to four
    values, P a multiple of 16, S a multiple of 4 and at most MAX_STATE,
    and the shared memory of :func:`smem_bytes` within 227 KB.
    """
    _check(x, dt, loga, B, C, chunk)
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, loga, B, C, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on cpu or cuda, not {x.device}")
    BH, T, P = x.shape
    S = B.shape[-1]
    if P % P_TILE:
        raise ValueError(f"head dim P = {P} must be a multiple of {P_TILE}")
    if S % 4 or S > MAX_STATE:
        raise ValueError(f"state size S = {S} must be a multiple of 4 and at "
                         f"most {MAX_STATE}")
    if smem_bytes(S, chunk) > _MAX_SMEM:
        raise ValueError(f"chunk {chunk} at S = {S} needs "
                         f"{smem_bytes(S, chunk)} B of shared memory, more "
                         f"than a block's {_MAX_SMEM}")
    if BH >= 2 ** 31:
        raise ValueError(f"{BH} rows exceed the kernel's grid")
    if not all(t.is_contiguous() for t in (x, dt, loga, B, C)):
        raise ValueError("ssd_scan needs contiguous inputs")
    # the kernel reads x, B and C four values a load
    if any(t.data_ptr() % (4 * x.element_size()) for t in (x, B, C)):
        raise ValueError(f"ssd_scan needs x, B and C aligned to "
                         f"{4 * x.element_size()} bytes")
    hfin = torch.empty((BH, S, P), dtype=torch.float32, device=x.device)
    if BH == 0 or T == 0:
        return torch.empty_like(x), hfin.zero_()
    pad = (-T) % chunk
    if pad:
        x, B, C = (F.pad(t, (0, 0, 0, pad)) for t in (x, B, C))
        dt, loga = F.pad(dt, (0, pad)), F.pad(loga, (0, pad))
    y = torch.empty_like(x)
    fn = getattr(_library(), _ENTRY[x.dtype])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), dt.data_ptr(), loga.data_ptr(),
                 B.data_ptr(), C.data_ptr(), y.data_ptr(), hfin.data_ptr(),
                 BH, T + pad, P, S, chunk, stream)
    if err != 0:
        raise RuntimeError(
            f"ssd_scan kernel launch failed with CUDA error {err}")
    ssd_scan.launches += 1
    return (y[:, :T] if pad else y), hfin


ssd_scan.launches = 0


__all__ = ["MAX_STATE", "P_TILE", "smem_bytes", "ssd_chunked", "ssd_scan",
           "ssd_scan_plain"]
