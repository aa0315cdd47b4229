"""Mamba-2 SSD chunked scan from a zero state — the Hopper kernel and its
plain version.

:func:`ssd_scan` runs the SSD recurrence ``h_t = exp(loga_t) h_{t-1} +
dt_t B_t (x) x_t``, ``y_t = C_t h_t`` from ``h_0 = 0`` over rows of the
TPU kernel's layout (one row per batch element and head) and returns y
and the final state. It replaces the Pallas TPU kernel
``repro/kernels/ssd_scan.py::ssd_scan`` together with its padding
wrapper ``repro/kernels/ops.py::ssd_scan``. ``heads_per_group``
consecutive rows share one row of B and C (Mamba-2's single B/C group:
the heads of a batch element), so B and C are never repeated per head;
with 1 it is the TPU kernel's function and layout. :func:`ssd_scan_heads`
takes the model's layout, ``(b, T, H, P)`` with B and C ``(b, T, S)``,
and the kernel reads it through strides: no copy of any input.

On a CUDA tensor both launch the hand-written kernels of
``csrc/ssd_scan.cu`` (built for ``sm_90a`` at first use by
:mod:`repro_torch.kernels.build`): one launch forms G = C Bᵀ once per
(group, chunk) and every chunk's state from zero into a scratch that
the wrapper allocates, a second scans each chunk from the states before
it, on the tensor cores in 3xTF32. A ragged T needs no padding: the
kernel loads the rows past T as zeros (dt = loga = 0 freezes the state)
and does not store them. On a CPU tensor they run :func:`ssd_chunked`
(the model's plain scan, kept here) with the group's rows as its heads.
There is no fallback from one to the other: a CUDA tensor launches the
kernels or raises.

The work the algorithm needs is ``Q(Q+1)S`` operations per (group,
chunk) for the causal half of G, ``Q(Q+1)P + 2QSP`` per (row, chunk) for
the causal half of M X and the state carry, and ``2QSP`` per (row, chunk
after the first) for the carried-state term, zero in the first chunk:
0.69 GFLOP at the serve path's admission (one prompt, 32 heads, T 512, P
64, S 128, Q 256), 4.18 µs as three TF32 products at 495 TFLOP/s and
10.28 µs in f32 at 67 TFLOP/s; 12.10 GFLOP, 73.3 µs and 180.6 µs at the
forward shape (8 prompts, T 1024). The source note in
``csrc/ssd_scan.cu`` gives the design. It is forward
only, as the TPU kernel (which has no VJP): the wrapper raises when a
gradient is asked for.

On fake tensors (the dry run) neither entry launches nor runs the plain
scan: each returns fake results and charges :func:`ssd_work`.

``ssd_scan.launches`` counts wrapper calls that launch the kernels (two
CUDA launches a call; CPU calls do not count), through either entry; a
caller resets it to 0 before a run it wants to read.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.runtime import charge, is_fake, nbytes

P_TILE = 16                    # kPT in csrc/ssd_scan.cu: P is a multiple
MAX_STATE = 128                # kMaxState in csrc/ssd_scan.cu
_MAX_SMEM = 232_448            # a block's shared memory on an H100 (227 KB)
_ENTRY = {torch.float32: "ssd_scan_f32", torch.bfloat16: "ssd_scan_bf16"}


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def smem_bytes(S: int, chunk: int, itemsize: int = 4) -> int:
    """The larger block's shared memory of the two kernels for state size
    S, chunk Q and inputs of ``itemsize`` bytes, as the CUDA source lays
    it out (``ssd_scan_smem_bytes`` in csrc/ssd_scan.cu; builds the
    library at first use)."""
    return int(_library().ssd_scan_smem_bytes(S, chunk, itemsize))


def state_splits(rows: int, P: int, T: int, chunk: int, sms: int) -> int:
    """The parts each chunk's state is summed in, one block a part: the
    largest power of two up to 8 that keeps the chunk-state blocks within
    four an SM (the serve path's admission, 256 blocks of a whole chunk
    on an H100's 132 SMs: 2) and divides the chunk's strips of 16 rows."""
    base = rows * (P // P_TILE) * -(-T // chunk)
    strips = _round_up(chunk, 32) // 16
    splits = 1
    while (splits < 8 and strips % (2 * splits) == 0
           and base * 2 * splits <= 4 * sms):
        splits *= 2
    return splits


def scratch_floats(groups: int, heads_per_group: int, T: int, P: int,
                   S: int, chunk: int, splits: int = 1) -> int:
    """The kernels' f32 scratch: G = C Bᵀ (groups x chunks x Qp x Qp, Qp
    the chunk rounded up to 32), the chunk states' parts (rows x chunks x
    splits x S x P) and the chunks' total decays (rows x chunks)."""
    nc = -(-T // chunk)
    rows = groups * heads_per_group
    return (groups * nc * _round_up(chunk, 32) ** 2
            + rows * nc * (splits * S * P + 1))


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
                   B: torch.Tensor, C: torch.Tensor, *, chunk: int = 256,
                   heads_per_group: int = 1
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (BH, T, P); dt/loga: (BH, T); B/C: (BH // heads_per_group, T,
    S) -> (y: (BH, T, P) in x's dtype, h_final: (BH, S, P) float32).

    :func:`ssd_chunked` with each group's rows as its heads, from a zero
    state."""
    BH, T, P = x.shape
    G, hpg = B.shape[0], heads_per_group
    heads = lambda t: t.reshape(G, hpg, T, *t.shape[2:]).transpose(1, 2)  # noqa: E731
    y, h = ssd_chunked(heads(x), heads(dt), heads(loga), B, C, chunk=chunk)
    return y.transpose(1, 2).reshape(BH, T, P), h.reshape(BH, *h.shape[2:])


def ssd_work(groups: int, heads_per_group: int, T: int, P: int, S: int,
             chunk: int) -> int:
    """The operations the algorithm needs (the module note): the causal
    half of G = C Bᵀ once per (group, chunk), per (row, chunk) the
    causal half of M X and the carry, and per (row, chunk after the
    first) the carried-state term."""
    Q, nc, rows = chunk, -(-T // chunk), groups * heads_per_group
    return (groups * nc * Q * (Q + 1) * S
            + rows * (nc * (Q * (Q + 1) * P + 2 * Q * S * P)
                      + (nc - 1) * 2 * Q * S * P))


def _fake(x, dt, loga, B, C, hpg: int, chunk: int):
    """Both entries' results on fake inputs, :func:`ssd_work` charged
    with each input read and each output written once."""
    groups, T, S = B.shape
    P = x.shape[-1]
    y = torch.empty_like(x)
    hfin = torch.empty((groups * hpg, S, P), dtype=torch.float32,
                       device=x.device)
    charge("ssd_scan", ssd_work(groups, hpg, T, P, S, chunk),
           nbytes(x, dt, loga, B, C, y, hfin))
    return y, hfin


def _library() -> ctypes.CDLL:
    lib = build.load("ssd_scan")
    for entry in _ENTRY.values():
        fn = getattr(lib, entry)
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                       + [ctypes.c_int64] * 9 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    lib.ssd_scan_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.ssd_scan_smem_bytes.restype = ctypes.c_int
    return lib


def _check(x, dt, loga, B, C, chunk: int, hpg, heads: bool):
    """Both entries' checks, before dispatch. ``heads``: x is the model's
    (b, T, H, P) and ``hpg`` is H; else x is (BH, T, P) rows. Returns x's
    and dt's strides as (group, head, token), in elements, for contiguous
    inputs."""
    if heads:
        if x.ndim != 4:
            raise ValueError(f"x must be (b, T, H, P), got {tuple(x.shape)}")
        b, T, H, P = x.shape
        per_row, groups = (b, T, H), b
        xs, ds = (T * H * P, P, H * P), (T * H, 1, H)
    else:
        if x.ndim != 3:
            raise ValueError(f"x must be (BH, T, P), got {tuple(x.shape)}")
        BH, T, P = x.shape
        per_row = (BH, T)
        if not isinstance(hpg, int) or hpg < 1:
            raise ValueError(f"heads_per_group must be an int >= 1, got "
                             f"{hpg!r}")
        groups = BH // hpg if BH % hpg == 0 else -1
        xs, ds = (hpg * T * P, T * P, P), (hpg * T, T, 1)
    for name, t in (("dt", dt), ("loga", loga)):
        if tuple(t.shape) != per_row:
            raise ValueError(f"{name} must be {per_row}, got "
                             f"{tuple(t.shape)}")
    if B.ndim != 3 or tuple(B.shape[:2]) != (groups, T):
        want = (f"({b}, {T}, S)" if heads else f"(BH / heads_per_group, T, "
                f"S) = ({BH} / {hpg}, {T}, S)")
        raise ValueError(f"B must be {want}, got {tuple(B.shape)}")
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
    return xs, ds


def _launch(x, dt, loga, B, C, hpg: int, chunk: int, xs, ds):
    """Both kernels on the current stream, for contiguous CUDA inputs of
    either layout (x/y strides ``xs``, dt/loga strides ``ds``). Returns y
    in x's layout and h_final (rows, S, P)."""
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on cpu or cuda, not {x.device}")
    if not all(t.is_contiguous() for t in (x, dt, loga, B, C)):
        raise ValueError("ssd_scan needs contiguous inputs")
    groups, T, S = B.shape
    P = x.shape[-1]
    rows = groups * hpg
    hfin = torch.empty((rows, S, P), dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    if rows == 0 or T == 0:
        return y, hfin.zero_()
    if P % P_TILE:
        raise ValueError(f"head dim P = {P} must be a multiple of {P_TILE}")
    if S % 4 or S > MAX_STATE:
        raise ValueError(f"state size S = {S} must be a multiple of 4 and at "
                         f"most {MAX_STATE}")
    need = smem_bytes(S, chunk, x.element_size())
    if need > _MAX_SMEM:
        raise ValueError(f"chunk {chunk} at S = {S} needs {need} B of shared "
                         f"memory, more than a block's {_MAX_SMEM}")
    if rows >= 2 ** 31:
        raise ValueError(f"{rows} rows exceed the kernel's grid")
    # the kernel reads x, B and C four values a load
    if any(t.data_ptr() % (4 * x.element_size()) for t in (x, B, C)):
        raise ValueError(f"ssd_scan needs x, B and C aligned to "
                         f"{4 * x.element_size()} bytes")
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    splits = state_splits(rows, P, T, chunk, sms)
    scratch = torch.empty(
        scratch_floats(groups, hpg, T, P, S, chunk, splits),
        dtype=torch.float32, device=x.device)
    fn = getattr(_library(), _ENTRY[x.dtype])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), dt.data_ptr(), loga.data_ptr(),
                 B.data_ptr(), C.data_ptr(), y.data_ptr(), hfin.data_ptr(),
                 scratch.data_ptr(), groups, hpg, T, P, S, chunk, splits,
                 *xs, *ds, *xs, stream)
    if err != 0:
        raise RuntimeError(
            f"ssd_scan kernel launch failed with CUDA error {err}")
    ssd_scan.launches += 1
    return y, hfin


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, loga: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *, chunk: int = 256,
             heads_per_group: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (BH, T, P) float32 or bfloat16; dt/loga: (BH, T) float32;
    B/C: (BH // heads_per_group, T, S) in x's dtype, row r of B and C
    shared by rows r * heads_per_group ... + heads_per_group - 1 of x ->
    (y: (BH, T, P) in x's dtype, h_final: (BH, S, P) float32), from a
    zero initial state.

    CPU tensors take :func:`ssd_scan_plain`; CUDA tensors launch the
    kernels, which need contiguous inputs, x, B and C aligned to four
    values, P a multiple of 16, S a multiple of 4 and at most MAX_STATE,
    and the shared memory of :func:`smem_bytes` within 227 KB.
    """
    hpg = heads_per_group
    xs, ds = _check(x, dt, loga, B, C, chunk, hpg, heads=False)
    if is_fake(x):
        return _fake(x, dt, loga, B, C, hpg, chunk)
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, loga, B, C, chunk=chunk,
                              heads_per_group=hpg)
    return _launch(x, dt, loga, B, C, hpg, chunk, xs, ds)


def ssd_scan_heads(x: torch.Tensor, dt: torch.Tensor, loga: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor, *, chunk: int = 256
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The model's layout: x (b, T, H, P), dt/loga (b, T, H), B/C (b, T,
    S) shared by the H heads -> (y: (b, T, H, P) in x's dtype, h_final:
    (b, H, S, P) float32), from a zero initial state.

    CPU tensors take :func:`ssd_chunked`; CUDA tensors launch the kernels
    with ``heads_per_group = H``, reading x, dt and loga through their
    strides (no transposed copy) and writing y in x's layout. The inputs
    must be contiguous; the limits are :func:`ssd_scan`'s."""
    H = x.shape[2] if x.ndim == 4 else 1
    xs, ds = _check(x, dt, loga, B, C, chunk, H, heads=True)
    if is_fake(x):
        y, hfin = _fake(x, dt, loga, B, C, H, chunk)
    elif x.device.type == "cpu":
        return ssd_chunked(x, dt, loga, B, C, chunk=chunk)
    else:
        y, hfin = _launch(x, dt, loga, B, C, H, chunk, xs, ds)
    return y, hfin.view(x.shape[0], H, *hfin.shape[1:])


ssd_scan.launches = 0


__all__ = ["MAX_STATE", "P_TILE", "scratch_floats", "smem_bytes",
           "ssd_chunked", "ssd_scan", "ssd_scan_heads", "ssd_scan_plain",
           "ssd_work", "state_splits"]
