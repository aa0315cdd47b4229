"""Paged single-token decode attention — the Hopper kernel and its plain
version.

:func:`paged_decode` attends one query token per slot over that slot's
pages of a shared K/V page pool: GQA (the ``G`` query heads of a kv head
share its keys and values), scores scaled by ``hd**-0.5``, keys at
absolute positions ``k_pos <= pos`` and, with ``window``, inside the band
``k_pos > pos - window``. It replaces the Pallas TPU kernel
``repro/kernels/paged_attn.py::paged_decode``: on a CUDA tensor it
launches the hand-written kernel of ``csrc/paged_decode.cu`` (built for
``sm_90a`` at first use by :mod:`repro_torch.kernels.build`); on a CPU
tensor it runs :func:`paged_decode_plain`, the port of the reference's
gather path (``repro/models/attention.py::paged_decode_attention`` with
``use_kernel=False``). There is no fallback from one to the other: a
CUDA tensor launches the kernel or raises.

The kernel reads each live key and value row once, so it is bound by
device memory: the bytes of the live K/V over 3.35 TB/s on an H100 SXM.
It splits every slot's positions into chunks, one block per (chunk, kv
head, slot), and the last block of a (slot, kv head) to finish merges
the chunks' partial softmax states in the same launch. :func:`split_plan`
picks the chunk and the scratch shape; the source note in
``csrc/paged_decode.cu`` gives the design. The kernel's arrival counters
live in one int32 buffer per device, zeroed once and reset by the
kernel, so launches on one device run on one stream.

Page ids in ``page_map`` must lie in ``[0, num_pages)``; the kernel reads
them as given (the plain version raises on an index out of range).

``paged_decode.launches`` counts kernel launches (CPU calls do not
count); a caller resets it to 0 before a run it wants to read.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
MAX_HEAD_DIM = 256             # kMaxHeadDim in csrc/paged_decode.cu
MAX_GROUP = 16                 # kMaxGroup in csrc/paged_decode.cu
MAX_CHUNK = 64                 # kMaxChunk in csrc/paged_decode.cu
CHUNK_BYTES = 32 * 1024        # the K and V rows one block stages
_MAX_SLOTS = 65_535            # the kernel's grid.z
_ENTRY = {torch.float32: "paged_decode_f32",
          torch.bfloat16: "paged_decode_bf16"}
_ARRIVALS: dict[torch.device, torch.Tensor] = {}   # per device, all zero


class SplitPlan(NamedTuple):
    chunk: int                  # positions a block takes
    n_split: int                # blocks per (slot, kv head)
    scratch: tuple              # (B, K, n_split, G, hd + 2) float32


def split_plan(B: int, K: int, G: int, hd: int, page_size: int, P: int,
               dtype: torch.dtype) -> SplitPlan:
    """The kernel's split of a slot's ``P * page_size`` positions.

    A chunk holds at most MAX_CHUNK positions and CHUNK_BYTES of K and V
    rows (64 positions at hd 64 in float32, 16 at hd 256), and whole
    pages when a page fits; ``n_split = ceil(P * page_size / chunk)``.
    Raises for what the kernel does not take (hd, G or B above its
    limits)."""
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {hd} exceeds the kernel's {MAX_HEAD_DIM}")
    if G > MAX_GROUP:
        raise ValueError(f"{G} query heads per kv head exceed the kernel's "
                         f"{MAX_GROUP}")
    if B > _MAX_SLOTS:
        raise ValueError(f"{B} slots exceed the kernel's {_MAX_SLOTS}")
    span = P * page_size
    if span < 1:
        raise ValueError(f"a slot needs at least one position, got {P} "
                         f"pages of {page_size}")
    esize = torch.empty((), dtype=dtype).element_size()
    chunk = min(MAX_CHUNK, CHUNK_BYTES // (2 * max(hd, 1) * esize), span)
    if page_size <= chunk:
        chunk -= chunk % page_size
    n_split = -(-span // chunk)
    return SplitPlan(chunk, n_split, (B, K, n_split, G, hd + 2))


def _arrivals(device: torch.device, n: int) -> torch.Tensor:
    """The device's arrival counters, at least ``n``, all zero between
    launches (each launch resets those it used)."""
    buf = _ARRIVALS.get(device)
    if buf is None or buf.numel() < n:
        buf = _ARRIVALS[device] = torch.zeros(n, dtype=torch.int32,
                                              device=device)
    return buf


def paged_decode_plain(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, page_map: torch.Tensor,
                       pos: torch.Tensor, *, window: int = 0
                       ) -> torch.Tensor:
    """q: (B, K, G, hd); k_pages/v_pages: (num_pages, page_size, K, hd);
    page_map: (B, P) int; pos: (B,) int -> (B, K, G, hd) float32.

    Gathers every slot's P pages into a contiguous (B, P*ps, K, hd)
    buffer (keys and values cast to q's dtype, as the reference) and
    runs a masked float32 softmax. A row whose keys are all masked
    (a sliding window past the slot's pages) takes the uniform mean of
    its gathered values, as the reference does."""
    B, K, G, hd = q.shape
    ps = k_pages.shape[1]
    P = page_map.shape[1]
    pm = page_map.long()
    kg = k_pages[pm].reshape(B, P * ps, K, hd).to(q.dtype)
    vg = v_pages[pm].reshape(B, P * ps, K, hd).to(q.dtype)
    s = torch.einsum("bkgh,bskh->bkgs", (q * hd ** -0.5).float(),
                     kg.float())
    k_pos = torch.arange(P * ps, device=q.device)
    pos = pos.long()
    valid = k_pos[None, :] <= pos[:, None]
    if window:
        valid = valid & (k_pos[None, :] > pos[:, None] - window)
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bkgs,bskh->bkgh", w, vg.float())


def _library() -> ctypes.CDLL:
    lib = build.load("paged_decode")
    for entry in _ENTRY.values():
        fn = getattr(lib, entry)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_float, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check(q, k_pages, v_pages, page_map, pos) -> None:
    if q.ndim != 4:
        raise ValueError(f"q must be (B, K, G, hd), got {tuple(q.shape)}")
    B, K, G, hd = q.shape
    if k_pages.ndim != 4 or tuple(k_pages.shape[2:]) != (K, hd):
        raise ValueError(f"k_pages must be (num_pages, page_size, {K}, "
                         f"{hd}), got {tuple(k_pages.shape)}")
    if v_pages.shape != k_pages.shape:
        raise ValueError(f"v_pages must match k_pages' "
                         f"{tuple(k_pages.shape)}, got {tuple(v_pages.shape)}")
    if page_map.ndim != 2 or page_map.shape[0] != B:
        raise ValueError(f"page_map must be ({B}, pages_per_slot), got "
                         f"{tuple(page_map.shape)}")
    if tuple(pos.shape) != (B,):
        raise ValueError(f"pos must be ({B},), got {tuple(pos.shape)}")
    if q.dtype != torch.float32:
        raise TypeError(f"q must be float32, got {q.dtype}")
    if k_pages.dtype not in _ENTRY:
        raise TypeError(f"the pools must be float32 or bfloat16, got "
                        f"{k_pages.dtype}")
    if v_pages.dtype != k_pages.dtype:
        raise TypeError(f"v_pages must be {k_pages.dtype} like k_pages, "
                        f"got {v_pages.dtype}")
    if page_map.dtype != torch.int32 or pos.dtype != torch.int32:
        raise TypeError(f"page_map and pos must be int32, got "
                        f"{page_map.dtype} and {pos.dtype}")
    devices = {t.device for t in (q, k_pages, v_pages, page_map, pos)}
    if len(devices) != 1:
        raise ValueError(f"all inputs must share a device, got "
                         f"{sorted(map(str, devices))}")


def paged_decode(q: torch.Tensor, k_pages: torch.Tensor,
                 v_pages: torch.Tensor, page_map: torch.Tensor,
                 pos: torch.Tensor, *, window: int = 0) -> torch.Tensor:
    """q: (B, K, G, hd) float32; k_pages/v_pages: (num_pages, page_size,
    K, hd) float32 or bfloat16; page_map: (B, P) int32; pos: (B,) int32
    -> the softmax-weighted values (B, K, G, hd) in float32 (a new
    tensor; the caller projects).

    CPU tensors take :func:`paged_decode_plain`; CUDA tensors launch the
    kernel, which needs contiguous inputs, hd <= MAX_HEAD_DIM,
    G <= MAX_GROUP and B <= 65,535.
    """
    _check(q, k_pages, v_pages, page_map, pos)
    if q.device.type == "cpu":
        return paged_decode_plain(q, k_pages, v_pages, page_map, pos,
                                  window=window)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode runs on cpu or cuda, not {q.device}")
    B, K, G, hd = q.shape
    ps, P = k_pages.shape[1], page_map.shape[1]
    plan = split_plan(B, K, G, hd, ps, P, k_pages.dtype)
    if not all(t.is_contiguous() for t in (q, k_pages, v_pages, page_map,
                                           pos)):
        raise ValueError("paged_decode needs contiguous inputs")
    out = torch.empty((B, K, G, hd), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out
    part = torch.empty(plan.scratch, dtype=torch.float32, device=q.device)
    arrivals = _arrivals(q.device, B * K)
    fn = getattr(_library(), _ENTRY[k_pages.dtype])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 page_map.data_ptr(), pos.data_ptr(), out.data_ptr(),
                 part.data_ptr(), arrivals.data_ptr(), B, K, G, hd, ps, P,
                 int(window), hd ** -0.5, plan.chunk, plan.n_split, stream)
    if err != 0:
        raise RuntimeError(
            f"paged_decode kernel launch failed with CUDA error {err}")
    paged_decode.launches += 1
    return out


paged_decode.launches = 0


__all__ = ["CHUNK_BYTES", "MAX_CHUNK", "MAX_GROUP", "MAX_HEAD_DIM",
           "NEG_INF", "SplitPlan", "paged_decode", "paged_decode_plain",
           "split_plan"]
