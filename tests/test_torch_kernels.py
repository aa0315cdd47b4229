"""The port's kernels against their plain versions. This file imports
no JAX, so it also runs on the machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels.py

Tests marked ``cuda`` need an NVIDIA GPU and ``nvcc`` and skip without
one. On the CPU the wrapper's contract is checked: CPU tensors take the
plain version and do not count as launches. Tolerances are the
reference's (``tests/test_kernels.py``): ``consensus_mix`` 1e-5 in
float32 and 2e-2 in bfloat16; ``fused_sgd`` and ``fused_consensus_sgd``
1e-6 in float32 and 1e-2 in bfloat16 (atol and rtol); ``paged_decode``
1e-5 with float32 and with bfloat16 pools (both versions read the pools
in float32, and bf16 -> f32 is exact); ``ssd_scan`` the reference's
max |Δy| / max |y| < 1e-4 and final state to rtol/atol 1e-4 in float32,
and in bfloat16 (inputs rounded to bf16, both versions in float32
inside) y within 1e-2 of max |y|: the two round different float32 sums
to bfloat16, one bf16 step (2^-8 relative) apart at most.
"""
import _torch_threads  # noqa: F401  (torch threads per xdist worker)
import numpy as np
import pytest
import torch

from repro_torch.core.topology import geometric_adjacency, metropolis_weights
from repro_torch.kernels import build
from repro_torch.core.mixing import (
    build_mixing_plan, masked_consensus_matrix, matrix_powers,
    refresh_matrices)
from repro_torch.kernels.consensus_mix import (
    MAX_CLUSTER_SIZE, consensus_mix, consensus_mix_plain)
from repro_torch.kernels.fused_consensus_sgd import (
    fused_consensus_sgd, fused_consensus_sgd_plain)
from repro_torch.kernels.fused_sgd import fused_sgd, fused_sgd_plain, out_like
from repro_torch.kernels import runtime
from repro_torch.kernels.sim_nn_step import (
    BATCH_TILE, sim_nn_forward, sim_nn_forward_plain, sim_nn_step,
    sim_nn_step_check, sim_nn_step_plain, sim_nn_update, sim_nn_update_plain)
from repro_torch.kernels.paged_decode import (
    CHUNK_BYTES, MAX_CHUNK, MAX_GROUP, MAX_HEAD_DIM, paged_decode,
    paged_decode_plain, split_plan)
from repro_torch.kernels.ssd_scan import (
    MAX_STATE, P_TILE, scratch_floats, smem_bytes, ssd_chunked, ssd_scan,
    ssd_scan_heads, ssd_scan_plain, state_splits)

SHAPES = [(1, 2, 8), (3, 5, 100), (4, 8, 700), (2, 5, 513), (25, 5, 64),
          (25, 5, 10), (2, MAX_CLUSTER_SIZE, 300)]
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
SGD_TOL = {torch.float32: 1e-6, torch.bfloat16: 1e-2}
SGD_SHAPES = [(8,), (127,), (129,), (1000, 37), (3, 5, 7, 11), (3, 70_001)]
FCS_SHAPES = [(2, 4, 64), (4, 2, 937), (1, 8, 128), (2, 2, 100_003),
              (1, MAX_CLUSTER_SIZE, 300)]


def _inputs(N, s, M, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    z = torch.from_numpy(rng.normal(size=(N, s, M)).astype(np.float32))
    V = np.stack([metropolis_weights(geometric_adjacency(s, 0.9, rng))
                  for _ in range(N)]).astype(np.float32)
    gamma = rng.integers(0, 6, size=(N,)).astype(np.int32)
    gamma[0] = 0
    return (z.to(device, dtype), torch.from_numpy(V).to(device),
            torch.from_numpy(gamma).to(device))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_tensors_take_the_plain_version(dtype):
    z, V, gamma = _inputs(3, 5, 40, dtype, "cpu")
    before = consensus_mix.launches
    out = consensus_mix(z, V, gamma)
    assert consensus_mix.launches == before
    assert torch.equal(out, consensus_mix_plain(z, V, gamma))
    assert out.dtype == dtype and out.data_ptr() != z.data_ptr()
    # Γ = 0 copies z bit for bit, bf16 included
    assert torch.equal(consensus_mix(z, V, 0), z)


def _sgd_inputs(shape, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    w, g = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
            for _ in range(2))
    return w.to(device, dtype), g.to(device, dtype)


def _fcs_inputs(N, s, M, dtype, device, seed=0):
    w, g = _sgd_inputs((N, s, M), dtype, device, seed)
    _, V, _ = _inputs(N, s, 1, torch.float32, device, seed)
    return w, g, matrix_powers(V, 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("wd", [0.0, 0.1])
def test_fused_sgd_cpu_tensors_take_the_plain_version(dtype, wd):
    w, g = _sgd_inputs((3, 5, 7), dtype, "cpu")
    before = fused_sgd.launches
    out = fused_sgd(w, g, 0.01, weight_decay=wd)
    assert fused_sgd.launches == before
    assert torch.equal(out, fused_sgd_plain(w, g, 0.01, weight_decay=wd))
    assert out.dtype == dtype and out.shape == w.shape
    # float32 inside: eta = 0 and wd = 0 give w back bit for bit
    assert torch.equal(fused_sgd(w, g, 0.0), w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("skip", [0, 1, 3])
def test_fused_sgd_output_keeps_the_offset_of_w(dtype, skip):
    # a contiguous view such as big[1:]: the output shares w's offset mod
    # 16 bytes (so the kernel's 16-byte path still runs), and the CPU
    # wrapper gives the plain version's values
    big, gbig = _sgd_inputs((skip + 37,), dtype, "cpu")
    w, g = big[skip:], gbig[skip:]
    out = out_like(w)
    assert out.shape == w.shape and out.dtype == dtype
    assert out.is_contiguous()
    assert out.data_ptr() % 16 == w.data_ptr() % 16
    assert torch.equal(fused_sgd(w, g, 0.01), fused_sgd_plain(w, g, 0.01))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("wd", [0.0, 0.1])
def test_fused_consensus_sgd_cpu_tensors_take_the_plain_version(dtype, wd):
    w, g, W = _fcs_inputs(2, 4, 64, dtype, "cpu")
    before = fused_consensus_sgd.launches
    out = fused_consensus_sgd(w, g, W, 0.01, weight_decay=wd)
    assert fused_consensus_sgd.launches == before
    assert torch.equal(out, fused_consensus_sgd_plain(w, g, W, 0.01,
                                                      weight_decay=wd))
    assert out.dtype == dtype and out.shape == w.shape
    # the SGD half alone, mixed by W: the two plain versions agree
    expect = torch.einsum("nij,njm->nim", W,
                          fused_sgd_plain(w, g, 0.01, weight_decay=wd)
                          .float()).to(dtype)
    np.testing.assert_allclose(out.float().numpy(), expect.float().numpy(),
                               atol=SGD_TOL[dtype], rtol=SGD_TOL[dtype])


def test_fused_wrappers_refuse_bad_inputs_before_dispatch():
    w, g, W = _fcs_inputs(2, 4, 16, torch.float32, "cpu")
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fused_sgd(w.half(), g.half(), 0.1)
    with pytest.raises(TypeError, match="like w"):
        fused_sgd(w, g.bfloat16(), 0.1)
    with pytest.raises(ValueError, match="match"):
        fused_sgd(w, g[:, :, :8], 0.1)
    with pytest.raises(ValueError, match="scalar"):
        fused_sgd(w, g, torch.ones(2))
    with pytest.raises(ValueError, match=r"W must be \(2, 4, 4\)"):
        fused_consensus_sgd(w, g, W[:, :3, :3], 0.1)
    with pytest.raises(TypeError, match="W must be float32"):
        fused_consensus_sgd(w, g, W.double(), 0.1)
    with pytest.raises(ValueError, match=r"\(N, s, M\)"):
        fused_consensus_sgd(w[0], g[0], W, 0.1)


# paged_decode: name -> (B, K, G, hd, page_size, P, num_pages, window,
# pos); slot b's row holds pages of one random permutation, and a slot
# with pos None takes an all-dummy row with its pos past its pages
PAGED_CASES = {
    # tests/test_serving_paged.py's shape, window 0 and 4
    "reference": (2, 2, 2, 8, 4, 3, 4, 0, [5, 9]),
    "reference-window": (2, 2, 2, 8, 4, 3, 4, 4, [5, 9]),
    "dummy-row": (3, 2, 2, 8, 4, 3, 7, 0, [5, None, 11]),
    "dummy-row-window": (3, 2, 2, 8, 4, 3, 7, 4, [5, None, 11]),
    # the serve path's main shape: qwen1.5-0.5b, 8 slots, P 40, 321 pages
    "qwen-serve": (8, 16, 1, 64, 16, 40, 321, 0,
                   [80 * (b + 1) - 1 for b in range(8)]),
    # gemma-2b-like MQA and starcoder2-3b-like GQA past its 4096 window
    "gemma-mqa": (4, 1, 8, 256, 16, 8, 33, 0, [3, 60, None, 127]),
    "starcoder-window": (2, 2, 12, 128, 16, 320, 641, 4096, [4500, 5119]),
    # the hybrid kind's serve shape: recurrentgemma-9b's MQA (G 16, hd
    # 256) under its 2,048 window, slots before, at and past the window
    "hybrid-serve": (8, 1, 16, 256, 16, 196, 1569, 2048,
                     [700, 1500, 2047, 2048, 2300, 2600, 3000, 3135]),
    # the moe kind's serve shape: llama4-scout's GQA (K 8, G 5, hd 128),
    # 8 slots of 36 pages (512-token prompts and 64 new tokens), 289 pages
    "scout-serve": (8, 8, 5, 128, 16, 36, 289, 0,
                    [250, 296, 342, 388, 434, 480, 526, 575]),
}
# the kernel's split at its boundaries: 4 slots of 12 pages of 16 (192
# positions), hd 64, so a chunk of 64 positions (four pages) in f32 and
# bf16 alike; and a head of 6, whose rows are no whole 16-byte pieces
_C = split_plan(4, 2, 2, 64, 16, 12, torch.float32).chunk
SPLIT_CASES = {
    # live ranges of 1, C - 1, C and C + 1 positions
    "split-edges": (4, 2, 2, 64, 16, 12, 49, 0, [0, _C - 2, _C - 1, _C]),
    # windows that start mid-chunk
    "split-window": (4, 2, 2, 64, 16, 12, 49, _C // 2 + 3,
                     [_C + 5, 2 * _C + 10, 3 * _C - 1, 40]),
    # a retired all-dummy slot: every position of dummy page 0 is live
    "split-retired": (4, 2, 2, 64, 16, 12, 49, 0, [_C + 3, None, 2 * _C, 5]),
    # windowed rows past their pages: all masked (uniform mean), and a
    # retired slot whose window still holds 8 positions
    "split-all-masked": (4, 2, 2, 64, 16, 12, 49, 16,
                         [3 * _C + 19, None, 100, 3 * _C + 40]),
    "odd-head": (3, 2, 3, 6, 4, 5, 16, 0, [0, 11, 19]),
}


def _paged_inputs(case, dtype, device, seed=0):
    B, K, G, hd, ps, P, N, window, pos = {**PAGED_CASES, **SPLIT_CASES}[case]
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, K, G, hd)).astype(np.float32)
    kp = rng.normal(size=(N, ps, K, hd)).astype(np.float32)
    vp = rng.normal(size=(N, ps, K, hd)).astype(np.float32)
    pages = rng.permutation(np.arange(1, N))
    page_map = np.zeros((B, P), np.int32)
    pos_v = np.zeros((B,), np.int32)
    for b, pb in enumerate(pos):
        if pb is None:                   # retired: dummy row, pos grown on
            pos_v[b] = P * ps + 7
        else:
            page_map[b] = pages[b * P:(b + 1) * P] if N > B * P else \
                rng.choice(np.arange(1, N), size=P)
            pos_v[b] = pb
    to = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return (to(q), to(kp).to(dtype), to(vp).to(dtype), to(page_map),
            to(pos_v), window)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_cpu_tensors_take_the_plain_version(dtype):
    for case in ("reference-window", "dummy-row-window", "gemma-mqa",
                 "hybrid-serve", "scout-serve"):
        *args, window = _paged_inputs(case, dtype, "cpu")
        before = paged_decode.launches
        out = paged_decode(*args, window=window)
        assert paged_decode.launches == before
        assert out.dtype == torch.float32 and out.shape == args[0].shape
        assert torch.equal(out, paged_decode_plain(*args, window=window))
        assert torch.isfinite(out).all()


@pytest.mark.parametrize("hd, ps, P, dtype, chunk, n_split", [
    (64, 16, 40, torch.float32, 64, 10),       # qwen-serve: four pages
    (64, 16, 40, torch.bfloat16, 64, 10),
    (128, 16, 320, torch.float32, 32, 160),    # starcoder-window
    (128, 16, 320, torch.bfloat16, 64, 80),
    (256, 16, 8, torch.float32, 16, 8),        # gemma-mqa: one page
    (256, 16, 8, torch.bfloat16, 32, 4),
    (256, 16, 196, torch.float32, 16, 196),    # hybrid-serve
    (128, 16, 36, torch.float32, 32, 18),      # scout-serve
    (8, 4, 3, torch.float32, 12, 1),           # reference: the whole slot
    (64, 48, 4, torch.float32, 48, 4),         # whole pages of 48
    (64, 100, 3, torch.float32, 64, 5),        # a page above a chunk
    (6, 4, 5, torch.bfloat16, 20, 1),          # odd-head
])
def test_split_plan(hd, ps, P, dtype, chunk, n_split):
    B, K, G = 3, 2, 4
    plan = split_plan(B, K, G, hd, ps, P, dtype)
    assert (plan.chunk, plan.n_split) == (chunk, n_split)
    assert plan.scratch == (B, K, n_split, G, hd + 2)
    # the chunks tile the slot, within the kernel's limits
    span = P * ps
    assert (n_split - 1) * chunk < span <= n_split * chunk
    assert 1 <= chunk <= MAX_CHUNK
    esize = torch.empty((), dtype=dtype).element_size()
    assert 2 * chunk * hd * esize <= CHUNK_BYTES or chunk == ps
    if ps <= chunk:
        assert chunk % ps == 0


def test_split_plan_refuses_what_the_kernel_cannot_run():
    plan = split_plan(65_535, 16, MAX_GROUP, MAX_HEAD_DIM, 16, 4,
                      torch.float32)
    assert plan.chunk == 16
    with pytest.raises(ValueError, match="head_dim"):
        split_plan(2, 2, 1, MAX_HEAD_DIM + 1, 16, 4, torch.float32)
    with pytest.raises(ValueError, match="query heads"):
        split_plan(2, 2, MAX_GROUP + 1, 64, 16, 4, torch.float32)
    with pytest.raises(ValueError, match="slots"):
        split_plan(65_536, 2, 1, 64, 16, 4, torch.float32)
    with pytest.raises(ValueError, match="at least one position"):
        split_plan(2, 2, 1, 64, 16, 0, torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_cases_cross_the_boundaries(dtype):
    # the boundary cases cover what they name, in both dtypes, and the
    # CPU wrapper agrees with the plain version on them
    spec = SPLIT_CASES["split-edges"]
    assert split_plan(*spec[:6], dtype).chunk == _C
    assert sorted(min(p, 191) + 1 for p in spec[8]) == [1, _C - 1, _C,
                                                        _C + 1]
    B, K, G, hd, ps, P = PAGED_CASES["starcoder-window"][:6]
    assert split_plan(B, K, G, hd, ps, P, dtype).n_split > 64
    for case in SPLIT_CASES:
        *args, window = _paged_inputs(case, dtype, "cpu")
        out = paged_decode(*args, window=window)
        assert torch.equal(out, paged_decode_plain(*args, window=window))
        assert torch.isfinite(out).all()


def test_paged_decode_refuses_bad_inputs_before_dispatch():
    q, kp, vp, pm, pos, _ = _paged_inputs("reference", torch.float32, "cpu")
    with pytest.raises(TypeError, match="q must be float32"):
        paged_decode(q.double(), kp, vp, pm, pos)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        paged_decode(q, kp.half(), vp.half(), pm, pos)
    with pytest.raises(TypeError, match="like k_pages"):
        paged_decode(q, kp, vp.bfloat16(), pm, pos)
    with pytest.raises(TypeError, match="int32"):
        paged_decode(q, kp, vp, pm.long(), pos)
    with pytest.raises(ValueError, match=r"\(B, K, G, hd\)"):
        paged_decode(q[0], kp, vp, pm, pos)
    with pytest.raises(ValueError, match="k_pages must be"):
        paged_decode(q, kp[..., :4], vp[..., :4], pm, pos)
    with pytest.raises(ValueError, match="v_pages must match"):
        paged_decode(q, kp, vp[:2], pm, pos)
    with pytest.raises(ValueError, match="page_map must be"):
        paged_decode(q, kp, vp, pm[:1], pos)
    with pytest.raises(ValueError, match="pos must be"):
        paged_decode(q, kp, vp, pm, pos[:1])


# ssd_scan: (BH, T, P, S, chunk) — tests/test_kernels.py's shapes (the
# ragged T = 130 included), the reduced mamba2's rows, the serve path's
# admission (32 heads, a 512-token prompt) and a 4-chunk forward row set
SSD_SHAPES = [(1, 64, 16, 16, 16), (2, 256, 64, 128, 128),
              (3, 512, 64, 128, 256), (2, 130, 32, 64, 64),
              (8, 45, 32, 32, 32), (32, 512, 64, 128, 256),
              (64, 1024, 64, 128, 256)]


def _ssd_inputs(BH, T, P, S, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(BH, T, P)).astype(np.float32)
    dt = rng.uniform(0.001, 0.1, size=(BH, T)).astype(np.float32)
    loga = (-dt * rng.uniform(0.5, 2.0, size=(BH, 1))).astype(np.float32)
    B = (rng.normal(size=(BH, T, S)) * 0.3).astype(np.float32)
    C = (rng.normal(size=(BH, T, S)) * 0.3).astype(np.float32)
    to = lambda a, d=dtype: torch.from_numpy(a).to(device, d)  # noqa: E731
    return (to(x), to(dt, torch.float32), to(loga, torch.float32), to(B),
            to(C))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_cpu_tensors_take_the_plain_version(dtype):
    for BH, T, P, S, chunk in SSD_SHAPES[:5]:
        args = _ssd_inputs(BH, T, P, S, dtype, "cpu")
        before = ssd_scan.launches
        y, h = ssd_scan(*args, chunk=chunk)
        assert ssd_scan.launches == before
        yp, hp = ssd_scan_plain(*args, chunk=chunk)
        assert torch.equal(y, yp) and torch.equal(h, hp)
        assert y.dtype == dtype and y.shape == (BH, T, P)
        assert h.dtype == torch.float32 and h.shape == (BH, S, P)


def test_ssd_scan_refuses_bad_inputs_before_dispatch():
    x, dt, loga, B, C = _ssd_inputs(2, 32, 16, 16, torch.float32, "cpu")
    with pytest.raises(ValueError, match=r"\(BH, T, P\)"):
        ssd_scan(x[0], dt, loga, B, C)
    with pytest.raises(ValueError, match="dt must be"):
        ssd_scan(x, dt[:, :8], loga, B, C)
    with pytest.raises(ValueError, match="B must be"):
        ssd_scan(x, dt, loga, B[:1], C)
    with pytest.raises(ValueError, match="C must match"):
        ssd_scan(x, dt, loga, B, C[..., :8])
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ssd_scan(x.half(), dt, loga, B.half(), C.half())
    with pytest.raises(TypeError, match="like x"):
        ssd_scan(x, dt, loga, B.bfloat16(), C)
    with pytest.raises(TypeError, match="dt and loga must be float32"):
        ssd_scan(x, dt.double(), loga, B, C)
    with pytest.raises(RuntimeError, match="forward only"):
        ssd_scan(x, dt, loga.requires_grad_(), B, C)


# grouped calls: (b, H, T, P, S, chunk) — B and C shared by the H heads of
# a batch element: a reduced mamba2 layer, ragged T, and a chunk of 512
# (the kernel's two passes of 256 rows); on the card also the serve path's
# admission and the forward shape
SSD_GROUP_SHAPES = [(2, 3, 45, 16, 16, 16), (2, 4, 130, 32, 64, 64),
                    (1, 8, 256, 64, 128, 128), (1, 4, 700, 32, 64, 512)]
SSD_GROUP_CARD_SHAPES = [(1, 32, 512, 64, 128, 256),
                         (8, 32, 1024, 64, 128, 256)]


def _ssd_group_inputs(b, H, T, P, S, dtype, device, seed=0):
    """x (b*H, T, P), dt/loga (b*H, T), B/C (b, T, S)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b * H, T, P)).astype(np.float32)
    dt = rng.uniform(0.001, 0.1, size=(b * H, T)).astype(np.float32)
    loga = (-dt * rng.uniform(0.5, 2.0, size=(b * H, 1))).astype(np.float32)
    B = (rng.normal(size=(b, T, S)) * 0.3).astype(np.float32)
    C = (rng.normal(size=(b, T, S)) * 0.3).astype(np.float32)
    to = lambda a, d=dtype: torch.from_numpy(a).to(device, d)  # noqa: E731
    return (to(x), to(dt, torch.float32), to(loga, torch.float32), to(B),
            to(C))


def _to_heads(x, dt, loga, b, H):
    """(b*H, T, ...) rows -> the model's (b, T, H, ...) layout."""
    heads = lambda t: t.reshape(b, H, *t.shape[1:]).transpose(1, 2)  # noqa
    return (heads(x).contiguous(), heads(dt).contiguous(),
            heads(loga).contiguous())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SSD_GROUP_SHAPES)
def test_ssd_scan_grouped_equals_repeated_rows(dtype, shape):
    """heads_per_group = H with B/C (b, T, S) is the per-row call with B/C
    repeated for every head (1e-6), on the CPU and counting no launch; and
    ssd_scan_heads on the model's layout is ssd_chunked with H heads."""
    b, H, T, P, S, chunk = shape
    x, dt, loga, B, C = _ssd_group_inputs(b, H, T, P, S, dtype, "cpu")
    before = ssd_scan.launches
    y, h = ssd_scan(x, dt, loga, B, C, chunk=chunk, heads_per_group=H)
    rep = lambda t: t.repeat_interleave(H, dim=0)  # noqa: E731
    yr, hr = ssd_scan(x, dt, loga, rep(B), rep(C), chunk=chunk)
    assert y.dtype == dtype and y.shape == (b * H, T, P)
    assert h.dtype == torch.float32 and h.shape == (b * H, S, P)
    np.testing.assert_allclose(y.float().numpy(), yr.float().numpy(),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(h.numpy(), hr.numpy(), rtol=0, atol=1e-6)
    xh, dth, lah = _to_heads(x, dt, loga, b, H)
    yh, hh = ssd_scan_heads(xh, dth, lah, B, C, chunk=chunk)
    yc, hc = ssd_chunked(xh, dth, lah, B, C, chunk=chunk)
    assert torch.equal(yh, yc) and torch.equal(hh, hc)
    assert torch.equal(yh.transpose(1, 2).reshape(b * H, T, P), y)
    assert torch.equal(hh.reshape(b * H, S, P), h)
    assert ssd_scan.launches == before


def test_ssd_scan_refuses_a_bad_group_before_dispatch():
    x, dt, loga, B, C = _ssd_group_inputs(2, 4, 32, 16, 16, torch.float32,
                                          "cpu")
    for bad in (0, -1, 2.0, None):
        with pytest.raises(ValueError, match="heads_per_group must be"):
            ssd_scan(x, dt, loga, B, C, heads_per_group=bad)
    with pytest.raises(ValueError, match="B must be"):
        ssd_scan(x, dt, loga, B, C, heads_per_group=3)      # 2 x 3 != 8
    with pytest.raises(ValueError, match="B must be"):
        ssd_scan(x, dt, loga, B, C)                         # 2 rows, not 8
    with pytest.raises(ValueError, match="B must be"):
        ssd_scan(x, dt, loga, B[:1], C[:1], heads_per_group=4)
    with pytest.raises(ValueError, match="C must match"):
        ssd_scan(x, dt, loga, B, C[:, :16], heads_per_group=4)
    xh, dth, lah = _to_heads(x, dt, loga, 2, 4)
    with pytest.raises(ValueError, match=r"\(b, T, H, P\)"):
        ssd_scan_heads(x, dt, loga, B, C)
    with pytest.raises(ValueError, match="dt must be"):
        ssd_scan_heads(xh, dth[:, :8], lah, B, C)
    with pytest.raises(ValueError, match="B must be"):
        ssd_scan_heads(xh, dth, lah, B[:1], C)
    with pytest.raises(TypeError, match="like x"):
        ssd_scan_heads(xh, dth, lah, B.bfloat16(), C)


def test_ssd_scan_sizes_its_scratch():
    """The scratch holds G once per group and chunk (Qp^2 floats, Qp the
    chunk rounded up to 32: 512 KB at the serve shape), every row's
    chunk states (S x P floats each, in parts) and their total decays."""
    assert scratch_floats(1, 32, 512, 64, 128, 256) == (
        2 * 256 * 256 + 32 * 2 * (128 * 64 + 1))
    assert scratch_floats(8, 32, 1024, 64, 128, 256) == (
        8 * 4 * 256 * 256 + 256 * 4 * (128 * 64 + 1))
    assert scratch_floats(2, 1, 130, 32, 64, 64) == (
        2 * 3 * 64 * 64 + 2 * 3 * (64 * 32 + 1))
    assert scratch_floats(1, 3, 45, 16, 16, 16) == (
        3 * 32 * 32 + 3 * 3 * (16 * 16 + 1))
    assert scratch_floats(1, 32, 512, 64, 128, 256, splits=2) == (
        2 * 256 * 256 + 32 * 2 * (2 * 128 * 64 + 1))
    # a chunk's state is summed in parts where whole chunks leave the card
    # short of blocks: 2 at the serve shape on 132 SMs, 1 at the forward
    # shape; parts divide the chunk's 16-row strips
    assert state_splits(32, 64, 512, 256, 132) == 2
    assert state_splits(256, 64, 1024, 256, 132) == 1
    assert state_splits(2, 16, 64, 16, 132) == 2        # Qp 32: two strips
    assert state_splits(1, 16, 256, 256, 132) == 8


def test_build_names_the_sources():
    # fused_sgd's streaming kernel lives in fused_consensus_sgd.cu, beside
    # the kernel whose SGD step it shares
    assert build.sources() == ["consensus_mix", "fused_consensus_sgd",
                               "paged_decode", "sim_nn_step", "ssd_scan"]
    for name in build.sources():
        lib = build.library_path(name)
        assert lib.name.startswith(f"lib{name}-") and lib.suffix == ".so"
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS


# ---------------------------------------------------------------------------
# the sim step of the one-hidden-layer network (kernels/sim_nn_step.py)
# ---------------------------------------------------------------------------

DARK = {"none": [], "some": [1, 4], "all": list(range(6))}


def _nn_fleet(I, B, m, hid, device="cpu", seed=0, dark=()):
    """An ``nn`` model, a fleet of I devices whose leaves differ, one
    minibatch (x, y) and the dark mask (None for no dark device)."""
    from repro_torch.models import make_sim_model
    model = make_sim_model("nn", m, 10, hid)
    gen = torch.Generator().manual_seed(seed)
    w0 = model.init(gen, "cpu")
    params = {k: (v.expand((I,) + tuple(v.shape))
                  + 0.02 * torch.randn((I,) + tuple(v.shape), generator=gen))
              .contiguous().to(device) for k, v in sorted(w0.items())}
    x = torch.randn((I, B, m), generator=gen).to(device)
    y = torch.randint(0, 10, (I, B), generator=gen).to(device)
    mask = None
    if dark:
        mask = torch.zeros(I, dtype=torch.bool)
        mask[list(dark)] = True
        mask = mask.to(device)
    return model, params, x, y, mask


def _autograd_step(model, params, x, y, eta, dark):
    """The trainer's autograd path: ``SimModel.grads``, then the update."""
    grads = model.grads(params, x, y)
    with torch.no_grad():
        for k, g in grads.items():
            g.mul_(eta)
            if dark is not None:
                g.masked_fill_(dark.view((-1,) + (1,) * (g.ndim - 1)), 0)
            params[k].sub_(g)


@pytest.mark.parametrize("B", [1, 16])
@pytest.mark.parametrize("dark", sorted(DARK))
def test_sim_nn_step_plain_matches_autograd(B, dark):
    """The closed-form step against autograd's gradients and the
    trainer's update, to rtol 1e-5; the dark devices bitwise unchanged."""
    model, params, x, y, mask = _nn_fleet(6, B, 40, 24, dark=DARK[dark])
    before = {k: v.clone() for k, v in params.items()}
    got = {k: v.clone() for k, v in params.items()}
    _autograd_step(model, params, x, y, 0.05, mask)
    sim_nn_step_plain(got, x, y, 0.05, model.reg, mask)
    for k in params:
        torch.testing.assert_close(got[k], params[k], rtol=1e-5, atol=1e-7)
        for i in DARK[dark]:
            assert torch.equal(got[k][i], before[k][i])
        if dark != "all":
            assert not torch.equal(got[k], before[k])


@pytest.mark.parametrize("bad", [float("nan"), float("inf")])
@pytest.mark.parametrize("step", [sim_nn_step_plain, sim_nn_step])
def test_sim_nn_step_dark_device_holds_through_a_non_finite_minibatch(
        bad, step):
    """A non-finite value in a dark device's minibatch cannot reach its
    parameters (or anyone else's): it is left bitwise as it was."""
    model, params, x, y, mask = _nn_fleet(6, 8, 40, 24, dark=[3])
    x[3, 2, 5] = bad
    before = {k: v.clone() for k, v in params.items()}
    step(params, x, y, 0.05, model.reg, mask)
    for k, v in params.items():
        assert torch.equal(v[3], before[k][3])
        assert torch.isfinite(v).all()
        assert not torch.equal(v[4], before[k][4])


def test_sim_nn_cpu_tensors_take_the_plain_version():
    model, params, x, y, mask = _nn_fleet(6, 5, 40, 30, dark=[2])
    live = ~mask
    launches = (sim_nn_forward.launches, sim_nn_update.launches)
    leaves = (x, params["w1"], params["b1"], params["w2"], params["b2"])
    h, logits = sim_nn_forward(*leaves, live)
    plain_h, plain_logits = sim_nn_forward_plain(*leaves, live)
    assert torch.equal(h, plain_h) and torch.equal(logits, plain_logits)
    assert torch.equal(h[2], torch.zeros_like(h[2]))
    assert torch.equal(logits[2], params["b2"][2].expand(5, 10))
    dh = torch.randn_like(h)
    w1 = params["w1"].clone()
    sim_nn_update(params["w1"], x, dh, 0.05, model.reg, live)
    sim_nn_update_plain(w1, x, dh, 0.05, model.reg, live)
    assert torch.equal(params["w1"], w1)
    got = {k: v.clone() for k, v in params.items()}
    sim_nn_step(params, x, y, 0.05, model.reg, mask)
    sim_nn_step_plain(got, x, y, 0.05, model.reg, mask)
    for k in params:
        assert torch.equal(params[k], got[k])
    assert (sim_nn_forward.launches, sim_nn_update.launches) == launches
    # the model's fused step is this one
    again = {k: v.clone() for k, v in got.items()}
    model.step(got, x, y, 0.05, mask)
    sim_nn_step(again, x, y, 0.05, model.reg, mask)
    for k in got:
        assert torch.equal(got[k], again[k])


def test_sim_nn_wrappers_refuse_bad_inputs():
    _, params, x, y, _ = _nn_fleet(3, 4, 20, 16)
    w1, b1, w2, b2 = (params[k] for k in ("w1", "b1", "w2", "b2"))
    with pytest.raises(TypeError, match="float32"):
        sim_nn_forward(x.double(), w1.double(), b1.double(), w2, b2)
    with pytest.raises(ValueError, match="w1 must be"):
        sim_nn_forward(x, w1[:, :10], b1, w2, b2)
    with pytest.raises(ValueError, match="b1 must be"):
        sim_nn_forward(x, w1, b1[:, :8], w2, b2)
    with pytest.raises(ValueError, match="w2 must be"):
        sim_nn_forward(x, w1, b1, w2[:, :8], b2)
    with pytest.raises(ValueError, match="dh must be"):
        sim_nn_update(w1, x, torch.zeros((3, 5, 16)), 0.1, 1e-4)
    with pytest.raises(ValueError, match="live"):
        sim_nn_forward(x, w1, b1, w2, b2, torch.ones(3))
    assert BATCH_TILE == 16


@pytest.mark.parametrize("hidden,refused", [(30, True), (64, False),
                                            (7840, False)])
def test_sim_nn_step_check_refuses_what_the_kernels_cannot_run(hidden,
                                                               refused):
    """On the card the kernels take a hidden width that is a multiple of 4;
    the CPU's plain versions take any. The check says so before a run."""
    from repro_torch.models import make_sim_model
    model = make_sim_model("nn", 784, 10, hidden)
    for check in (lambda d: sim_nn_step_check(hidden, d), model.step_check):
        check("cpu")
        if refused:
            with pytest.raises(ValueError, match="multiple of 4"):
                check("cuda")
        else:
            check("cuda")
    assert make_sim_model("svm", 784, 10).step_check is None


@pytest.mark.parametrize("B", [16, 40])
def test_sim_nn_wrappers_on_fake_tensors_charge_their_work(B):
    """No launch; the work charged, w1's bytes once a batch tile of 16
    (the forward) and twice (the update)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    I, m, hid, C = 3, 40, 24, 10
    tiles = -(-B // BATCH_TILE)
    with FakeTensorMode():
        x = torch.empty((I, B, m))
        w1 = torch.empty((I, m, hid))
        b1 = torch.empty((I, hid))
        w2 = torch.empty((I, hid, C))
        b2 = torch.empty((I, C))
    charges = []
    launches = (sim_nn_forward.launches, sim_nn_update.launches)
    runtime.LISTENERS.append(lambda *c: charges.append(c))
    try:
        h, logits = sim_nn_forward(x, w1, b1, w2, b2)
        sim_nn_update(w1, x, h, 0.1, 1e-4)
    finally:
        runtime.LISTENERS.pop()
    assert tuple(h.shape) == (I, B, hid) and runtime.is_fake(h)
    assert tuple(logits.shape) == (I, B, C) and runtime.is_fake(logits)
    assert (sim_nn_forward.launches, sim_nn_update.launches) == launches
    w1_bytes = I * m * hid * 4
    assert charges == [
        ("sim_nn_forward", 2 * I * B * (m + C) * hid,
         (I * B * m + I * hid + I * hid * C + I * C + I * B * hid
          + I * B * C) * 4 + tiles * w1_bytes),
        ("sim_nn_update", 2 * I * B * m * hid + 4 * tiles * I * m * hid,
         (I * B * m + I * B * hid) * 4 + 2 * tiles * w1_bytes)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (runs on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_consensus_mix_kernel_on_card(cuda_device, dtype):
    for i, (N, s, M) in enumerate(SHAPES):
        z, V, gamma = _inputs(N, s, M, dtype, cuda_device, seed=i)
        before = consensus_mix.launches
        out = consensus_mix(z, V, gamma)
        torch.cuda.synchronize()
        assert consensus_mix.launches == before + 1
        np.testing.assert_allclose(
            out.float().cpu().numpy(),
            consensus_mix_plain(z, V, gamma).float().cpu().numpy(),
            atol=TOL[dtype])
        assert torch.equal(consensus_mix(z, V, 0), z)


@pytest.mark.cuda
def test_consensus_mix_kernel_with_a_masked_V_on_card(cuda_device):
    """The netsim path's V: ``masked_consensus_matrix`` gives a dark
    device an identity row and leaves a cluster with no device up the
    identity; the kernel holds both (the dark rows bitwise) and matches
    its plain version within 1e-5 in f32."""
    N, s, M = 6, 5, 1000
    z, V, gamma = _inputs(N, s, M, torch.float32, cuda_device, seed=11)
    up = torch.from_numpy(np.random.default_rng(11).random((N, s)) < 0.7)
    up[0, 1] = False                # at least one dark device
    up[2] = False                   # a cluster with none up
    up[3] = True
    Vm = masked_consensus_matrix(V, up.to(cuda_device)).contiguous()
    gamma = torch.tensor([3, 2, 4, 64, 0, 1], dtype=torch.int32,
                         device=cuda_device)
    out = consensus_mix(z, Vm, gamma)
    torch.cuda.synchronize()
    np.testing.assert_allclose(
        out.cpu().numpy(), consensus_mix_plain(z, Vm, gamma).cpu().numpy(),
        atol=TOL[torch.float32])
    dark = ~up.to(cuda_device)
    assert torch.equal(out[dark], z[dark])
    assert torch.equal(out[2], z[2])


@pytest.mark.cuda
def test_kernel_refuses_what_it_cannot_run(cuda_device):
    big = MAX_CLUSTER_SIZE + 1
    with pytest.raises(ValueError, match="exceeds"):
        consensus_mix(torch.zeros((1, big, 4), device=cuda_device),
                      torch.zeros((1, big, big), device=cuda_device), 1)
    z = torch.zeros((2, 3, 8), device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        consensus_mix(z[:, :, ::2], torch.zeros((2, 3, 3),
                                                device=cuda_device), 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("wd", [0.0, 0.1])
def test_fused_sgd_kernel_on_card(cuda_device, dtype, wd):
    eta = torch.tensor(0.01, device=cuda_device)
    for i, shape in enumerate(SGD_SHAPES):
        w, g = _sgd_inputs(shape, dtype, cuda_device, seed=i)
        before = fused_sgd.launches
        before_fcs = fused_consensus_sgd.launches
        out = fused_sgd(w, g, eta, weight_decay=wd)
        torch.cuda.synchronize()
        assert fused_sgd.launches == before + 1
        # a launch of the shared source counts as fused_sgd's only
        assert fused_consensus_sgd.launches == before_fcs
        assert out.dtype == dtype and out.shape == w.shape
        plain = fused_sgd_plain(w, g, eta, weight_decay=wd)
        np.testing.assert_allclose(
            out.float().cpu().numpy(), plain.float().cpu().numpy(),
            atol=SGD_TOL[dtype], rtol=SGD_TOL[dtype])
        if dtype == torch.float32:
            assert torch.equal(out, plain)      # one rounding, the same


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("wd", [0.0, 0.1])
def test_fused_sgd_kernel_at_every_offset_and_tail(cuda_device, dtype, wd):
    # sizes 1..33 around the vector width (4 f32, 8 bf16), at offsets 0
    # and 1 (big[1:]: a scalar head, then vectors), and with w and g at
    # different offsets mod 16 (the scalar loop)
    eta = torch.tensor(0.01, device=cuda_device)
    for n in range(1, 34):
        big, gbig = _sgd_inputs((n + 2,), dtype, cuda_device, seed=n)
        for w, g in ((big[:n], gbig[:n]), (big[1:n + 1], gbig[1:n + 1]),
                     (big[1:n + 1], gbig[2:n + 2])):
            before = fused_sgd.launches
            out = fused_sgd(w, g, eta, weight_decay=wd)
            torch.cuda.synchronize()
            assert fused_sgd.launches == before + 1
            assert out.data_ptr() % 16 == w.data_ptr() % 16
            plain = fused_sgd_plain(w, g, eta, weight_decay=wd)
            if dtype == torch.float32:
                assert torch.equal(out, plain), (n, w.data_ptr() % 16)
            else:
                np.testing.assert_allclose(
                    out.float().cpu().numpy(), plain.float().cpu().numpy(),
                    atol=SGD_TOL[dtype], rtol=SGD_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("wd", [0.0, 0.1])
def test_fused_consensus_sgd_kernel_on_card(cuda_device, dtype, wd):
    for i, (N, s, M) in enumerate(FCS_SHAPES):
        w, g, W = _fcs_inputs(N, s, M, dtype, cuda_device, seed=i)
        before = fused_consensus_sgd.launches
        out = fused_consensus_sgd(w, g, W, 0.01, weight_decay=wd)
        torch.cuda.synchronize()
        assert fused_consensus_sgd.launches == before + 1
        assert out.dtype == dtype and out.shape == w.shape
        np.testing.assert_allclose(
            out.float().cpu().numpy(),
            fused_consensus_sgd_plain(w, g, W, 0.01, weight_decay=wd)
            .float().cpu().numpy(),
            atol=SGD_TOL[dtype], rtol=SGD_TOL[dtype])


@pytest.mark.cuda
def test_fused_consensus_sgd_kernel_with_a_refreshed_W_on_card(cuda_device):
    """The scale path's refreshed W (netsim, the controller): the powers
    of a masked V with a Γ that differs per cluster (0 included, so one
    block is the identity), from ``refresh_matrices``; a dark device's
    row of W is e_i, so its column takes only its own SGD update."""
    N, s, M = 4, 2, 100_003
    w, g, _ = _fcs_inputs(N, s, M, torch.float32, cuda_device, seed=21)
    _, V, _ = _inputs(N, s, 1, torch.float32, "cpu", seed=21)
    up = np.ones((N, s), bool)
    up[3, 0] = False
    plan = build_mixing_plan(V.numpy(), 2, device=cuda_device)
    W = refresh_matrices(plan, V.numpy(), device_mask=up,
                         gamma=np.array([3, 0, 1, 2], np.int32))
    assert W.device.type == "cuda"
    assert torch.equal(W[1], torch.eye(s, device=cuda_device))
    before = fused_consensus_sgd.launches
    out = fused_consensus_sgd(w, g, W, 0.01)
    torch.cuda.synchronize()
    assert fused_consensus_sgd.launches == before + 1
    plain = fused_consensus_sgd_plain(w, g, W, 0.01)
    np.testing.assert_allclose(out.cpu().numpy(), plain.cpu().numpy(),
                               atol=SGD_TOL[torch.float32],
                               rtol=SGD_TOL[torch.float32])
    for c, i in ((1, 0), (1, 1), (3, 0)):
        np.testing.assert_allclose(out[c, i].cpu().numpy(),
                                   (w[c, i] - 0.01 * g[c, i]).cpu().numpy(),
                                   atol=SGD_TOL[torch.float32])


@pytest.mark.cuda
def test_fused_kernels_refuse_what_they_cannot_run(cuda_device):
    big = MAX_CLUSTER_SIZE + 1
    z = torch.zeros((1, big, 4), device=cuda_device)
    with pytest.raises(ValueError, match="exceeds"):
        fused_consensus_sgd(z, z, torch.zeros((1, big, big),
                                              device=cuda_device), 0.1)
    w = torch.zeros((2, 3, 8), device=cuda_device)
    W = torch.zeros((2, 3, 3), device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        fused_consensus_sgd(w[:, :, ::2], w[:, :, ::2], W, 0.1)
    with pytest.raises(ValueError, match="contiguous"):
        fused_sgd(w[:, :, ::2], w[:, :, ::2], 0.1)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fused_consensus_sgd(w.half(), w.half(), W, 0.1)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fused_sgd(w.half(), w.half(), 0.1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(PAGED_CASES) + sorted(SPLIT_CASES))
def test_paged_decode_kernel_on_card(cuda_device, dtype, case):
    *args, window = _paged_inputs(case, dtype, cuda_device)
    before = paged_decode.launches
    out = paged_decode(*args, window=window)
    torch.cuda.synchronize()
    assert paged_decode.launches == before + 1
    assert out.dtype == torch.float32 and out.shape == args[0].shape
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(
        out.cpu().numpy(),
        paged_decode_plain(*args, window=window).cpu().numpy(),
        atol=1e-5, rtol=0)
    # the merge's order is fixed: a second launch gives the same bits
    assert torch.equal(paged_decode(*args, window=window), out)


@pytest.mark.cuda
def test_paged_decode_refuses_what_it_cannot_run(cuda_device):
    q, kp, vp, pm, pos, _ = _paged_inputs("reference", torch.float32,
                                          cuda_device)
    B, K, _, _ = q.shape
    big = MAX_HEAD_DIM + 1
    with pytest.raises(ValueError, match="head_dim"):
        paged_decode(torch.zeros((B, K, 1, big), device=cuda_device),
                     torch.zeros((4, 4, K, big), device=cuda_device),
                     torch.zeros((4, 4, K, big), device=cuda_device), pm, pos)
    with pytest.raises(ValueError, match="query heads"):
        paged_decode(torch.zeros((B, K, MAX_GROUP + 1, 8),
                                 device=cuda_device), kp, vp, pm, pos)
    with pytest.raises(ValueError, match="contiguous"):
        paged_decode(q.transpose(1, 2).contiguous().transpose(1, 2), kp, vp,
                     pm, pos)
    with pytest.raises(ValueError, match="share a device"):
        paged_decode(q, kp, vp, pm.cpu(), pos)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_kernel_on_card(cuda_device, dtype):
    for i, (BH, T, P, S, chunk) in enumerate(SSD_SHAPES):
        args = _ssd_inputs(BH, T, P, S, dtype, cuda_device, seed=i)
        before = ssd_scan.launches
        y, h = ssd_scan(*args, chunk=chunk)
        torch.cuda.synchronize()
        assert ssd_scan.launches == before + 1
        assert y.dtype == dtype and y.shape == (BH, T, P)
        yp, hp = ssd_scan_plain(*args, chunk=chunk)
        err = float((y.float() - yp.float()).abs().max())
        scale = float(yp.float().abs().max())
        assert err <= (1e-4 if dtype == torch.float32 else 1e-2) * scale, \
            (BH, T, P, S, chunk, err, scale)
        np.testing.assert_allclose(h.cpu().numpy(), hp.cpu().numpy(),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SSD_GROUP_SHAPES + SSD_GROUP_CARD_SHAPES)
def test_ssd_scan_grouped_kernel_on_card(cuda_device, dtype, shape):
    """The grouped call (B/C once per batch element) and ssd_scan_heads
    on the model's layout against ssd_chunked, at the test shapes, the
    serve path's admission and the forward shape's rows; a second launch
    gives the same bits."""
    b, H, T, P, S, chunk = shape
    x, dt, loga, B, C = _ssd_group_inputs(b, H, T, P, S, dtype, cuda_device,
                                          seed=3)
    xh, dth, lah = _to_heads(x, dt, loga, b, H)
    yp, hp = ssd_chunked(xh, dth, lah, B, C, chunk=chunk)
    yp = yp.transpose(1, 2).reshape(b * H, T, P)
    hp = hp.reshape(b * H, S, P)
    scale = float(yp.float().abs().max())
    tol = (1e-4 if dtype == torch.float32 else 1e-2) * scale
    before = ssd_scan.launches
    y, h = ssd_scan(x, dt, loga, B, C, chunk=chunk, heads_per_group=H)
    y2, h2 = ssd_scan(x, dt, loga, B, C, chunk=chunk, heads_per_group=H)
    yh, hh = ssd_scan_heads(xh, dth, lah, B, C, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 3
    assert torch.equal(y, y2) and torch.equal(h, h2)
    assert yh.shape == (b, T, H, P) and hh.shape == (b, H, S, P)
    for yy, hhh in ((y, h), (yh.transpose(1, 2).reshape(b * H, T, P),
                             hh.reshape(b * H, S, P))):
        assert yy.dtype == dtype
        err = float((yy.float() - yp.float()).abs().max())
        assert err <= tol, (shape, err, scale)
        np.testing.assert_allclose(hhh.cpu().numpy(), hp.cpu().numpy(),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_ssd_scan_shared_memory_fits_two_blocks_an_sm(cuda_device):
    """The CUDA source's layouts, read through the library: at S 128 and Q
    256 in f32 the larger block takes 80 KB, so that two fit an H100 SM
    (228 KB, 1 KB reserved a block); bf16 takes less, and a 4096-row
    chunk more than a block may have."""
    assert smem_bytes(128, 256) == 81_920
    assert 2 * (smem_bytes(128, 256) + 1024) <= 233_472
    assert smem_bytes(128, 256, 2) < smem_bytes(128, 256)
    assert smem_bytes(16, 4096) > 232_448


@pytest.mark.cuda
def test_ssd_scan_refuses_what_it_cannot_run(cuda_device):
    x, dt, loga, B, C = _ssd_inputs(2, 64, 16, 16, torch.float32,
                                    cuda_device)
    with pytest.raises(ValueError, match="multiple of"):
        ssd_scan(x[..., :P_TILE - 4].contiguous(), dt, loga, B, C, chunk=16)
    big = torch.zeros((2, 64, MAX_STATE + 4), device=cuda_device)
    with pytest.raises(ValueError, match="state size"):
        ssd_scan(x, dt, loga, big, big, chunk=16)
    with pytest.raises(ValueError, match="shared memory"):
        ssd_scan(x, dt, loga, B, C, chunk=4096)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_scan(x.transpose(0, 1).contiguous().transpose(0, 1), dt, loga,
                 B, C, chunk=16)
    with pytest.raises(ValueError, match="share a device"):
        ssd_scan(x, dt.cpu(), loga, B, C, chunk=16)
    flat = torch.zeros(2 * 64 * 16 + 1, device=cuda_device)
    with pytest.raises(ValueError, match="aligned"):
        ssd_scan(flat[1:].view(2, 64, 16), dt, loga, B, C, chunk=16)


# the sim step's kernels: (I, B, m, hidden) with hidden not a multiple of
# the 512-column tile, B padded to 4, 8 or 16 (5, 3, 1), B over the batch
# tile of 16 (32 and 40: two and three launches a call), and one device of
# the main path's shape
SIM_NN_SHAPES = [(3, 5, 37, 1000), (2, 16, 50, 76), (2, 1, 300, 600),
                 (4, 32, 20, 132), (3, 3, 129, 516), (2, 40, 30, 516),
                 (1, 16, 784, 7840)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SIM_NN_SHAPES)
@pytest.mark.parametrize("dark", ["none", "some"])
def test_sim_nn_kernels_on_card(cuda_device, shape, dark):
    """Each kernel against its plain version (float32, no TF32: the
    forward's, the logits' and the B-term sums differ in order only), the
    dark devices' rows of H zeros, their logits b2 and their w1 bitwise as
    it was; then the whole step against its plain version."""
    I, B, m, hid = shape
    off = [1] if dark == "some" and I > 1 else []
    model, params, x, y, mask = _nn_fleet(I, B, m, hid, cuda_device,
                                          seed=sum(shape), dark=off)
    live = None if mask is None else ~mask
    w1 = params["w1"]
    leaves = (x, w1, params["b1"], params["w2"], params["b2"])
    tiles = -(-B // BATCH_TILE)
    before = sim_nn_forward.launches
    h, logits = sim_nn_forward(*leaves, live)
    torch.cuda.synchronize()
    assert sim_nn_forward.launches == before + tiles
    plain_h, plain_logits = sim_nn_forward_plain(*leaves, live)
    torch.testing.assert_close(h, plain_h, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(logits, plain_logits, rtol=1e-5, atol=1e-5)
    for i in off:
        assert torch.equal(h[i], torch.zeros_like(h[i]))
        assert torch.equal(logits[i], params["b2"][i].expand(B, 10))
    dh = torch.randn(h.shape, generator=torch.Generator().manual_seed(I)
                     ).to(cuda_device) * (h > 0)
    plain = w1.clone()
    sim_nn_update_plain(plain, x, dh, 0.05, model.reg, live)
    keep = w1.clone()
    before = sim_nn_update.launches
    sim_nn_update(w1, x, dh, 0.05, model.reg, live)
    torch.cuda.synchronize()
    assert sim_nn_update.launches == before + tiles
    torch.testing.assert_close(w1, plain, rtol=SGD_TOL[torch.float32],
                               atol=SGD_TOL[torch.float32])
    for i in off:
        assert torch.equal(w1[i], keep[i])
    # the whole step: the forward's order of summation (up to 5.5e-6 of
    # H at the main shape) reaches w2's update through layer 2, so the
    # leaves are held to the forward's 1e-5
    got = {k: v.clone() for k, v in params.items()}
    sim_nn_step(params, x, y, 0.05, model.reg, mask)
    sim_nn_step_plain(got, x, y, 0.05, model.reg, mask)
    torch.cuda.synchronize()
    for k in params:
        torch.testing.assert_close(params[k], got[k], rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 16, 40, 24), (2, 40, 30, 516)])
def test_sim_nn_update_applies_the_l2_term_on_card(cuda_device, shape):
    """At a large reg and eta the L2 term moves w1 far beyond the update's
    tolerance: the kernel matches the plain update with it and misses the
    plain update without it, so a kernel that drops ``reg * w1`` fails
    (with B over the batch tile, the term is taken once, not a tile)."""
    I, B, m, hid = shape
    _, params, x, _, _ = _nn_fleet(I, B, m, hid, cuda_device, seed=B)
    w1 = params["w1"]
    dh = torch.randn((I, B, hid), generator=torch.Generator().manual_seed(3)
                     ).to(cuda_device) * 0.01
    eta, reg = 0.5, 0.5
    plain, no_l2 = w1.clone(), w1.clone()
    sim_nn_update_plain(plain, x, dh, eta, reg)
    sim_nn_update_plain(no_l2, x, dh, eta, 0.0)
    sim_nn_update(w1, x, dh, eta, reg)
    torch.cuda.synchronize()
    tol = SGD_TOL[torch.float32]
    torch.testing.assert_close(w1, plain, rtol=tol, atol=tol)
    assert not torch.allclose(w1, no_l2, rtol=tol, atol=tol)


@pytest.mark.cuda
def test_sim_nn_kernels_refuse_what_they_cannot_run(cuda_device):
    _, p, x, y, _ = _nn_fleet(2, 4, 20, 30, cuda_device)
    with pytest.raises(ValueError, match="multiple of 4"):
        sim_nn_forward(x, p["w1"], p["b1"], p["w2"], p["b2"])
    with pytest.raises(ValueError, match="multiple of 4"):
        sim_nn_update(p["w1"], x, torch.zeros((2, 4, 30), device=x.device),
                      0.1, 1e-4)
    _, p, x, y, _ = _nn_fleet(2, 4, 20, 16, cuda_device)
    with pytest.raises(ValueError, match="aligned"):
        flat = torch.zeros(2 * 20 * 16 + 1, device=x.device)
        sim_nn_forward(x, flat[1:].view(2, 20, 16), p["b1"], p["w2"],
                       p["b2"])
    with pytest.raises(ValueError, match="contiguous"):
        sim_nn_forward(x, p["w1"].transpose(1, 2).contiguous()
                       .transpose(1, 2), p["b1"], p["w2"], p["b2"])


@pytest.mark.cuda
@pytest.mark.parametrize("scenario", ["static", "device_churn"])
def test_sim_nn_launches_over_a_sim_run_on_card(cuda_device, scenario):
    """A 20-step sim run of ``nn`` under ``use_kernel=True`` launches each
    of the two kernels once a step, dark devices or not; ``svm`` none."""
    from repro_torch.configs import TopologyConfig, TTHFConfig
    from repro_torch.core import TTHFTrainer
    from repro_torch.data import fashion_synth, partition_noniid_labels
    from repro_torch.models import make_sim_model
    from repro_torch.netsim import scenarios
    xs, ys = fashion_synth(num_points=2000, seed=1)
    data = partition_noniid_labels(xs, ys, num_devices=25, seed=1)
    topo = TopologyConfig(num_devices=25, num_clusters=5, seed=1)
    algo = TTHFConfig(tau=10, consensus_every=5, gamma_d2d=2,
                      constant_lr=2e-3)
    dyn = None if scenario == "static" else scenarios.get(scenario, seed=1)
    for name, per_step in (("nn", 1), ("svm", 0)):
        tr = TTHFTrainer(make_sim_model(name, 784, 10, 64), data, topo,
                         algo, batch_size=8, use_kernel=True, dynamics=dyn,
                         device=cuda_device)
        sim_nn_forward.launches = sim_nn_update.launches = 0
        _, hist = tr.run(steps=20, seed=0, eval_every=10)
        torch.cuda.synchronize()
        assert np.isfinite(hist.global_loss).all()
        assert sim_nn_forward.launches == sim_nn_update.launches \
            == 20 * per_step
