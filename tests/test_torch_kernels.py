"""The port's kernels against their plain versions. This file imports
no JAX, so it also runs on the machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels.py

Tests marked ``cuda`` need an NVIDIA GPU and ``nvcc`` and skip without
one. On the CPU the wrapper's contract is checked: CPU tensors take the
plain version and do not count as launches. Tolerances are the
reference's (``tests/test_kernels.py``): ``consensus_mix`` 1e-5 in
float32 and 2e-2 in bfloat16; ``fused_sgd`` and ``fused_consensus_sgd``
1e-6 in float32 and 1e-2 in bfloat16 (atol and rtol).
"""
import numpy as np
import pytest
import torch

from repro_torch.core.topology import geometric_adjacency, metropolis_weights
from repro_torch.kernels import build
from repro_torch.core.mixing import matrix_powers
from repro_torch.kernels.consensus_mix import (
    MAX_CLUSTER_SIZE, consensus_mix, consensus_mix_plain)
from repro_torch.kernels.fused_consensus_sgd import (
    fused_consensus_sgd, fused_consensus_sgd_plain)
from repro_torch.kernels.fused_sgd import fused_sgd, fused_sgd_plain

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


def test_build_names_the_sources():
    # fused_sgd launches fused_consensus_sgd.cu's one-replica instance
    assert build.sources() == ["consensus_mix", "fused_consensus_sgd"]
    for name in build.sources():
        lib = build.library_path(name)
        assert lib.name.startswith(f"lib{name}-") and lib.suffix == ".so"
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS


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
        # the shared kernel's launch counts as fused_sgd's only
        assert fused_consensus_sgd.launches == before_fcs
        assert out.dtype == dtype and out.shape == w.shape
        np.testing.assert_allclose(
            out.float().cpu().numpy(),
            fused_sgd_plain(w, g, eta, weight_decay=wd).float().cpu().numpy(),
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
