"""The port's kernels against their plain versions. This file imports
no JAX, so it also runs on the machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels.py

Tests marked ``cuda`` need an NVIDIA GPU and ``nvcc`` and skip without
one. On the CPU the wrapper's contract is checked: CPU tensors take the
plain version and do not count as launches. Tolerances: 1e-5 in float32,
2e-2 in bfloat16 (the reference's, ``tests/test_kernels.py``).
"""
import numpy as np
import pytest
import torch

from repro_torch.core.topology import geometric_adjacency, metropolis_weights
from repro_torch.kernels import build
from repro_torch.kernels.consensus_mix import (
    MAX_CLUSTER_SIZE, consensus_mix, consensus_mix_plain)

SHAPES = [(1, 2, 8), (3, 5, 100), (4, 8, 700), (2, 5, 513), (25, 5, 64),
          (25, 5, 10), (2, MAX_CLUSTER_SIZE, 300)]
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


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


def test_build_names_the_sources():
    assert "consensus_mix" in build.sources()
    lib = build.library_path("consensus_mix")
    assert lib.name.startswith("libconsensus_mix-") and lib.suffix == ".so"
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
