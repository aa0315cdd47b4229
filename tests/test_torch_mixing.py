"""Mixing engine, consensus metrics and aggregations of the PyTorch port
against the JAX reference, on the CPU.

Every port backend is held against the reference's same backend (the
JAX ``pallas`` backend runs its kernel in interpret mode, as
``tests/test_kernels.py`` does) and the port's ``consensus_mix``
wrapper against ``repro.kernels.ref.consensus_mix_ref``. Tolerances are
the reference's: 1e-5 in float32, 2e-2 in bfloat16
(``tests/test_kernels.py``). In bfloat16 the ``masked_loop`` backend
rounds after every round while the kernel and the oracle keep float32
across rounds, so each is compared with its own counterpart.

The kernel itself, on the card, is held against its plain version in
``tests/test_torch_kernels.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import consensus as j_cns
from repro.core import mixing as j_mixing
from repro.core import sampling as j_smp
from repro.core.topology import geometric_adjacency, metropolis_weights
from repro.kernels import ref as j_ref

from repro_torch.core import consensus as cns
from repro_torch.core import mixing
from repro_torch.core import sampling as smp
from repro_torch.core.topology import Network
from repro_torch.kernels.consensus_mix import (
    MAX_CLUSTER_SIZE, consensus_mix, consensus_mix_plain)

SHAPES = [(1, 2, 8), (3, 5, 100), (4, 8, 700), (2, 5, 513), (25, 5, 64)]
DTYPES = {"float32": (torch.float32, jnp.float32, 1e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 2e-2)}


def _inputs(N, s, M, seed=0, gmax=6):
    """z, V, gamma from one numpy seed; gamma heterogeneous with a 0."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(N, s, M)).astype(np.float32)
    V = np.stack([metropolis_weights(geometric_adjacency(s, 0.9, rng))
                  for _ in range(N)]).astype(np.float32)
    gamma = rng.integers(0, gmax, size=(N,)).astype(np.int32)
    gamma[0] = 0
    return z, V, gamma


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      np.asarray(x, np.float32), np.float32)


@pytest.mark.parametrize("N,s,M", SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_consensus_mix_wrapper_vs_reference_oracle(N, s, M, dtype):
    tdt, jdt, tol = DTYPES[dtype]
    z, V, gamma = _inputs(N, s, M)
    expect = j_ref.consensus_mix_ref(jnp.asarray(z, jdt), jnp.asarray(V),
                                     jnp.asarray(gamma))
    zt = torch.from_numpy(z).to(tdt)
    out = consensus_mix(zt, torch.from_numpy(V), torch.from_numpy(gamma))
    assert out.dtype == tdt and out.shape == (N, s, M)
    np.testing.assert_allclose(_np(out), _np(expect), atol=tol)
    np.testing.assert_allclose(
        _np(consensus_mix_plain(zt, torch.from_numpy(V), gamma)),
        _np(expect), atol=tol)


@pytest.mark.parametrize("backend", mixing.BACKENDS)
@pytest.mark.parametrize("N,s,M", [(3, 5, 100), (4, 8, 700), (25, 5, 64)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_backend_parity_with_reference_backend(backend, N, s, M, dtype):
    tdt, jdt, tol = DTYPES[dtype]
    z, V, gamma = _inputs(N, s, M, seed=N)
    expect = j_mixing.mix(jnp.asarray(z, jdt), jnp.asarray(V),
                          jnp.asarray(gamma), backend=backend)
    out = mixing.mix(torch.from_numpy(z).to(tdt), torch.from_numpy(V),
                     torch.from_numpy(gamma), backend=backend)
    assert out.dtype == tdt
    np.testing.assert_allclose(_np(out), _np(expect), atol=tol)


@pytest.mark.parametrize("backend", mixing.BACKENDS)
def test_gamma_zero_and_heterogeneous_gamma(backend):
    z, V, _ = _inputs(4, 5, 96, seed=7)
    gamma = np.array([0, 3, 0, 9], np.int32)
    expect = j_ref.consensus_mix_ref(jnp.asarray(z), jnp.asarray(V),
                                     jnp.asarray(gamma))
    out = mixing.mix(torch.from_numpy(z), torch.from_numpy(V),
                     torch.from_numpy(gamma), backend=backend)
    np.testing.assert_allclose(out.numpy(), np.asarray(expect), atol=1e-5)
    assert np.array_equal(out.numpy()[[0, 2]], z[[0, 2]])
    # Γ = 0 everywhere leaves bf16 values unchanged, bit for bit
    zb = torch.from_numpy(z).to(torch.bfloat16)
    same = mixing.mix(zb, torch.from_numpy(V), 0, backend=backend)
    assert same.dtype == torch.bfloat16 and torch.equal(same, zb)


@pytest.mark.parametrize("backend", mixing.BACKENDS)
def test_device_mask_parity(backend):
    z, V, gamma = _inputs(3, 5, 40, seed=11)
    mask = np.random.default_rng(11).random((3, 5)) > 0.3
    expect = j_mixing.mix(jnp.asarray(z), jnp.asarray(V), jnp.asarray(gamma),
                          backend=backend, device_mask=jnp.asarray(mask))
    out = mixing.mix(torch.from_numpy(z), torch.from_numpy(V),
                     torch.from_numpy(gamma), backend=backend,
                     device_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(expect), atol=1e-5)
    dropped = ~mask
    assert np.array_equal(out.numpy()[dropped], z[dropped])


def test_masked_matrix_and_powers():
    _, V, gamma = _inputs(5, 6, 1, seed=3, gmax=9)
    mask = np.random.default_rng(3).random((5, 6)) > 0.4
    np.testing.assert_allclose(
        mixing.masked_consensus_matrix(torch.from_numpy(V),
                                       torch.from_numpy(mask)).numpy(),
        np.asarray(j_mixing.masked_consensus_matrix(jnp.asarray(V),
                                                    jnp.asarray(mask))),
        atol=1e-7)
    np.testing.assert_allclose(
        mixing.matrix_powers(torch.from_numpy(V),
                             torch.from_numpy(gamma)).numpy(),
        np.asarray(j_mixing.matrix_powers(jnp.asarray(V),
                                          jnp.asarray(gamma))),
        atol=1e-6)


def _net(N, s, seed):
    _, V, _ = _inputs(N, s, 1, seed=seed)
    return Network(V=V, adj=V > 0, lambdas=np.zeros(N), num_clusters=N,
                   cluster_size=s)


@pytest.mark.parametrize("backend", mixing.BACKENDS)
def test_mixing_plan_parity(backend):
    N, s = 3, 4
    net = _net(N, s, 5)
    gamma = np.array([2, 0, 5], np.int32)
    ref_plan = j_mixing.build_mixing_plan(net, gamma, backend=backend)
    plan = mixing.build_mixing_plan(net, gamma, backend=backend,
                                    device="cpu")
    assert plan.backend == ref_plan.backend
    assert np.array_equal(plan.gamma.numpy(), np.asarray(ref_plan.gamma))
    if backend == "fused_power":
        assert np.array_equal(plan.W.numpy(), np.asarray(ref_plan.W))
    rng = np.random.default_rng(5)
    params = {"a": rng.normal(size=(N * s, 3, 7)).astype(np.float32),
              "b": rng.normal(size=(N * s,)).astype(np.float32)}
    expect = ref_plan.apply_pytree({k: jnp.asarray(v)
                                    for k, v in params.items()})
    got = plan.apply_pytree({k: torch.from_numpy(v)
                             for k, v in params.items()})
    for k in params:
        assert got[k].shape == params[k].shape
        np.testing.assert_allclose(got[k].numpy(), np.asarray(expect[k]),
                                   atol=1e-5)
    # per-event refreshes: masked V (and exact powers for fused_power)
    mask = np.ones((N, s), bool)
    mask[1, 2] = False
    ref_r = j_mixing.refresh_matrices(ref_plan, net.V, device_mask=mask)
    got_r = mixing.refresh_matrices(plan, net.V, device_mask=mask)
    np.testing.assert_allclose(got_r.numpy(), np.asarray(ref_r), atol=1e-7)
    assert mixing.build_mixing_plan(net, 0, backend=backend,
                                    device="cpu").is_noop


def test_backend_aliases_and_errors():
    for alias, name in (("kernel", "pallas"), ("fused", "fused_power"),
                        ("rounds", "reference")):
        assert mixing.canonical_backend(alias) == name == \
            j_mixing.canonical_backend(alias)
    with pytest.raises(ValueError):
        mixing.canonical_backend("nope")
    z, V, _ = _inputs(2, 3, 5)
    with pytest.raises(ValueError):
        mixing.mix(torch.from_numpy(z), torch.from_numpy(V), [1, 2, 3])
    with pytest.raises(ValueError):
        consensus_mix(torch.from_numpy(z), torch.from_numpy(V)[:1], 1)
    with pytest.raises(TypeError):
        consensus_mix(torch.from_numpy(z).double(), torch.from_numpy(V), 1)
    # no quiet fallback to the plain version off the CPU and the card
    with pytest.raises(ValueError, match="cpu or cuda"):
        consensus_mix(torch.empty((2, 3, 5), device="meta"),
                      torch.empty((2, 3, 3), device="meta"), 1)
    assert MAX_CLUSTER_SIZE >= 16


def test_consensus_api_and_metrics():
    z, V, gamma = _inputs(4, 5, 33, seed=2)
    zj, zt = jnp.asarray(z), torch.from_numpy(z)
    for uk in (False, True):
        np.testing.assert_allclose(
            cns.mix(zt, torch.from_numpy(V), torch.from_numpy(gamma),
                    use_kernel=uk).numpy(),
            np.asarray(j_cns.mix(zj, jnp.asarray(V), jnp.asarray(gamma),
                                 use_kernel=uk)), atol=1e-5)
    np.testing.assert_allclose(
        cns.mix_once(zt, torch.from_numpy(V)).numpy(),
        np.asarray(j_cns.mix_once(zj, jnp.asarray(V))), atol=1e-6)
    for name in ("cluster_means", "consensus_error", "divergence_upsilon"):
        np.testing.assert_allclose(
            getattr(cns, name)(zt).numpy(),
            np.asarray(getattr(j_cns, name)(zj)), rtol=1e-6, atol=1e-6)
    mask = np.random.default_rng(2).random((4, 5)) > 0.5
    mask[0] = [True, False, False, False, False]       # < 2 active: 0
    np.testing.assert_allclose(
        cns.masked_divergence_upsilon(zt, torch.from_numpy(mask)).numpy(),
        np.asarray(j_cns.masked_divergence_upsilon(zj, jnp.asarray(mask))),
        atol=1e-6)
    params = {"w": z.reshape(20, 33)[:, :30].reshape(20, 5, 6),
              "b": z.reshape(20, 33)[:, 30]}
    expect = j_cns.mix_pytree({k: jnp.asarray(v) for k, v in params.items()},
                              jnp.asarray(V), jnp.asarray(gamma), 4)
    got = cns.mix_pytree({k: torch.from_numpy(np.ascontiguousarray(v))
                          for k, v in params.items()},
                         torch.from_numpy(V), torch.from_numpy(gamma), 4,
                         use_kernel=True)
    for k in params:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(expect[k]),
                                   atol=1e-5)


@pytest.mark.parametrize("k", [1, 2, 5])
def test_aggregations_parity(k):
    N, s = 5, 5
    rng = np.random.default_rng(k)
    params = {"b": rng.normal(size=(N * s, 10)).astype(np.float32),
              "w": rng.normal(size=(N * s, 6, 10)).astype(np.float32)}
    varrho = np.full((N,), 1 / N, np.float32)
    picks = np.stack([rng.permutation(s)[:k] for _ in range(N)])
    if k == 1:
        picks = picks[:, 0]
    jp = {kk: jnp.asarray(v) for kk, v in params.items()}
    tp = {kk: torch.from_numpy(v) for kk, v in params.items()}
    pairs = [
        (j_smp.sampled_global_pytree(jp, jnp.asarray(picks),
                                     jnp.asarray(varrho), N),
         smp.sampled_global_pytree(tp, torch.from_numpy(picks),
                                   torch.from_numpy(varrho), N)),
        (j_smp.full_global_pytree(jp, jnp.asarray(varrho), N),
         smp.full_global_pytree(tp, torch.from_numpy(varrho), N)),
        (j_smp.broadcast_pytree(jp, 3), smp.broadcast_pytree(tp, 3)),
    ]
    for expect, got in pairs:
        for kk in params:
            assert got[kk].shape == expect[kk].shape
            np.testing.assert_allclose(got[kk].numpy(),
                                       np.asarray(expect[kk]), atol=1e-6)


def test_default_draws_shapes_and_ranges():
    draws = smp.TorchDraws(torch.Generator().manual_seed(0))
    idx = draws.minibatch(7, 4, 30)
    assert idx.shape == (7, 4) and 0 <= int(idx.min()) and int(idx.max()) < 30
    assert draws.picks(6, 5, 1).shape == (6,)
    multi = draws.picks(6, 5, 3)
    assert multi.shape == (6, 3)
    assert all(len(set(row.tolist())) == 3 for row in multi)
    with pytest.raises(ValueError):
        smp.sample_devices_multi(draws.generator, 6, 5, 6)
