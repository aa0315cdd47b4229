"""Sim models of the PyTorch port against the JAX reference: per-device
losses and gradients (the port's one autograd call over the fleet
against ``vmap(grad(loss))``) at weights carried by ``params_from_jax``.

Tolerance: rtol 1e-5 / atol 1e-6 — float32 products summed in another
order on the two sides."""
import _torch_threads  # noqa: F401  (torch threads per xdist worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import simple as j_simple

from repro_torch.models import simple

TOL = dict(rtol=1e-5, atol=1e-6)


def _fleet(name, I=4, B=9, dim=49, C=10, hidden=24, seed=0):
    """Per-device parameters (the reference init plus a per-device
    perturbation), inputs and labels from one numpy seed."""
    rng = np.random.default_rng(seed)
    jm = j_simple.make_sim_model(name, dim, C, hidden)
    w0 = jm.init(jax.random.PRNGKey(seed))
    params = {k: (np.asarray(v)[None]
                  + 0.05 * rng.normal(size=(I,) + v.shape)).astype(np.float32)
              for k, v in w0.items()}
    x = rng.random((I, B, dim)).astype(np.float32)
    y = rng.integers(0, C, size=(I, B)).astype(np.int32)
    pm = simple.make_sim_model(name, dim, C, hidden)
    return jm, pm, params, x, y


@pytest.mark.parametrize("name", ["svm", "nn"])
@pytest.mark.parametrize("seed", [0, 1])
def test_per_device_loss_and_grads(name, seed):
    jm, pm, params, x, y = _fleet(name, seed=seed)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    ref_loss = jax.vmap(jm.loss)(jp, jnp.asarray(x), jnp.asarray(y))
    ref_grad = jax.vmap(jax.grad(jm.loss))(jp, jnp.asarray(x),
                                           jnp.asarray(y))
    tp = simple.params_from_jax(params, "cpu")
    xt, yt = torch.from_numpy(x), torch.from_numpy(y).long()
    np.testing.assert_allclose(pm.loss(tp, xt, yt).detach().numpy(),
                               np.asarray(ref_loss), **TOL)
    grads = pm.grads(tp, xt, yt)
    assert list(grads) == sorted(params)
    for k in params:
        assert grads[k].shape == params[k].shape
        np.testing.assert_allclose(grads[k].numpy(), np.asarray(ref_grad[k]),
                                   **TOL)


@pytest.mark.parametrize("name", ["svm", "nn"])
def test_accuracy_matches(name):
    jm, pm, params, x, y = _fleet(name, I=1, B=200)
    one = {k: v[0] for k, v in params.items()}
    ref = jm.accuracy({k: jnp.asarray(v) for k, v in one.items()},
                      jnp.asarray(x[0]), jnp.asarray(y[0]))
    got = pm.accuracy(simple.params_from_jax(params, "cpu"),
                      torch.from_numpy(x), torch.from_numpy(y).long())
    assert float(got) == float(ref)


@pytest.mark.parametrize("name", ["svm", "nn"])
def test_init_and_carried_weights(name):
    jm = j_simple.make_sim_model(name, 49, 10, 24)
    w0 = {k: np.asarray(v) for k, v in jm.init(jax.random.PRNGKey(3)).items()}
    carried = simple.params_from_jax(w0, "cpu")
    assert list(carried) == sorted(w0)
    for k, v in w0.items():
        assert carried[k].dtype == torch.float32
        assert np.array_equal(carried[k].numpy(), v)
    own = simple.make_sim_model(name, 49, 10, 24).init(
        torch.Generator().manual_seed(3), "cpu")
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: v.shape for k, v in w0.items()}
    with pytest.raises(ValueError):
        simple.make_sim_model("cnn", 49, 10)
