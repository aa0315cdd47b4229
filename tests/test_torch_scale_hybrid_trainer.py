"""The port's ``ScaleTrainer`` and scale CLI on the hybrid kind
(recurrentgemma-9b) against the reference's on the CPU, with the reduced
5-layer config of ``tests/test_torch_scale.py``'s ``_ARCHS["hybrid"]``
(one ``(rec, rec, attn)`` group and a tail of two, window 8): the
per-leaf and the fused trainer over 3 intervals with the reference's
draws replayed (losses rtol 1e-4, the served model atol 1e-5, the
ledger and draw counters exactly); and the observability sink's
divergence probe over a fleet of hybrid replicas and its flat carrier
against the reference's: rtol 1e-4, the tolerance
``tests/test_torch_obs.py`` holds an instrumented run's probes to. Its
rtol 1e-5 for a two-leaf fleet does not hold for float32 sums over a
model's every leaf: under one torch thread a worker, the sums over this
tree part from XLA's by 2.5e-5.
"""
import _torch_threads  # noqa: F401  (torch threads per xdist worker)

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_arch as j_get_arch
from repro.models import build_model as j_build_model
from repro.obs import telemetry as j_tel

from repro_torch.configs import get_arch
from repro_torch.core import distributed as dist
from repro_torch.models import build_model, params_from_jax
from repro_torch.obs import telemetry

from test_torch_scale import _R, _check_scale_trainer

ARCH = "recurrentgemma-9b"


@pytest.mark.parametrize("fused_interval", [False, True])
def test_hybrid_scale_trainer_matches_reference(fused_interval, capsys):
    _check_scale_trainer(fused_interval, capsys, "hybrid")


def test_divergence_probe_takes_the_hybrid_tree():
    """The observability sink's divergence probe over a fleet of hybrid
    replicas (``groups`` and ``tail`` leaves) and over its flat (R, P)
    carrier, against the reference's probe of the same tree."""
    cfg = get_arch(ARCH).reduced(num_layers=5, d_model=32, d_ff=32,
                                 vocab_size=32)
    shapes, _ = j_build_model(j_get_arch(ARCH).reduced(
        num_layers=5, d_model=32, d_ff=32, vocab_size=32)).abstract_params()
    rng = np.random.default_rng(0)
    jfleet = jax.tree.map(
        lambda v: rng.normal(size=(_R,) + v.shape).astype(np.float32),
        shapes)
    fleet = params_from_jax(jfleet, "cpu")
    assert sorted(fleet) == ["embed", "groups", "ln_final", "tail"]
    varrho = np.full(2, 0.5)
    probe = telemetry.make_divergence_probe(2, 2, varrho)
    want = j_tel.make_divergence_probe(2, 2, varrho)(
        jax.tree.map(jnp.asarray, jfleet))
    spec = dist.FlatParamSpec.for_model(build_model(cfg))
    for got in (probe(fleet), probe(spec.flatten(fleet)[:, :spec.total])):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-4)
