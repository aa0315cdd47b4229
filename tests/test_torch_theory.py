"""``repro_torch.core.theory`` is a numpy copy of ``repro.core.theory``:
every calculator and estimator gives exactly the reference's value on
the same seeded inputs, and both raise alike."""
import _torch_threads  # noqa: F401  (torch threads per xdist worker)
import dataclasses

import numpy as np
import pytest

from repro.core import theory as ref

from repro_torch import core as port_core
from repro_torch.core import theory

KS = [dict(mu=0.1, beta=1.0, sigma=0.5, delta=0.3, varrho_min=0.04),
      dict(mu=0.5, beta=2.0, sigma=1.0, delta=0.0, varrho_min=0.2),
      dict(mu=0.01, beta=0.3, sigma=0.0, delta=2.0, varrho_min=1.0)]
SCHEDULES = [(20.0, 1000.0), (3.0, 50.0), (120.0, 5.0)]


def _outcome(fn, *args):
    """The value, or the type and text of what was raised (a schedule
    far outside Theorem 2's conditions overflows in both)."""
    try:
        return fn(*args)
    except (ValueError, OverflowError) as e:
        return type(e), str(e)


def _pair(kw):
    return ref.ProblemConstants(**kw), theory.ProblemConstants(**kw)


def test_constants_and_exports():
    for kw in KS:
        a, b = _pair(kw)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        with pytest.raises(dataclasses.FrozenInstanceError):
            b.mu = 1.0
    for name in ("ProblemConstants", "check_theorem2_conditions",
                 "theorem2_Z", "theorem2_nu", "bound_curve", "lemma1_bound",
                 "dispersion_bound"):
        assert getattr(port_core, name) is getattr(theory, name)


@pytest.mark.parametrize("kw", KS)
@pytest.mark.parametrize("gamma,alpha", SCHEDULES)
def test_calculators_equal(kw, gamma, alpha):
    a, b = _pair(kw)
    assert theory.check_theorem2_conditions(b, gamma, alpha) == \
        ref.check_theorem2_conditions(a, gamma, alpha)
    for tau, t, t_prev, eps0 in [(10, 17, 10, 0.1), (1, 5, 5, 0.0),
                                 (20, 40, 20, 2.5), (4, 3, 0, 1e-3)]:
        assert theory.sigma_t(b, gamma, alpha, tau, t, t_prev) == \
            ref.sigma_t(a, gamma, alpha, tau, t, t_prev)
        assert theory.dispersion_bound(b, gamma, alpha, tau, t, t_prev,
                                       eps0) == \
            ref.dispersion_bound(a, gamma, alpha, tau, t, t_prev, eps0)
    for tau in (1, 2, 10, 20):
        for phi in (0.0, 0.05, 1.0):
            assert _outcome(theory.theorem2_Z, b, gamma, alpha, tau, phi) \
                == _outcome(ref.theorem2_Z, a, gamma, alpha, tau, phi)
            for gap in (0.0, 0.7):
                got = _outcome(theory.theorem2_nu, b, gamma, alpha, tau,
                               phi, gap)
                assert got == _outcome(ref.theorem2_nu, a, gamma, alpha,
                                       tau, phi, gap)
                if gamma <= 1.0 / kw["mu"]:
                    assert got == (ValueError,
                                   "Theorem 2 requires gamma > 1/mu")


def test_curves_and_lemma1_equal():
    rng = np.random.default_rng(0)
    ts = np.sort(rng.integers(0, 1000, 40))
    for nu, alpha in [(1.5, 1000.0), (0.01, 3.0)]:
        got = theory.bound_curve(nu, alpha, ts)
        np.testing.assert_array_equal(got, ref.bound_curve(nu, alpha, ts))
        np.testing.assert_array_equal(theory.bound_curve(nu, alpha, list(ts)),
                                      got)
    for lam, g, s, ups, m in [(0.7, 2, 5, 0.3, 7850), (0.0, 0, 1, 1.0, 1),
                              (0.99, 64, 16, 1e-4, 6_232_810)]:
        assert theory.lemma1_bound(lam, g, s, ups, m) == \
            ref.lemma1_bound(lam, g, s, ups, m)


def test_estimators_equal():
    rng = np.random.default_rng(1)
    for T, N, M in [(3, 5, 7), (1, 25, 100)]:
        grads = rng.standard_normal((T, N, M))
        varrho = rng.random(N)
        varrho /= varrho.sum()
        assert theory.estimate_gradient_diversity(grads, varrho) == \
            ref.estimate_gradient_diversity(grads, varrho)
        full = rng.standard_normal(M)
        draws = full + 0.1 * rng.standard_normal((9, M))
        assert theory.estimate_sgd_noise(draws, full) == \
            ref.estimate_sgd_noise(draws, full)
