"""The control plane in the port against ``repro.control`` on the CPU.

- The numpy copies (laws, estimator, power iteration, ``Controller``,
  the policy registry) are exactly equal on the same inputs, the refusals
  of the safety envelope included.
- The port's sim trainer under ``remark1`` and ``connectivity``, each on
  the static topology and under ``device_churn``, against the reference's
  trainer (its own setup, ``tests/test_control.py``: 20 devices in 4
  clusters, svm, τ 10, consensus every 5, Γ 2, lr 0.002): the loss
  history to rtol 1e-4 (``tests/test_kernels.py``); every decision's Γ,
  τ, ``safe``, ``fallback``, measured λ and sampling flag, the
  aggregation calendar and the ledger exactly. δ̂ and σ̂ come from
  gradients the two packages compute in float32 in other orders: rtol
  1e-4. The port's draws replay the reference's key schedule, the
  controller's probe stream included.
- ``static`` is bitwise the run without a policy; control with a fog
  hierarchy, and control of a star baseline, raise as in the reference.
"""
import _torch_threads  # noqa: F401  (torch threads per xdist worker)
import dataclasses

import numpy as np
import pytest
import torch

from _jax_draws import JaxReplayDraws

from repro.configs import ControlConfig as JControlConfig
from repro.configs import TopologyConfig as JTopologyConfig
from repro.configs import TTHFConfig as JTTHFConfig
from repro.control import Controller as JController
from repro.control import OnlineGradStats as JOnlineGradStats
from repro.control import get_policy as j_get_policy
from repro.control import laws as j_laws
from repro.control import policies as j_policies
from repro.control.estimator import (
    static_measured_lambdas as j_static_measured_lambdas)
from repro.core import TTHFTrainer as JTTHFTrainer
from repro.core.theory import ProblemConstants as JProblemConstants
from repro.core.topology import build_network as j_build_network
from repro.data import fashion_synth, partition_noniid_labels
from repro.hierarchy import presets as j_presets
from repro.models import make_sim_model as j_make_sim_model
from repro.netsim import dynamics as j_dyn
from repro.netsim import scenarios as j_scenarios
from repro.rounds import RoundProgram as JRoundProgram

from repro_torch.configs import TopologyConfig, TTHFConfig
from repro_torch.configs.base import ControlConfig
from repro_torch.control import (
    Controller, OnlineGradStats, get_policy, laws, policies)
from repro_torch.control.estimator import static_measured_lambdas
from repro_torch.core import TTHFTrainer, make_baseline_config
from repro_torch.core.theory import ProblemConstants
from repro_torch.core.topology import build_network
from repro_torch.hierarchy import presets
from repro_torch.models import make_sim_model, params_from_jax
from repro_torch.netsim import dynamics, scenarios
from repro_torch.rounds import RoundProgram, RoundResolver

TOPO = dict(num_devices=20, num_clusters=4, graph="geometric", seed=0)
ALGO = dict(tau=10, consensus_every=5, gamma_d2d=2, constant_lr=0.002)
STEPS = 30


# ---------------------------------------------------------------------------
# the numpy copies, exactly
# ---------------------------------------------------------------------------

def test_registry_equals_the_references():
    assert policies.POLICIES == j_policies.POLICIES
    for name in policies.POLICIES:
        assert dataclasses.asdict(get_policy(name, gamma_max=9)) == \
            dataclasses.asdict(j_get_policy(name, gamma_max=9))
    with pytest.raises(KeyError, match="unknown control policy"):
        get_policy("nope")


def test_gamma_laws_equal_the_references():
    rng = np.random.default_rng(0)
    for _ in range(20):
        n = 8
        ups = 10.0 ** rng.uniform(-8, 1, n)
        lam = rng.uniform(0.0, 1.0, n)
        lam[0] = 0.0
        sizes = rng.integers(1, 7, n)
        eta = 10.0 ** rng.uniform(-4, -1)
        for mr in (1, 64):
            for got, want in (
                    (laws.remark1_gamma(eta, 0.5, ups, lam, sizes, 100, mr),
                     j_laws.remark1_gamma(eta, 0.5, ups, lam, sizes, 100,
                                          mr)),
                    (laws.equal_contraction_gamma(lam, lam[::-1], 3, mr),
                     j_laws.equal_contraction_gamma(lam, lam[::-1], 3, mr))):
                for a, b in zip(got, want):
                    np.testing.assert_array_equal(a, b)
                    assert a.dtype == b.dtype


def test_tau_sampling_and_envelope_laws_equal_the_references():
    def eta(t):
        return 0.01 / (1 + 0.01 * t)
    for sigma, delta, w in ((0.1, 0.1, 2.0), (5.0, 3.0, 0.5),
                            (50.0, 1.0, 10.0)):
        k = ProblemConstants(mu=1.0, beta=1.0, sigma=sigma, delta=delta,
                             varrho_min=0.25)
        jk = JProblemConstants(mu=1.0, beta=1.0, sigma=sigma, delta=delta,
                               varrho_min=0.25)
        for t in (10, 40):
            assert laws.sigma_span(1.0, eta, t, 7) == \
                j_laws.sigma_span(1.0, eta, t, 7)
            assert laws.dispersion_gap(k, eta, t, 7, 0.1) == \
                j_laws.dispersion_gap(jk, eta, t, 7, 0.1)
            assert laws.tau_law(k, eta, t, tau_min=5, tau_max=80, quantum=5,
                                energy_weight=w) == \
                j_laws.tau_law(jk, eta, t, tau_min=5, tau_max=80, quantum=5,
                               energy_weight=w)
        for args in ((1.0, 1.0, 0.0), (10.0, 5.0, 0.0), (0, 0, 0.5),
                     (0, 0, 2.0)):
            assert laws.safety_envelope(k, *args) == \
                j_laws.safety_envelope(jk, *args)
    rng = np.random.default_rng(1)
    for i in range(5):
        up = rng.random((6, 5)) < 0.7
        up[0] = False
        delay = np.exp(rng.normal(0, 1, (6, 5)))
        p = laws.sampling_law(up, delay)
        np.testing.assert_array_equal(p, j_laws.sampling_law(up, delay))
        for k in (1, 2, 5):
            got = laws.sample_with_probs(np.random.default_rng(i), p, k)
            want = j_laws.sample_with_probs(np.random.default_rng(i), p, k)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)


def test_estimators_equal_the_references():
    rng = np.random.default_rng(2)
    got, want = OnlineGradStats(window=3), JOnlineGradStats(window=3)
    assert got.delta_hat is None and got.sigma_hat is None
    base = ProblemConstants(mu=2.0, beta=3.0, sigma=1.0, delta=1.0,
                            varrho_min=0.1)
    jbase = JProblemConstants(**dataclasses.asdict(base))
    for r in range(5):
        # the window is weighed with the latest varrho (changed at r = 3)
        varrho = np.full(4, 0.25) if r < 3 else np.array([.1, .2, .3, .4])
        cg = rng.normal(size=(4, 33)).astype(np.float32)
        G = rng.normal(size=(6, 33)).astype(np.float32)
        Gmb = rng.normal(size=(6, 4, 33)).astype(np.float32)
        for st in (got, want):
            st.observe_clusters(cg, varrho)
            st.observe_fleet_noise(Gmb, G)
        assert got.delta_hat == want.delta_hat
        assert got.delta_hat == want.delta_hat    # the kept value
        assert got.sigma_hat == want.sigma_hat
        assert dataclasses.asdict(got.constants(base)) == \
            dataclasses.asdict(want.constants(jbase))
    assert got.rounds_observed == want.rounds_observed == 5


def _nets():
    return (build_network(TopologyConfig(**TOPO)),
            j_build_network(JTopologyConfig(**TOPO)))


def test_power_iteration_equals_the_reference():
    net, jnet = _nets()
    for iters, seed in ((40, 0), (300, 7)):
        np.testing.assert_array_equal(
            static_measured_lambdas(net, iters=iters, seed=seed),
            j_static_measured_lambdas(jnet, iters=iters, seed=seed))


def _decision_fields(dec):
    return (dec.t, dec.policy, dec.safe, dec.fallback,
            None if dec.gammas is None else np.asarray(dec.gammas).tolist(),
            dec.gamma_saturated, dec.tau_next, dec.sampling,
            np.asarray(dec.lambdas_measured).tolist(),
            np.asarray(dec.lambdas_assumed).tolist(),
            dec.delta_hat, dec.sigma_hat)


@pytest.mark.parametrize("policy,algo_kw", [
    ("remark1", ALGO), ("connectivity", ALGO),
    ("connectivity", dict(ALGO, gamma_d2d=-1)),
    # the default decaying schedule fails Theorem 2: every decision refused
    ("remark1", dict(tau=10, consensus_every=5, gamma_d2d=2)),
])
def test_controller_decisions_equal_the_references(policy, algo_kw):
    net, jnet = _nets()
    # tau_max 30: the τ law scores each candidate τ with O(τ²) calls of
    # the learning-rate schedule, a JAX dispatch each on the reference
    ctl = Controller.for_sim(get_policy(policy, tau_max=30), net,
                             TTHFConfig(**algo_kw))
    jctl = JController.for_sim(j_get_policy(policy, tau_max=30), jnet,
                               JTTHFConfig(**algo_kw))
    assert ctl.envelope == jctl.envelope
    assert (ctl.adapts_tau, ctl.adapts_sampling, ctl.wants_grad_stats) == \
        (jctl.adapts_tau, jctl.adapts_sampling, jctl.wants_grad_stats)
    for c in (ctl, jctl):
        c.bind(model_dim=7850)
    tv = dynamics.TimeVaryingNetwork(net, scenarios.get("device_churn",
                                                        seed=1))
    jtv = j_dyn.TimeVaryingNetwork(jnet, j_scenarios.get("device_churn",
                                                         seed=1))
    rng = np.random.default_rng(3)
    for t in (5, 10, 15, 20, 25):
        ups = 10.0 ** rng.uniform(-6, 0, net.num_clusters)
        for snap, jsnap in ((None, None), (tv.snapshot(t), jtv.snapshot(t))):
            dec, jdec = ctl.consensus_decision(t, snap), \
                jctl.consensus_decision(t, jsnap)
            sizes = 5 if snap is None else snap.active_per_cluster
            np.testing.assert_array_equal(
                ctl.gamma_for(dec, 0.002, ups, sizes),
                jctl.gamma_for(jdec, 0.002, ups, sizes))
            assert ctl.tau_decision(t, dec) == jctl.tau_decision(t, jdec)
            p, jp = ctl.sampling_probs(dec, snap), \
                jctl.sampling_probs(jdec, jsnap)
            assert (p is None) == (jp is None)
            if p is not None:
                np.testing.assert_array_equal(p, jp)
            assert _decision_fields(dec) == _decision_fields(jdec)
            assert dec.round_fields().keys() == jdec.round_fields().keys()
    assert ctl.counters() == jctl.counters()


def test_scale_controller_equals_the_reference():
    from repro.core.distributed import TTHFScaleConfig as JScale
    from repro_torch.core.distributed import TTHFScaleConfig
    kw = dict(replicas=8, cluster_size=2, tau=2, consensus_every=2,
              gamma_d2d=2, lr=0.05)
    scale, jscale = TTHFScaleConfig(**kw), JScale(**kw)
    for policy in ("remark1", "connectivity"):
        ctl = Controller.for_scale(get_policy(policy), scale.network(),
                                   scale)
        jctl = JController.for_scale(j_get_policy(policy),
                                     jscale.network(), jscale)
        assert not ctl.adapts_tau and not ctl.wants_grad_stats
        for t in (1, 2, 3):
            dec, jdec = ctl.consensus_decision(t, None), \
                jctl.consensus_decision(t, None)
            np.testing.assert_array_equal(ctl.scale_gammas(dec),
                                          jctl.scale_gammas(jdec))
            assert _decision_fields(dec) == _decision_fields(jdec)


# ---------------------------------------------------------------------------
# the sim trainer against the reference's
# ---------------------------------------------------------------------------

_DATA = {}
_REF = {}


def _data():
    if not _DATA:
        x, y = fashion_synth(num_points=800, seed=0)
        _DATA["d"] = partition_noniid_labels(x, y, num_devices=20)
    return _DATA["d"]


def _recorded(tr):
    """Record every decision the controller opens and the iterations
    that aggregate (one list each, on either package's trainer)."""
    res, decs, aggs = tr._resolver, [], []
    ctl = res.controller
    if ctl is not None:
        opened = ctl.consensus_decision

        def consensus_decision(*args):
            decs.append(opened(*args))
            return decs[-1]
        ctl.consensus_decision = consensus_decision
    resolve = res.resolve

    def record(t, *args):
        ev = resolve(t, *args)
        if ev.aggregation is not None:
            aggs.append(t)
        return ev
    res.resolve = record
    return decs, aggs


def _reference(policy, scenario):
    key = (policy, scenario)
    if key not in _REF:
        dyn = j_scenarios.get(scenario, seed=1) if scenario else None
        ctl = j_get_policy(policy) if policy else None
        tr = JTTHFTrainer(j_make_sim_model("svm", 784, 10), _data(),
                          JTopologyConfig(**TOPO), JTTHFConfig(**ALGO),
                          batch_size=8, program=JRoundProgram(
                              dynamics=dyn, control=ctl))
        decs, aggs = _recorded(tr)
        _, hist = tr.run(steps=STEPS, eval_every=5, seed=0)
        w0 = {k: np.asarray(v) for k, v in tr.init(0).global_params.items()}
        _REF[key] = (tr, hist, w0, decs, aggs)
    return _REF[key]


def _port(policy, scenario, w0, control=None):
    dyn = scenarios.get(scenario, seed=1) if scenario else None
    if control is None and policy:
        control = get_policy(policy)
    tr = TTHFTrainer(make_sim_model("svm", 784, 10), _data(),
                     TopologyConfig(**TOPO), TTHFConfig(**ALGO),
                     batch_size=8, use_kernel=True, device="cpu",
                     program=RoundProgram(dynamics=dyn, control=control))
    decs, aggs = _recorded(tr)
    draws = JaxReplayDraws(0)
    st = tr.init(0, w0=params_from_jax(w0, "cpu"), draws=draws)
    st, hist = tr.run(steps=STEPS, eval_every=5, state=st)
    return tr, st, hist, draws, decs, aggs


def _assert_same_decisions(decs, jdecs):
    assert len(decs) == len(jdecs) > 0
    for d, j in zip(decs, jdecs):
        got, want = _decision_fields(d), _decision_fields(j)
        assert got[:10] == want[:10], (got, want)
        for a, b in zip(got[10:], want[10:]):
            assert (a is None) == (b is None)
            if a is not None:
                assert a == pytest.approx(b, rel=1e-4)


@pytest.mark.parametrize("scenario", [None, "device_churn"])
@pytest.mark.parametrize("policy", ["remark1", "connectivity"])
def test_sim_trainer_matches_reference_under_policy(policy, scenario):
    jtr, jh, w0, jdecs, jaggs = _reference(policy, scenario)
    tr, st, h, draws, decs, aggs = _port(policy, scenario, w0)
    assert h.ts == jh.ts
    np.testing.assert_allclose(h.global_loss, jh.global_loss, rtol=1e-4)
    assert [g.tolist() for g in h.gamma_used] == \
        [np.asarray(g).tolist() for g in jh.gamma_used]
    assert h.gamma_saturated == jh.gamma_saturated
    assert h.active_devices == jh.active_devices
    for f in ("uplinks", "broadcasts", "d2d_msgs", "d2d_rounds",
              "local_steps", "uplinks_by_level"):
        assert getattr(tr.ledger, f) == getattr(jtr.ledger, f), f
    assert tr.ledger.delay(0.1) == pytest.approx(jtr.ledger.delay(0.1),
                                                 rel=1e-12)
    _assert_same_decisions(decs, jdecs)
    assert aggs == jaggs
    ctl = tr._resolver.controller
    assert ctl.counters() == jtr._resolver.controller.counters()
    assert draws.probes == (len(aggs) if policy == "connectivity" else 0)
    if policy == "connectivity":
        # the τ law moves the calendar off the static τ = 10, and the
        # port's spans stop where the controller's calendar says
        taus = [d.tau_next for d in decs if d.tau_next is not None]
        assert taus and any(t != ALGO["tau"] for t in taus), taus
        assert aggs[0] == ALGO["tau"]
        assert aggs != list(range(ALGO["tau"], STEPS + 1, ALGO["tau"]))
        assert ctl.stats.rounds_observed == len(aggs)


@pytest.mark.parametrize("scenario", [None, "device_churn"])
def test_static_policy_is_bitwise_the_run_without_one(scenario):
    _, _, w0, _, _ = _reference("remark1", None)
    tr0, st0, h0, d0, _, _ = _port(None, scenario, w0)
    tr1, st1, h1, d1, _, _ = _port(None, scenario, w0,
                                   control=ControlConfig())
    assert tr1._resolver.controller is None
    assert h0.global_loss == h1.global_loss
    assert h0.global_acc == h1.global_acc
    for k in st0.params:
        assert torch.equal(st0.params[k], st1.params[k])
    assert tr0.ledger == tr1.ledger
    assert d0.probes == d1.probes == 0


def test_control_refusals_equal_the_references():
    net, jnet = _nets()
    both = RoundProgram(control=get_policy("remark1"),
                        hierarchy=presets.get("fog3", tau=10))
    with pytest.raises(ValueError, match="not composed yet"):
        RoundResolver.for_sim(net, TTHFConfig(**ALGO), both)
    with pytest.raises(AssertionError, match="not composed yet"):
        from repro.rounds import RoundResolver as JRoundResolver
        JRoundResolver.for_sim(jnet, JTTHFConfig(**ALGO), JRoundProgram(
            control=j_get_policy("remark1"),
            hierarchy=j_presets.get("fog3", tau=10)))
    star = dataclasses.replace(make_baseline_config("fedavg", 10),
                               constant_lr=0.002)
    with pytest.raises(ValueError, match="star baselines"):
        RoundResolver.for_sim(net, star, RoundProgram(
            control=get_policy("connectivity")))
    from repro_torch.core.distributed import TTHFScaleConfig
    scale = TTHFScaleConfig(replicas=8, cluster_size=2, tau=2,
                            consensus_every=2)
    with pytest.raises(ValueError, match="not composed yet"):
        RoundResolver.for_scale(scale.network(), scale, RoundProgram(
            control=get_policy("connectivity"),
            hierarchy=presets.get("fog3", tau=2)))
    with pytest.raises(ValueError, match="MixingPlan"):
        RoundResolver.for_scale(scale.network(), scale, RoundProgram(
            control=get_policy("connectivity")))
    assert JControlConfig().is_static and ControlConfig().is_static
