"""Netsim (network weather) in the port against ``repro.netsim`` on the
CPU: the copied numpy modules are held exactly (event streams,
snapshots, every host function of ``faults``), the one torch function
(``weighted_global_pytree``) to 1e-6 in f32, and the port's sim trainer
under each scenario of the registry to the reference's trainer: the
loss history to rtol 1e-4 (``tests/test_kernels.py``), ``gamma_used``,
``active_devices`` and the ledger exactly. The port's draws replay the
reference's JAX key schedule, including the seed of each aggregation's
host generator (``repro.rounds.resolver.host_rng``).
"""
import _torch_threads  # noqa: F401  (torch threads per xdist worker)
import dataclasses
import types

import jax
import numpy as np
import pytest
import torch

from _jax_draws import JaxReplayDraws

from repro.configs import TopologyConfig as JTopologyConfig
from repro.configs import TTHFConfig as JTTHFConfig
from repro.core import TTHFTrainer as JTTHFTrainer
from repro.core import make_baseline_config as j_baseline
from repro.core.topology import build_network as j_build_network
from repro.data import fashion_synth, partition_noniid_labels
from repro.models import make_sim_model as j_make_sim_model
from repro.netsim import dynamics as j_dyn
from repro.netsim import events as j_events
from repro.netsim import faults as j_faults
from repro.netsim import scenarios as j_scenarios

from repro_torch.configs import TopologyConfig, TTHFConfig
from repro_torch.configs.base import DynamicsConfig, HierarchyConfig
from repro_torch.core import TTHFTrainer, make_baseline_config
from repro_torch.core.topology import build_network
from repro_torch.launch import train as train_cli
from repro_torch.models import make_sim_model, params_from_jax
from repro_torch.netsim import dynamics, events, faults, scenarios
from repro_torch.rounds import RoundProgram, RoundResolver


# ---------------------------------------------------------------------------
# the numpy modules, exactly
# ---------------------------------------------------------------------------

TOPO = dict(num_devices=20, num_clusters=4, graph="geometric", seed=0)


def _nets():
    return (j_build_network(JTopologyConfig(**TOPO)),
            build_network(TopologyConfig(**TOPO)))


def test_registry_is_the_references():
    assert scenarios.names() == j_scenarios.names()
    for name in scenarios.names():
        assert dataclasses.asdict(scenarios.get(name, seed=3)) == \
            dataclasses.asdict(j_scenarios.get(name, seed=3))
    with pytest.raises(KeyError, match="unknown scenario"):
        scenarios.get("nope")


def _dyn(mod_scen, name):
    # flash_crowd moved into the first 20 iterations, so it leaves and
    # returns inside a short run
    extra = dict(flash_at=6, flash_duration=6) if name == "flash_crowd" \
        else {}
    return mod_scen.get(name, seed=1, **extra)


@pytest.mark.parametrize("name", j_scenarios.names())
def test_event_streams_and_snapshots_equal(name):
    jnet, net = _nets()
    ref = j_dyn.TimeVaryingNetwork(jnet, _dyn(j_scenarios, name))
    got = dynamics.TimeVaryingNetwork(net, _dyn(scenarios, name))
    jst = j_events.EventStream(_dyn(j_scenarios, name), jnet.adj)
    st = events.EventStream(_dyn(scenarios, name), net.adj)
    for t in (1, 2, 3, 7, 12, 13, 25):
        a, b = jst.at(t), st.at(t)
        for f in ("link_up", "device_up", "delay_mult"):
            np.testing.assert_array_equal(getattr(b, f), getattr(a, f))
        assert b.all_up == a.all_up
        a, b = ref.snapshot(t), got.snapshot(t)
        for f in ("V", "adj", "device_up", "lambdas", "delay_mult",
                  "varrho", "active_per_cluster"):
            np.testing.assert_array_equal(getattr(b, f), getattr(a, f), f)
        np.testing.assert_array_equal(b.num_active_edges(),
                                      a.num_active_edges())
        np.testing.assert_array_equal(b.measured_lambdas(),
                                      a.measured_lambdas())


def test_active_subgraph_helpers_equal():
    jnet, net = _nets()
    got = dynamics.TimeVaryingNetwork(
        net, scenarios.get("device_churn", seed=2,
                           p_link_fail=0.3, p_link_recover=0.3))
    for t in (2, 5, 9):
        snap = got.snapshot(t)
        for c in range(net.num_clusters):
            adj, up, V = snap.adj[c], snap.device_up[c], snap.V[c]
            assert [x.tolist() for x in dynamics.connected_components(adj)] \
                == [x.tolist() for x in j_dyn.connected_components(adj)]
            assert dynamics.component_spectral_radius(V, adj) == \
                j_dyn.component_spectral_radius(V, adj)
            assert dynamics.power_iteration_radius(V, adj, seed=c) == \
                j_dyn.power_iteration_radius(V, adj, seed=c)
            for scheme in ("metropolis", "laplacian"):
                np.testing.assert_array_equal(
                    dynamics.masked_cluster_weights(adj, up, scheme),
                    j_dyn.masked_cluster_weights(adj, up, scheme))
            dynamics.check_masked_assumption2(V, adj, up)
            j_dyn.check_masked_assumption2(V, adj, up)
        np.testing.assert_array_equal(
            dynamics.measured_lambdas(snap.V, snap.adj, seed=t),
            j_dyn.measured_lambdas(snap.V, snap.adj, seed=t))


@pytest.mark.parametrize("k", [1, 2, 5])
def test_faults_host_functions_equal(k):
    rng = np.random.default_rng(k)
    varrho = np.full(4, 0.25)
    for trial in range(6):
        up = rng.random((4, 5)) < (0.0 if trial == 0 else 0.6)
        if trial == 1:
            up[:] = True
        delay = 1.0 + rng.lognormal(1.0, 0.5, (4, 5))
        adj = rng.random((4, 5, 5)) < 0.5
        adj = adj | adj.transpose(0, 2, 1)
        np.testing.assert_array_equal(
            faults.renormalized_varrho(up, varrho),
            j_faults.renormalized_varrho(up, varrho))
        pa, ca = j_faults.availability_sample(np.random.default_rng(trial),
                                              up, k=k)
        pb, cb = faults.availability_sample(np.random.default_rng(trial),
                                            up, k=k)
        np.testing.assert_array_equal(pb, pa)
        np.testing.assert_array_equal(cb, ca)
        np.testing.assert_array_equal(
            faults.aggregation_weights(pa, ca, varrho, 5),
            j_faults.aggregation_weights(pa, ca, varrho, 5))
        np.testing.assert_array_equal(
            faults.full_participation_weights(up, varrho),
            j_faults.full_participation_weights(up, varrho))
        np.testing.assert_array_equal(
            faults.consensus_tail_mult(delay, up, adj),
            j_faults.consensus_tail_mult(delay, up, adj))
        np.testing.assert_array_equal(
            faults.uplink_tail_mults(delay, pa, ca),
            j_faults.uplink_tail_mults(delay, pa, ca))


def test_weighted_global_pytree_close():
    rng = np.random.default_rng(0)
    leaves = {"b": rng.standard_normal((20, 10)).astype(np.float32),
              "w": rng.standard_normal((20, 7, 10)).astype(np.float32)}
    up = rng.random((4, 5)) < 0.7
    w = faults.full_participation_weights(up, np.full(4, 0.25))
    ref = j_faults.weighted_global_pytree(
        {k: jax.numpy.asarray(v) for k, v in leaves.items()},
        jax.numpy.asarray(w, jax.numpy.float32), 4)
    got = faults.weighted_global_pytree(
        {k: torch.from_numpy(v) for k, v in leaves.items()},
        torch.as_tensor(w, dtype=torch.float32), 4)
    for k in leaves:
        assert got[k].dtype == torch.float32
        assert tuple(got[k].shape) == leaves[k].shape[1:]
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the sim trainer under each scenario, against the reference's
# ---------------------------------------------------------------------------

ALGOS = {
    "tthf": dict(tau=10, consensus_every=5, gamma_d2d=2, constant_lr=0.002),
    "adaptive": dict(tau=10, consensus_every=5, gamma_d2d=-1, phi=1.0,
                     constant_lr=0.002),
    "fedavg": "fedavg",
}
STEPS = 20
_REF_CACHE = {}


def _algo(cls_cfg, baseline, name):
    spec = ALGOS[name]
    if isinstance(spec, str):
        return dataclasses.replace(baseline(spec, 10), constant_lr=0.002)
    return cls_cfg(**spec)


def _data():
    x, y = fashion_synth(num_points=800, seed=0)
    return partition_noniid_labels(x, y, num_devices=20)


def _reference(name, algo):
    if (name, algo) not in _REF_CACHE:
        tr = JTTHFTrainer(j_make_sim_model("svm", 784, 10), _data(),
                          JTopologyConfig(**TOPO),
                          _algo(JTTHFConfig, j_baseline, algo),
                          batch_size=8, dynamics=_dyn(j_scenarios, name))
        _, hist = tr.run(steps=STEPS, eval_every=5, seed=0)
        w0 = {k: np.asarray(v) for k, v in tr.init(0).global_params.items()}
        _REF_CACHE[name, algo] = (tr, hist, w0)
    return _REF_CACHE[name, algo]


def _port(name, algo, use_kernel, w0, dyn=True):
    tr = TTHFTrainer(make_sim_model("svm", 784, 10), _data(),
                     TopologyConfig(**TOPO),
                     _algo(TTHFConfig, make_baseline_config, algo),
                     batch_size=8, use_kernel=use_kernel,
                     dynamics=_dyn(scenarios, name) if dyn else None,
                     device="cpu")
    draws = JaxReplayDraws(0)
    st = tr.init(0, w0=params_from_jax(w0, "cpu"), draws=draws)
    st, hist = tr.run(steps=STEPS, eval_every=5, state=st)
    return tr, st, hist, draws


def _assert_same_run(tr, h, jtr, jh):
    assert h.ts == jh.ts
    np.testing.assert_allclose(h.global_loss, jh.global_loss, rtol=1e-4)
    np.testing.assert_allclose(h.global_acc, jh.global_acc,
                               atol=1.0 / tr.y.numel() + 1e-7)
    assert [g.tolist() for g in h.gamma_used] == \
        [np.asarray(g).tolist() for g in jh.gamma_used]
    assert h.gamma_saturated == jh.gamma_saturated
    assert h.active_devices == jh.active_devices
    assert h.uplinks == jh.uplinks and h.d2d_msgs == jh.d2d_msgs
    for f in ("uplinks", "broadcasts", "d2d_msgs", "d2d_rounds",
              "local_steps", "uplinks_by_level"):
        assert getattr(tr.ledger, f) == getattr(jtr.ledger, f), f
    assert tr.ledger.delay(0.1) == pytest.approx(jtr.ledger.delay(0.1),
                                                 rel=1e-12)
    assert tr.ledger.energy(0.1) == pytest.approx(jtr.ledger.energy(0.1),
                                               rel=1e-12)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("algo", list(ALGOS))
@pytest.mark.parametrize("name", j_scenarios.names())
def test_trainer_matches_reference_under_scenario(name, algo, use_kernel):
    jtr, jh, w0 = _reference(name, algo)
    tr, st, h, draws = _port(name, algo, use_kernel, w0)
    assert tr.backend == ("pallas" if use_kernel else "masked_loop")
    assert (tr.tvnet is None) == (name == "static")
    _assert_same_run(tr, h, jtr, jh)
    # a host seed per sampled aggregation under dynamics, none otherwise
    sampled = name != "static" and algo != "fedavg"
    assert draws.host_seeds == (STEPS // 10 if sampled else 0)
    if name == "flash_crowd":
        assert min(h.active_devices) < 20 and h.active_devices[-1] == 20
    assert st.t == STEPS


def test_static_scenario_equals_no_scenario_bit_for_bit():
    _, _, w0 = _reference("static", "tthf")
    tr0, st0, h0, _ = _port("static", "tthf", True, w0, dyn=False)
    tr1, st1, h1, _ = _port("static", "tthf", True, w0)
    assert tr0.program.dynamics is None and tr1.tvnet is None
    assert h0.global_loss == h1.global_loss
    assert h0.global_acc == h1.global_acc
    assert h0.dispersion == h1.dispersion
    for k in st0.params:
        assert torch.equal(st0.params[k], st1.params[k])
    assert tr0.ledger.uplinks == tr1.ledger.uplinks
    assert tr0.ledger.d2d_msgs == tr1.ledger.d2d_msgs


def test_total_blackout_freezes_everything():
    """p_drop=1, p_return=0: from t=1 every device is offline. No SGD,
    no consensus traffic, no uplinks; parameters hold exactly."""
    dyn = DynamicsConfig(name="blackout", p_device_drop=1.0,
                         p_device_return=0.0, seed=0)
    tr = TTHFTrainer(make_sim_model("svm", 784, 10), _data(),
                     TopologyConfig(**TOPO), TTHFConfig(**ALGOS["tthf"]),
                     batch_size=8, use_kernel=True, dynamics=dyn,
                     device="cpu")
    st0 = tr.init(seed=0)
    init = {k: v.clone() for k, v in st0.params.items()}
    st, h = tr.run(steps=12, seed=0, state=st0)
    for k in init:
        assert torch.equal(st.params[k], init[k])
    assert tr.ledger.uplinks == 0 and tr.ledger.d2d_msgs == 0
    assert tr.ledger.local_steps == 0
    assert h.active_devices[-1] == 0


def test_dark_device_holds_through_a_non_finite_gradient():
    """A dark device's rows of the update are filled with zeros, not
    multiplied by a mask: a NaN gradient there leaves it as it was."""
    tr = TTHFTrainer(make_sim_model("svm", 784, 10), _data(),
                     TopologyConfig(**TOPO), TTHFConfig(**ALGOS["tthf"]),
                     batch_size=8, device="cpu")
    st = tr.init(seed=0)
    before = {k: v.clone() for k, v in st.params.items()}
    real = tr.model.grads

    def nan_on_device_3(params, x, y):
        g = real(params, x, y)
        for v in g.values():
            v[3] = float("nan")
        return g

    tr.model = types.SimpleNamespace(grads=nan_on_device_3)
    dark = torch.zeros(20, dtype=torch.bool)
    dark[3] = True
    idx = st.draws.minibatch(20, 8, tr.y.shape[1])
    tr._local_step(st.params, idx, 0.01, dark)
    for k, v in st.params.items():
        assert torch.equal(v[3], before[k][3])
        assert torch.isfinite(v).all()
        assert not torch.equal(v[4], before[k][4])


def test_resolver_takes_a_host_seed_only_where_it_samples():
    net = build_network(TopologyConfig(**TOPO))
    algo = TTHFConfig(**ALGOS["tthf"])
    res = RoundResolver.for_sim(
        net, algo, RoundProgram(dynamics=scenarios.get("device_churn",
                                                       seed=1)))

    class Seeds:
        calls = 0

        def host_seed(self):
            Seeds.calls += 1
            return 7

    for t in range(1, 11):
        ev = res.resolve(t, Seeds())
    assert Seeds.calls == 1 and ev.aggregation.kind == "weights"
    assert ev.aggregation.weights.sum() == pytest.approx(1.0)


def test_still_unported_forms_refuse():
    # the fog hierarchy in sim mode and netsim in scale mode resolve now;
    # they refuse only the calendars the reference asserts against
    net = build_network(TopologyConfig(**TOPO))
    args = (make_sim_model("svm", 784, 10), _data(), TopologyConfig(**TOPO))
    hier = HierarchyConfig(levels=3, taus=(10, 20), sample=(1, 1))
    tr = TTHFTrainer(*args, TTHFConfig(**ALGOS["tthf"]), hierarchy=hier,
                     device="cpu")
    assert tr.tree is not None and tr.tree.node_counts == (4, 2, 1)
    with pytest.raises(ValueError, match="tier-1 period"):
        TTHFTrainer(*args, TTHFConfig(**dict(ALGOS["tthf"], tau=20)),
                    hierarchy=hier, device="cpu")
    from repro_torch.core.distributed import TTHFScaleConfig
    res = RoundResolver.for_scale(
        net, TTHFScaleConfig(replicas=20, cluster_size=5),
        RoundProgram(dynamics=scenarios.get("markov_links")))
    assert res.tvnet is not None


def test_train_cli_scenario_in_sim_mode(capsys):
    argv = ["--mode", "sim", "--model", "svm", "--devices", "20",
            "--clusters", "4", "--points", "800", "--steps", "20",
            "--tau", "10", "--eval-every", "5", "--device", "cpu"]
    assert train_cli.main(argv + ["--scenario", "static"]) == 0
    static = capsys.readouterr().out.strip().splitlines()[-1]
    assert train_cli.main(argv) == 0
    bare = capsys.readouterr().out.strip().splitlines()[-1]
    # the same final_loss as omitting the flag (wall time aside)
    assert static.split()[2:] == bare.split()[2:]
    assert train_cli.main(argv + ["--scenario", "stragglers"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert "final_loss=" in line and "uplinks=8 L1=8" in line
    # the fog hierarchy and the control plane run beside the scenario
    # (the scale CLI's forms: tests/test_torch_scale_forms.py)
    for more in (["--hierarchy", "fog3"], ["--control", "remark1"]):
        assert train_cli.main(argv + ["--scenario", "stragglers"]
                              + more) == 0
        line = capsys.readouterr().out.strip().splitlines()[-1]
        assert "final_loss=" in line and "uplinks=" in line
    with pytest.raises(ValueError, match="not composed yet"):
        train_cli.main(argv + ["--hierarchy", "fog3", "--control",
                               "remark1"])
