"""The fog hierarchy in the port against ``repro.hierarchy`` on the CPU.

- The numpy copies (tree, presets) and every host event builder of
  ``aggregate.py`` are exactly equal, from the same generator.
- The two torch appliers are within 1e-6 of the reference's einsums in
  float32.
- The port's sim trainer under ``flat``, ``fog3``, ``fog4`` and
  ``fog3_sampled``, each on the static topology and under
  ``device_churn``, against the reference's trainer (the reference's own
  setup, ``tests/test_hierarchy.py``: 24 devices in 8 clusters, svm, τ 5,
  consensus every 5, Γ 2): the loss history to rtol 1e-4
  (``tests/test_kernels.py``), ``gamma_used``, ``active_devices``,
  ``uplinks_by_level`` and the ledger exactly. The port's draws replay
  the reference's key schedule, the host generators' seeds included.
- ``flat`` is bitwise the run without a hierarchy; an all-dark event is
  the identity.
"""
import _torch_threads  # noqa: F401  (torch threads per xdist worker)
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _jax_draws import JaxReplayDraws

from repro.configs import HierarchyConfig as JHierarchyConfig
from repro.configs import TopologyConfig as JTopologyConfig
from repro.configs import TTHFConfig as JTTHFConfig
from repro.core import TTHFTrainer as JTTHFTrainer
from repro.data import fashion_synth, partition_noniid_labels
from repro.hierarchy import aggregate as j_agg
from repro.hierarchy import build_tree as j_build_tree
from repro.hierarchy import presets as j_presets
from repro.models import make_sim_model as j_make_sim_model
from repro.netsim import scenarios as j_scenarios

from repro_torch.configs import TopologyConfig, TTHFConfig
from repro_torch.configs.base import DynamicsConfig, HierarchyConfig
from repro_torch.core import TTHFTrainer
from repro_torch.hierarchy import aggregate, build_tree, presets
from repro_torch.models import make_sim_model, params_from_jax
from repro_torch.netsim import scenarios

TOPO = dict(num_devices=24, num_clusters=8, graph="geometric", seed=0)
ALGO = dict(tau=5, consensus_every=5, gamma_d2d=2, constant_lr=0.002)
STEPS = 20
PRESETS = ("flat", "fog3", "fog4", "fog3_sampled")
SCENARIOS = (None, "device_churn")


# ---------------------------------------------------------------------------
# the numpy copies, exactly
# ---------------------------------------------------------------------------

def test_presets_equal_the_references():
    assert presets.names() == j_presets.names()
    for name in presets.names():
        for tau in (5, 20):
            assert dataclasses.asdict(presets.get(name, tau=tau)) == \
                dataclasses.asdict(j_presets.get(name, tau=tau))
    assert presets.get("fog3", tau=5, sample=(1, 3)).sample == (1, 3)
    with pytest.raises(KeyError, match="unknown hierarchy preset"):
        presets.get("nope")


@pytest.mark.parametrize("name", ["fog3", "fog4", "fog3_sampled"])
@pytest.mark.parametrize("N,s", [(8, 3), (4, 5), (25, 5), (12, 2)])
def test_trees_equal_the_references(name, N, s):
    got = build_tree(presets.get(name, tau=5), N, s)
    want = j_build_tree(j_presets.get(name, tau=5), N, s)
    assert (got.levels, got.branching, got.node_counts) == \
        (want.levels, want.branching, want.node_counts)
    for a, b in zip(got.parent, want.parent):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got.mass, want.mass):
        np.testing.assert_array_equal(a, b)
    for level in range(got.levels):
        np.testing.assert_array_equal(got.device_ancestors(level),
                                      want.device_ancestors(level))
        if level:
            for node in range(got.node_counts[level]):
                np.testing.assert_array_equal(got.children(level, node),
                                              want.children(level, node))


def test_tree_refusals_equal_the_references():
    cfg = dict(levels=4, taus=(5, 10, 20), sample=(1, 0, 0))
    for build, H in ((build_tree, HierarchyConfig),
                     (j_build_tree, JHierarchyConfig)):
        with pytest.raises(ValueError, match="divisor"):
            build(H(**cfg), num_clusters=5, cluster_size=2)
        with pytest.raises(ValueError, match="does not divide"):
            build(H(**cfg, branching=(3, 2)), num_clusters=8,
                  cluster_size=2)


def _up_masks(N, s, seed):
    rng = np.random.default_rng(seed)
    masks = [np.ones((N, s), bool), rng.random((N, s)) < 0.6,
             np.zeros((N, s), bool)]
    half = np.ones((N, s), bool)
    half[: N // 2] = False                 # half the clusters dark
    return masks + [half]


@pytest.mark.parametrize("name", ["fog3", "fog4", "fog3_sampled"])
@pytest.mark.parametrize("receive_offline", [False, True])
def test_event_builders_equal_the_references(name, receive_offline):
    N, s = 8, 3
    cfg, jcfg = presets.get(name, tau=5), j_presets.get(name, tau=5)
    tree, jtree = build_tree(cfg, N, s), j_build_tree(jcfg, N, s)
    for t in range(0, 45, 5):
        assert aggregate.interval_depth(t, cfg.taus) == \
            j_agg.interval_depth(t, jcfg.taus)
    for i, up in enumerate(_up_masks(N, s, seed=7)):
        for t in (5, 10, 20, 40):
            got = aggregate.build_event(np.random.default_rng(i), tree, cfg,
                                        t, up, receive_offline)
            want = j_agg.build_event(np.random.default_rng(i), jtree, jcfg,
                                     t, up, receive_offline)
            assert (got.t, got.depth) == (want.t, want.depth)
            assert got.uplinks_by_level == want.uplinks_by_level
            assert got.total_uplinks == want.total_uplinks
            for f in ("picks", "counts", "device_matrix"):
                np.testing.assert_array_equal(getattr(got, f),
                                              getattr(want, f))
            assert got.device_matrix.dtype == np.float32
            assert len(got.level_weights) == len(want.level_weights)
            for a, b in zip(got.level_weights, want.level_weights):
                np.testing.assert_array_equal(a, b)
            assert (got.global_weights is None) == \
                (want.global_weights is None)
            if got.global_weights is not None:
                np.testing.assert_array_equal(got.global_weights,
                                              want.global_weights)
    assert aggregate.build_event(np.random.default_rng(0), tree, cfg, 3,
                                 np.ones((N, s), bool)) is None


def test_level_helpers_equal_the_references():
    N, s = 8, 3
    cfg = presets.get("fog4", tau=5)
    tree = build_tree(cfg, N, s)
    jtree = j_build_tree(j_presets.get("fog4", tau=5), N, s)
    from repro_torch.netsim.faults import availability_sample
    for i, up in enumerate(_up_masks(N, s, seed=3)):
        picks, counts = availability_sample(np.random.default_rng(i), up, 2)
        np.testing.assert_array_equal(aggregate.rep_matrix(picks, counts, s),
                                      j_agg.rep_matrix(picks, counts, s))
        live = aggregate.live_levels(tree, up)
        for a, b in zip(live, j_agg.live_levels(jtree, up)):
            np.testing.assert_array_equal(a, b)
        for level in (1, 2, 3):
            for k in (0, 1, 2):
                got = aggregate.sample_children(
                    np.random.default_rng(i), live[level - 1],
                    tree.parent[level - 1], tree.node_counts[level], k)
                want = j_agg.sample_children(
                    np.random.default_rng(i), live[level - 1],
                    jtree.parent[level - 1], jtree.node_counts[level], k)
                assert [c.tolist() for c in got] == \
                    [c.tolist() for c in want]
                np.testing.assert_array_equal(
                    aggregate.child_matrix(tree, level, got),
                    j_agg.child_matrix(jtree, level, want))


# ---------------------------------------------------------------------------
# the torch appliers
# ---------------------------------------------------------------------------

def test_appliers_match_the_reference():
    rng = np.random.default_rng(5)
    I = 24
    tree = {"b": rng.normal(size=(I, 10)).astype(np.float32),
            "w": rng.normal(size=(I, 78, 10)).astype(np.float32)}
    ev = j_agg.build_event(np.random.default_rng(1),
                           j_build_tree(j_presets.get("fog3", tau=5), 8, 3),
                           j_presets.get("fog3", tau=5), 10,
                           rng.random((8, 3)) < 0.7)
    M, gw = ev.device_matrix, ev.global_weights
    ttree = params_from_jax(tree, "cpu")
    jtree = {k: jnp.asarray(v) for k, v in tree.items()}
    got = aggregate.apply_device_matrix_pytree(ttree, torch.from_numpy(M))
    want = j_agg.apply_device_matrix_pytree(jtree, jnp.asarray(M))
    got_g = aggregate.global_from_weights(ttree, torch.from_numpy(gw))
    want_g = j_agg.global_from_weights(jtree, jnp.asarray(gw))
    for k in tree:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-6)
        np.testing.assert_allclose(got_g[k].numpy(), np.asarray(want_g[k]),
                                   atol=1e-6)
        assert got[k].shape == ttree[k].shape
        assert got_g[k].shape == ttree[k].shape[1:]
        # a new tree: the inputs are untouched
        np.testing.assert_array_equal(ttree[k].numpy(), tree[k])


def test_the_device_matrix_spreads_a_nan_on_both_sides():
    """Hold-rows are e_i, so a NaN anywhere in a leaf reaches every row
    (0 · NaN): the port's matmul and the reference's einsum alike."""
    I = 6
    M = np.eye(I, dtype=np.float32)
    M[:3, :3] = 1.0 / 3
    leaf = np.ones((I, 4), np.float32)
    leaf[5, 2] = np.nan
    got = aggregate.apply_device_matrix_pytree(
        {"w": torch.from_numpy(leaf)}, torch.from_numpy(M))["w"].numpy()
    want = np.asarray(j_agg.apply_device_matrix_pytree(
        {"w": jnp.asarray(leaf)}, jnp.asarray(M))["w"])
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[:, 2]).all() and not np.isnan(got[:, 0]).any()


# ---------------------------------------------------------------------------
# the sim trainer against the reference's
# ---------------------------------------------------------------------------

_DATA = {}
_REF = {}


def _data():
    if not _DATA:
        x, y = fashion_synth(num_points=800, seed=0)
        _DATA["d"] = partition_noniid_labels(x, y, num_devices=24)
    return _DATA["d"]


def _dyn(mod, scenario):
    return mod.get(scenario, seed=1) if scenario else None


def _reference(name, scenario):
    if (name, scenario) not in _REF:
        tr = JTTHFTrainer(j_make_sim_model("svm", 784, 10), _data(),
                          JTopologyConfig(**TOPO), JTTHFConfig(**ALGO),
                          batch_size=8, dynamics=_dyn(j_scenarios, scenario),
                          hierarchy=j_presets.get(name, tau=5))
        _, hist = tr.run(steps=STEPS, eval_every=5, seed=0)
        w0 = {k: np.asarray(v) for k, v in tr.init(0).global_params.items()}
        _REF[name, scenario] = (tr, hist, w0)
    return _REF[name, scenario]


def _port(name, scenario, w0, hierarchy=True, dynamics=None):
    tr = TTHFTrainer(make_sim_model("svm", 784, 10), _data(),
                     TopologyConfig(**TOPO), TTHFConfig(**ALGO), batch_size=8,
                     use_kernel=True,
                     dynamics=dynamics or _dyn(scenarios, scenario),
                     hierarchy=presets.get(name, tau=5) if hierarchy
                     else None, device="cpu")
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
    assert h.active_devices == jh.active_devices
    assert h.uplinks == jh.uplinks and h.d2d_msgs == jh.d2d_msgs
    for f in ("uplinks", "broadcasts", "d2d_msgs", "d2d_rounds",
              "local_steps", "uplinks_by_level"):
        assert getattr(tr.ledger, f) == getattr(jtr.ledger, f), f
    assert tr.ledger.delay(0.1) == pytest.approx(jtr.ledger.delay(0.1),
                                                 rel=1e-12)
    assert tr.ledger.energy(0.1) == pytest.approx(jtr.ledger.energy(0.1),
                                                  rel=1e-12)


@pytest.mark.parametrize("scenario", SCENARIOS)
@pytest.mark.parametrize("name", PRESETS)
def test_sim_trainer_matches_reference_under_preset(name, scenario):
    jtr, jh, w0 = _reference(name, scenario)
    tr, st, h, draws = _port(name, scenario, w0)
    assert (tr.tree is None) == (name == "flat")
    _assert_same_run(tr, h, jtr, jh)
    # one host seed per aggregation (every τ): down the tree, or among
    # the available devices under churn; flat's static picks take none
    aggs = STEPS // ALGO["tau"]
    assert draws.host_seeds == (0 if name == "flat" and scenario is None
                                else aggs)
    if name == "fog4":
        # the root fires at 20: every device holds the root's model
        for v in st.params.values():
            up = np.ones(24, bool)
            if scenario:
                up = tr.tvnet.snapshot(STEPS).device_up.reshape(-1)
            live = v[torch.from_numpy(up)]
            torch.testing.assert_close(live, live[:1].expand_as(live),
                                       atol=1e-6, rtol=0)


def test_flat_is_bitwise_the_run_without_a_hierarchy():
    _, _, w0 = _reference("flat", None)
    tr0, st0, h0, _ = _port("flat", None, w0, hierarchy=False)
    tr1, st1, h1, _ = _port("flat", None, w0)
    assert tr1.tree is None and tr1.hierarchy is None
    assert h0.global_loss == h1.global_loss
    assert h0.global_acc == h1.global_acc
    assert h0.dispersion == h1.dispersion
    for k in st0.params:
        assert torch.equal(st0.params[k], st1.params[k])
        assert torch.equal(st0.global_params[k], st1.global_params[k])
    assert tr0.ledger == tr1.ledger


def test_all_dark_events_are_the_identity():
    """Every device dark from t = 1: no step, no mixing, no uplink at any
    tier, parameters and the served model bitwise as they were; and the
    all-dark device matrix is I."""
    cfg = presets.get("fog3", tau=5)
    tree = build_tree(cfg, 8, 3)
    ev = aggregate.build_event(np.random.default_rng(0), tree, cfg, 10,
                               np.zeros((8, 3), bool), receive_offline=True)
    assert ev.total_uplinks == 0
    np.testing.assert_array_equal(ev.device_matrix, np.eye(24))
    _, _, w0 = _reference("fog3", None)
    dark = DynamicsConfig(name="blackout", p_device_drop=1.0,
                          p_device_return=0.0, seed=0)
    tr, st, h, draws = _port("fog3", None, w0, dynamics=dark)
    init = params_from_jax(w0, "cpu")
    for k, v in st.params.items():
        assert torch.equal(v, init[k].expand_as(v))
        assert torch.equal(st.global_params[k], init[k])
    assert tr.ledger.uplinks == 0 and tr.ledger.d2d_msgs == 0
    assert tr.ledger.local_steps == 0 and draws.host_seeds == 4


def test_trainer_refuses_mismatched_calendars():
    data = _data()
    args = (make_sim_model("svm", 784, 10), data, TopologyConfig(**TOPO))
    with pytest.raises(ValueError, match="tier-1 period"):
        TTHFTrainer(*args, TTHFConfig(**ALGO), device="cpu",
                    hierarchy=presets.get("fog3", tau=10))
    with pytest.raises(ValueError, match="fan-in"):
        TTHFTrainer(*args, TTHFConfig(**ALGO, sample_per_cluster=2),
                    device="cpu", hierarchy=presets.get("fog3", tau=5))
    with pytest.raises(ValueError, match="sampled tthf"):
        TTHFTrainer(*args, TTHFConfig(**ALGO, full_participation=True),
                    device="cpu", hierarchy=presets.get("fog3", tau=5))
    # the reference asserts the same
    with pytest.raises(AssertionError, match="tier-1 period"):
        JTTHFTrainer(j_make_sim_model("svm", 784, 10), data,
                     JTopologyConfig(**TOPO), JTTHFConfig(**ALGO),
                     hierarchy=j_presets.get("fog3", tau=10))
