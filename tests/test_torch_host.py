"""Host layer of the PyTorch port against the JAX reference: the copied
modules (topology, data, ledger, round programs) must agree EXACTLY;
the ported schedules agree exactly in float32 (the Remark-1 Γ rule
included); the static resolver emits the same event calendar."""
import _torch_threads  # noqa: F401  (torch threads per xdist worker)
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import TopologyConfig as JTopologyConfig
from repro.configs.base import TTHFConfig as JTTHFConfig
from repro.core import energy as j_energy
from repro.core import schedule as j_schedule
from repro.core import topology as j_topology
from repro.data import partition as j_partition
from repro.data import synth as j_synth
from repro.optim import schedules as j_schedules
from repro.rounds import RoundProgram as JRoundProgram
from repro.rounds import RoundResolver as JRoundResolver
from repro.rounds import program as j_program

from repro_torch.configs.base import (
    ControlConfig, DynamicsConfig, HierarchyConfig)
from repro_torch.configs.base import TopologyConfig, TTHFConfig
from repro_torch.core import energy, schedule, topology
from repro_torch.data import partition, synth
from repro_torch.optim import schedules
from repro_torch.rounds import RoundProgram, RoundResolver
from repro_torch.rounds import program


@pytest.mark.parametrize("graph,weights,I,N", [
    ("ring", "metropolis", 20, 4), ("ring", "laplacian", 12, 6),
    ("complete", "metropolis", 15, 3), ("complete", "laplacian", 8, 2),
    ("geometric", "metropolis", 25, 5), ("geometric", "laplacian", 40, 5),
])
@pytest.mark.parametrize("seed", [0, 3])
def test_build_network_exact(graph, weights, I, N, seed):
    kw = dict(num_devices=I, num_clusters=N, graph=graph, weights=weights,
              seed=seed)
    ref = j_topology.build_network(JTopologyConfig(**kw))
    got = topology.build_network(TopologyConfig(**kw))
    for name in ("V", "adj", "lambdas"):
        a, b = getattr(ref, name), getattr(got, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert np.array_equal(ref.varrho, got.varrho)
    assert np.array_equal(ref.num_d2d_edges(), got.num_d2d_edges())
    assert ref.geometric_fallbacks == got.geometric_fallbacks
    assert got.V.dtype == np.float32 and got.lambdas.dtype == np.float64


@pytest.mark.parametrize("seed", [0, 1])
def test_data_shards_exact(seed):
    x, y = synth.fashion_synth(num_points=900, seed=seed)
    xr, yr = j_synth.fashion_synth(num_points=900, seed=seed)
    assert np.array_equal(x, xr) and np.array_equal(y, yr)
    for fn, jfn, kw in (
            (partition.partition_noniid_labels,
             j_partition.partition_noniid_labels,
             dict(num_devices=9, labels_per_device=3, seed=seed)),
            (partition.partition_iid, j_partition.partition_iid,
             dict(num_devices=9, seed=seed))):
        got, ref = fn(x, y, **kw), jfn(xr, yr, **kw)
        for name in ("x", "y", "counts"):
            a, b = getattr(ref, name), getattr(got, name)
            assert a.dtype == b.dtype and np.array_equal(a, b), name
        assert got.num_classes == ref.num_classes


def _drive_ledger(mod):
    led = mod.CommLedger()
    led.next_event()
    led.record_local_step(25)
    led.record_consensus([2, 0, 3], [4, 5, 6],
                         tail_mult_per_cluster=[1.0, 2.5, 1.2])
    led.next_event()
    led.record_hierarchy_event({1: 5, 2: 2}, uplink_delay_mults=[1.0, 3.0])
    led.record_aggregation(4)
    return led


def test_comm_ledger_exact():
    ref, got = _drive_ledger(j_energy), _drive_ledger(energy)
    assert dataclasses.asdict(ref) == dataclasses.asdict(got)
    assert ref.energy(0.1) == got.energy(0.1)
    assert ref.delay(0.3) == got.delay(0.3)
    assert ref.attribution_totals() == got.attribution_totals()
    assert ref.d2d_by_cluster() == got.d2d_by_cluster()


def test_billing_charge_exact():
    kw = dict(consensus_edges=np.array([3, 4]), consensus_repeats=2,
              uplinks_by_level={1: 2})
    ref, got = j_energy.CommLedger(), energy.CommLedger()
    j_program.Billing(**kw).charge(ref, np.array([2, 1]))
    program.Billing(**kw).charge(got, np.array([2, 1]))
    assert dataclasses.asdict(ref) == dataclasses.asdict(got)


# the trainer's schedules (paper, constant) agree exactly; the cosine
# ones differ by the last bits of XLA's and torch's float32 cos
@pytest.mark.parametrize("name,args,rtol", [
    ("paper_schedule", (1.0, 1.0), 0), ("paper_schedule", (0.3, 7.0), 0),
    ("constant", (2e-3,), 0), ("cosine", (0.1, 50, 0.01), 1e-6),
    ("warmup_cosine", (0.1, 10, 60, 0.001), 1e-6),
])
def test_lr_schedules_f32(name, args, rtol):
    ref, got = getattr(j_schedules, name)(*args), getattr(schedules, name)(*args)
    for t in range(0, 70, 3):
        a, b = ref(t), got(t)
        assert b.dtype == torch.float32
        np.testing.assert_allclose(b.item(), np.float32(a), rtol=rtol,
                                   atol=0, err_msg=f"t={t}")


@pytest.mark.parametrize("seed", range(4))
def test_adaptive_gamma_exact(seed):
    rng = np.random.default_rng(seed)
    N = 25
    ups = rng.uniform(1e-6, 0.5, size=N).astype(np.float32)
    ups[:3] = 0.0                                  # agreed clusters: Γ = 0
    lam = rng.uniform(0.2, 0.95, size=N).astype(np.float32)
    for eta in (2e-3, 0.05, 1.0):
        for M in (7850, 6_232_810):
            ref_g, ref_sat = j_schedule.adaptive_gamma_info(
                jnp.float32(eta), 1.0, jnp.asarray(ups), jnp.asarray(lam),
                5, M, max_rounds=40)
            got_g, got_sat = schedule.adaptive_gamma_info(
                torch.tensor(eta, dtype=torch.float32), 1.0,
                torch.from_numpy(ups), torch.from_numpy(lam), 5, M,
                max_rounds=40)
            assert got_g.dtype == torch.int32
            assert np.array_equal(np.asarray(ref_g), got_g.numpy())
            assert np.array_equal(np.asarray(ref_sat), got_sat.numpy())
    assert np.array_equal(
        np.asarray(j_schedule.fixed_gamma(6, 3)),
        schedule.fixed_gamma(6, 3).numpy())


@pytest.mark.parametrize("algo_kw", [
    dict(tau=20, consensus_every=5), dict(tau=5, consensus_every=2),
    dict(tau=6, consensus_every=4, sample_per_cluster=2),
    dict(mode="fedavg", tau=4, full_participation=True, consensus_every=0),
    dict(mode="centralized", tau=1, full_participation=True,
         consensus_every=0),
])
@pytest.mark.parametrize("eval_every", [1, 5, 7])
def test_static_resolver_calendar_exact(algo_kw, eval_every):
    kw = dict(num_devices=12, num_clusters=3, graph="geometric")
    jnet = j_topology.build_network(JTopologyConfig(**kw))
    net = topology.build_network(TopologyConfig(**kw))
    ref = JRoundResolver.for_sim(jnet, JTTHFConfig(**algo_kw),
                                 JRoundProgram())
    got = RoundResolver.for_sim(net, TTHFConfig(**algo_kw), RoundProgram())
    t_last = 41
    for t in range(1, t_last + 1):
        assert got.span_end(t, t_last, eval_every) == \
            ref.span_end(t, t_last, eval_every)
        a, b = ref.resolve(t, None), got.resolve(t)
        assert (a.consensus is None) == (b.consensus is None)
        if a.consensus is not None:
            assert np.array_equal(a.consensus.edges, b.consensus.edges)
        assert (a.aggregation is None) == (b.aggregation is None)
        if a.aggregation is not None:
            assert (a.aggregation.kind, a.aggregation.full) == \
                (b.aggregation.kind, b.aggregation.full)
        assert a.billing.uplinks_by_level == b.billing.uplinks_by_level
        assert a.active_devices == b.active_devices


@pytest.mark.parametrize("prog", [
    RoundProgram(control=ControlConfig(policy="remark1")),
    RoundProgram(hierarchy=HierarchyConfig(levels=3, taus=(5, 10),
                                           sample=(1, 0))),
])
def test_resolver_refuses_unported_programs(prog):
    # every program resolves now; what the resolver refuses is what the
    # reference asserts against: here a calendar that does not fit (a
    # star baseline has no Γ to control; a tier-1 period other than τ)
    net = topology.build_network(TopologyConfig(num_devices=12,
                                                num_clusters=3))
    res = RoundResolver.for_sim(net, TTHFConfig(tau=5), prog)
    assert (res.controller is not None) == prog.is_adaptive
    assert (res.tree is not None) == prog.is_hierarchical
    bad = (TTHFConfig(mode="fedavg", tau=5, full_participation=True)
           if prog.is_adaptive else TTHFConfig(tau=10))
    with pytest.raises(ValueError):
        RoundResolver.for_sim(net, bad, prog)
    # the static declarations of the same knobs resolve as the paper's
    res = RoundResolver.for_sim(net, TTHFConfig(tau=5), RoundProgram(
        dynamics=DynamicsConfig(), hierarchy=HierarchyConfig(),
        control=ControlConfig()))
    assert res.tvnet is None
