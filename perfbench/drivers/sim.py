"""The TT-HF simulation (Algorithm 1) through ``repro_torch.core.tthf.
TTHFTrainer`` with the ``consensus_mix`` kernel, continued through
``run(state=)`` one aggregation period at a time.

Set-up builds the trainer on the benchmark's data, weights and draws,
and runs the first ``warmup_chunks`` periods: the steps the reference
follows. The window runs the fewest further periods that cover the
run's seconds at the last warm-up period's time and ends on a
synchronise; a traced run profiles ``trace_chunks`` periods instead,
into a spans-only sink.
Then the trainer is freed and the reference runs the same warm-up
steps from the same inputs."""
from __future__ import annotations

import time

import numpy as np

from perfbench import harness, inputs
from perfbench.drivers.common import (
    Followed, Outcome, Run, compare, free, intervals_for, log, peak_bytes)
from perfbench.reference.common import change_norms
from perfbench.reference.sim import SimReference


def churn(traffic: dict, seed: int) -> dict | None:
    """The scenario's device churn, its chain seeded from the run's."""
    if traffic["scenario"] == "static":
        return None
    return {**traffic["dynamics"],
            "seed": inputs.subseed(seed, "churn") % 2**31}


def build(cfg: dict, traffic: dict, x, y, device, seed: int):
    from repro_torch.configs import (DynamicsConfig, TopologyConfig,
                                     TTHFConfig)
    from repro_torch.core import TTHFTrainer
    from repro_torch.data.synth import FederatedDataset
    from repro_torch.models import make_sim_model

    m, topo, sch = cfg["model"], cfg["topology"], cfg["schedule"]
    data = FederatedDataset(x, y, np.full(x.shape[0], x.shape[1], np.int32),
                            m["classes"])
    model = make_sim_model(m["name"], m["dim"], m["classes"], m["hidden"])
    if model.reg != m["reg"]:
        raise ValueError(f"the program's {m['name']} regularizes by "
                         f"{model.reg}, the configuration by {m['reg']}")
    ch = churn(traffic, seed)
    dyn = None if ch is None else DynamicsConfig(
        name=traffic["scenario"], **ch)
    return TTHFTrainer(
        model, data,
        TopologyConfig(num_devices=topo["devices"],
                       num_clusters=topo["clusters"], graph=topo["graph"],
                       target_spectral_radius=topo["target_spectral_radius"],
                       weights=topo["weights"], seed=topo["seed"]),
        TTHFConfig(tau=sch["tau"], consensus_every=sch["consensus_every"],
                   gamma_d2d=sch["gamma_d2d"], constant_lr=sch["lr"],
                   sample_per_cluster=sch["sample_per_cluster"]),
        batch_size=cfg["batch"], use_kernel=True, dynamics=dyn,
        device=device)


def ledger_of(tr) -> dict:
    led = tr.ledger
    return {"uplinks": led.uplinks, "d2d_msgs": led.d2d_msgs,
            "d2d_rounds": led.d2d_rounds, "local_steps": led.local_steps}


def setup(cell, seed: int, device):
    """The trainer driven through its warm-up periods. -> (trainer,
    state, what they produced, the last period's seconds)."""
    cfg, traffic = cell.config, cell.traffic
    chunk, every = cfg["schedule"]["tau"], cfg["eval_every"]
    x, y = inputs.sim_data(cfg, seed)
    tr = build(cfg, traffic, x, y, device, seed)
    w0 = inputs.nn_weights(cfg, seed, device)
    st = tr.init(w0=w0, draws=inputs.Draws(seed))
    if tr.model_dim != cfg["parameters_per_device"]:
        raise ValueError(f"the program's model has {tr.model_dim} "
                         f"parameters, the configuration "
                         f"{cfg['parameters_per_device']}")
    losses, first, per_chunk = [], None, 0.0
    for k in range(traffic["warmup_chunks"]):
        t0 = time.perf_counter()
        st, hist = tr.run(chunk, eval_every=every, state=st)
        harness.sync(device)
        per_chunk = time.perf_counter() - t0
        losses += hist.global_loss
        if k == 0:
            first = change_norms(st.params, w0)
    got = Followed(losses, first, change_norms(st.params, w0),
                   ledger_of(tr))
    return tr, st, got, per_chunk


def follow(cell, seed: int, device, prec: str = "highest",
           fault: str | None = None) -> Followed:
    """The reference through the warm-up periods from the same inputs."""
    cfg = cell.config
    chunk, every = cfg["schedule"]["tau"], cfg["eval_every"]
    x, y = inputs.sim_data(cfg, seed)
    ref = SimReference(cfg, x, y, inputs.nn_weights(cfg, seed, device),
                       device, prec=prec, fault=fault,
                       churn=churn(cell.traffic, seed))
    draws = inputs.Draws(seed)
    losses, first = [], None
    for k in range(cell.traffic["warmup_chunks"]):
        losses += ref.run(chunk, draws, every)
        if k == 0:
            first = ref.change_norms()
    return Followed(losses, first, ref.change_norms(), ref.ledger)


def run(r: Run) -> Outcome:
    from repro_torch.kernels.consensus_mix import consensus_mix
    from repro_torch.obs.sink import Observability

    cfg, traffic = r.cell.config, r.cell.traffic
    dev = r.device
    sch = cfg["schedule"]
    chunk, every = sch["tau"], cfg["eval_every"]
    tr, st, got, per_chunk = setup(r.cell, r.seed, dev)

    facts: dict = {"kind": "sim"}
    e2e: dict = {}
    trace = None
    if r.trace:
        harness.trace(lambda: None, dev)     # the profiler's own start-up
        e2e["setup_s"] = r.setup_s()
        n = traffic["trace_chunks"]
        launches = consensus_mix.launches
        obs = Observability()        # takes its clock anchor here
        (st, hists), trace = harness.trace(
            lambda: _chunks(tr, st, n, chunk, every, obs), dev)
        obs.close()
        facts.update(spans=obs.spans(), steps=n * chunk,
                     consensus_events=n * chunk // sch["consensus_every"],
                     aggregations=n * chunk // sch["tau"],
                     evals=n * chunk // every,
                     consensus_mix_launches=consensus_mix.launches
                     - launches)
    else:
        e2e["setup_s"] = r.setup_s()
        n = intervals_for(r.seconds, per_chunk)
        harness.sync(dev)
        t0 = time.perf_counter()
        st, hists = _chunks(tr, st, n, chunk, every)
        harness.sync(dev)
        wall = time.perf_counter() - t0
        e2e["sim_steps_per_s"] = n * chunk / wall
        log(f"window: {n} x {chunk} steps in {wall:.3f} s")
    bad = sum(not np.isfinite(h.global_loss).all() for h in hists)
    peak = peak_bytes(dev)
    e2e["peak_mem_gib"] = peak / 2**30
    del tr, st
    free(dev)
    t0 = time.perf_counter()
    ref = follow(r.cell, r.seed, dev)
    log(f"reference: {time.perf_counter() - t0:.3f} s")
    return Outcome(end_to_end=e2e, facts=facts,
                   checks=compare(got, ref, r.cell.limits),
                   attempted=n * chunk, failed=int(bad) * chunk,
                   peak_bytes=peak, trace=trace)


def _chunks(tr, st, n: int, chunk: int, every: int, obs=None):
    hists = []
    for _ in range(n):
        st, hist = tr.run(chunk, eval_every=every, state=st, obs=obs)
        hists.append(hist)
    return st, hists
