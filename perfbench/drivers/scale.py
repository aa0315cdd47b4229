"""TT-HF training of a language model over replicas through
``repro_torch.train.trainer.ScaleTrainer`` with the fused interval
(``TrainerConfig(fused_interval=True)``: every consensus block ends in
``fused_consensus_sgd``), its prefetch on and remat as by default.

Whatever is the model's own comes from the plug-in of the
configuration's ``model.kind`` (``harness.model_plugin``): the
program's configuration, the weights from the seed and the plain
model's loss, which ``reference/scale.py``'s interval takes.

The trainer's replica streams are the benchmark's token streams and its
draws the benchmark's. Set-up builds it and runs ``warmup_intervals``
through ``run``, recording each interval's loss and the change of the
global model after the first and the last. The window is one
``run(n)``, n the fewest intervals that cover the run's seconds at the
last warm-up interval's time, ending on a synchronise. A traced run
calls ``run(trace_intervals)`` into a spans-only sink and profiles its
last interval's step. Then the trainer is freed and the reference
follows the warm-up."""
from __future__ import annotations

import math
import time

import torch

from perfbench import harness, inputs
from perfbench.drivers.common import (
    Followed, Outcome, Run, compare, free, intervals_for, log, peak_bytes)
from perfbench.reference.scale import ScaleReference


def streams(cfg: dict, traffic: dict, seed: int) -> list:
    return [inputs.token_stream(seed, r, traffic["batch_per_replica"],
                                traffic["seq_len"],
                                cfg["model"]["vocab_size"])
            for r in range(traffic["replicas"])]


def build(cfg: dict, traffic: dict, seed: int, device):
    from repro_torch.core.distributed import TTHFScaleConfig
    from repro_torch.train import ScaleTrainer, TrainerConfig
    t = traffic
    sc = TTHFScaleConfig(replicas=t["replicas"],
                         cluster_size=t["cluster_size"], tau=t["tau"],
                         consensus_every=t["consensus_every"],
                         gamma_d2d=t["gamma_d2d"], lr=t["lr"],
                         graph=t["graph"])
    tcfg = TrainerConfig(batch_per_replica=t["batch_per_replica"],
                         seq_len=t["seq_len"], eval_every=0,
                         dtype=cfg["dtype"], fused_interval=True)
    tr = ScaleTrainer(harness.model_plugin(cfg).model_config(cfg), sc,
                      tcfg, device=device)
    # the replicas read the benchmark's token streams
    tr._gens = streams(cfg, traffic, seed)
    return tr


def ledger_of(tr) -> dict:
    led = tr.ledger
    return {"uplinks": led.uplinks, "d2d_msgs": led.d2d_msgs,
            "d2d_rounds": led.d2d_rounds, "local_steps": led.local_steps}


def global_change(tr, w0_host: dict, device) -> dict:
    """{leaf: ||global model - w0||}, a leaf's rows a few at a time."""
    out = {}
    for path, v in inputs.tree_items(tr._global_params()):
        name = ".".join(path)
        rows = v if v.ndim > 1 else v[None]
        base = w0_host[name]
        base = base if base.ndim > 1 else base[None]
        acc = 0.0
        for i in range(0, rows.shape[0], 8):
            d = rows[i:i + 8].double() - base[i:i + 8].to(device).double()
            acc += float(d.square().sum())
        out[name] = acc ** 0.5
    return out


class Recorder:
    """Wraps the trainer's interval step: each interval's loss (read
    where the trainer reads it too) and seconds; in set-up the global
    model's change after the intervals in ``at``; the profile of the
    interval ``trace_at``."""

    def __init__(self, tr, w0_host, device, at: set):
        self.tr, self.w0, self.dev, self.at = tr, w0_host, device, at
        self.step = tr._step
        self.losses, self.times, self.norms = [], [], {}
        self.trace_at, self.trace = None, None
        self.t = time.perf_counter()
        tr._step = self

    def __call__(self, *args, **kw):
        k = len(self.losses) + 1
        if k == self.trace_at:
            out, self.trace = harness.trace(
                lambda: self.step(*args, **kw), self.dev)
        else:
            out = self.step(*args, **kw)
        self.losses.append(float(out[1]))      # synchronises
        now = time.perf_counter()
        self.times.append(now - self.t)
        if k in self.at:
            self.tr.params = out[0]
            self.norms[k] = global_change(self.tr, self.w0, self.dev)
        self.t = time.perf_counter()
        return out

    def close(self):
        self.tr._step = self.step


def setup(cell, seed: int, device):
    """The trainer driven through its warm-up intervals. -> (trainer,
    its recorder, what it produced)."""
    cfg, traffic = cell.config, cell.traffic
    torch.backends.cuda.matmul.allow_tf32 = cfg["tf32"]
    torch.backends.cudnn.allow_tf32 = cfg["tf32"]
    tr = build(cfg, traffic, seed, device)
    w0 = harness.model_plugin(cfg).weights(cfg, seed, device)
    tr.init(w0=w0, draws=inputs.Draws(seed))
    if tr._spec.total != cfg["parameters"]:
        raise ValueError(f"the program's model has {tr._spec.total} "
                         f"parameters, the configuration "
                         f"{cfg['parameters']}")
    w0_host = {".".join(p): v.cpu() for p, v in inputs.tree_items(w0)}
    del w0
    warm = traffic["warmup_intervals"]
    rec = Recorder(tr, w0_host, device, {1, warm})
    tr.run(warm)
    rec.at = set()
    got = Followed(list(rec.losses), rec.norms[1], rec.norms[warm],
                   ledger_of(tr))
    return tr, rec, got


def follow(cell, seed: int, device, prec: str = "highest",
           fault: str | None = None) -> Followed:
    """The reference through the warm-up intervals, same inputs."""
    cfg, traffic = cell.config, cell.traffic
    model = harness.model_plugin(cfg)
    ref = ScaleReference(cfg, traffic, model.weights(cfg, seed, device),
                         model.loss, device, prec=prec, fault=fault)
    ss = streams(cfg, traffic, seed)
    draws = inputs.Draws(seed)
    losses, first = [], None
    for k in range(traffic["warmup_intervals"]):
        losses.append(ref.interval(ss, draws))
        if k == 0:
            first = ref.change_norms()
    return Followed(losses, first, ref.change_norms(), ref.ledger)


def run(r: Run) -> Outcome:
    from repro_torch.kernels.fused_consensus_sgd import fused_consensus_sgd
    from repro_torch.obs.sink import Observability

    traffic = r.cell.traffic
    dev = r.device
    tr, rec, got = setup(r.cell, r.seed, dev)
    warm = len(rec.losses)
    tok = traffic["tau"] * traffic["replicas"] \
        * traffic["batch_per_replica"] * traffic["seq_len"]
    facts: dict = {"kind": "scale"}
    e2e: dict = {}
    if r.trace:
        harness.trace(lambda: None, dev)     # the profiler's own start-up
        e2e["setup_s"] = r.setup_s()
        n = traffic["trace_intervals"]
        rec.trace_at = warm + n
        launches = fused_consensus_sgd.launches
        obs = Observability()        # takes its clock anchor here
        tr.run(n, obs=obs)
        obs.close()
        facts.update(intervals=1, fused_consensus_sgd_launches=(
            fused_consensus_sgd.launches - launches) // n,
            spans=obs.spans())
    else:
        e2e["setup_s"] = r.setup_s()
        n = intervals_for(r.seconds, rec.times[-1])
        harness.sync(dev)
        t0 = time.perf_counter()
        tr.run(n)
        harness.sync(dev)
        wall = time.perf_counter() - t0
        e2e["train_tokens_per_s"] = n * tok / wall
        log(f"window: {n} intervals in {wall:.3f} s; set-up intervals "
            f"{[round(t, 3) for t in rec.times[:warm]]} s")
    rec.close()
    failed = sum(not math.isfinite(x) for x in rec.losses[warm:])
    peak = peak_bytes(dev)
    e2e["peak_mem_gib"] = peak / 2**30
    del tr, rec.tr
    free(dev)
    t0 = time.perf_counter()
    ref = follow(r.cell, r.seed, dev)
    log(f"reference: {time.perf_counter() - t0:.3f} s")
    return Outcome(end_to_end=e2e, facts=facts,
                   checks=compare(got, ref, r.cell.limits),
                   attempted=n, failed=failed, peak_bytes=peak,
                   trace=rec.trace)
