"""Scale-mode trainer — the port of ``repro/train/trainer.py``: the
TT-HF interval loop with evaluation, metric logging and the
communication ledger around :func:`repro_torch.core.distributed.
make_tthf_train_step`.

Handles: data sharding per replica, interval batching (tau x R x b x
T), periodic held-out eval of the *global* model, checkpoint save and
resume, the ledger, and the observability sink (spans, the per-interval
``round``/``comm`` records and the ``ledger`` counter; the trace dir's
sink by default, any sink through ``run(obs=)``). Every
scenario (static, netsim dynamics, fog hierarchy, the control plane and
their compositions) runs through ONE ``_interval``: the
:class:`~repro_torch.rounds.resolver.RoundResolver` supplies the step's
aggregation argument (picks, the (N, s) weights or the composed (R, R)
device matrix, whichever form the step was built for), the optional
refresh of the mixing matrices (the controller's Γ folds into it) and
the interval's :class:`~repro_torch.rounds.program.Billing`, which bills
the realized Γ. Under a fog hierarchy the served global model is the
root's snapshot, taken when the root fires.

The reference splits a JAX key per interval and draws the picks (or the
seed of a host generator) from it. The port takes them from a *draw
source* instead (``picks(N, s, k)`` or ``host_seed()``, one call per
interval; default :class:`~repro_torch.core.sampling.TorchDraws`), so a
test can feed it the reference's draws. The token streams are numpy and
equal the reference's. A checkpoint carries the draw source's state
(``draws.state_dict()``) where the reference carries its key.

The interval step rematerializes its layers' activations in the
backward (the reference's ``make_tthf_train_step`` default); the
evaluation loss and the gradient probe, which are no training step,
pass ``remat=False`` as the reference's do. ``donate=True``
(the reference's default) is the port's in-place step: the step
updates the parameter tensors it is given, so a tensor taken from
``trainer.params`` before an interval holds the interval's result.
``donate=False`` leaves those tensors as they were: the step works on a
copy, the counterpart of an undonated ``jit``. The vlm,
encdec and audio kinds raise ``ValueError`` at construction: the
interval batch holds tokens and labels only, and the reference's
trainer fails on these kinds with a ``KeyError`` on the missing
``patches`` / ``frames``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.checkpoint import restore_train_state, save_train_state
from repro_torch.configs.base import (
    DynamicsConfig, HierarchyConfig, ModelConfig)
from repro_torch.core.distributed import (
    TTHFScaleConfig, make_tthf_train_step, stack_replicas)
from repro_torch.core.energy import CommLedger
from repro_torch.core.mixing import build_mixing_plan, canonical_backend
from repro_torch.core.sampling import TorchDraws
from repro_torch.data.tokens import synthetic_token_batches
from repro_torch.kernels.runtime import DeviceLike, resolve_device
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.models.registry import ModelApi, build_model
from repro_torch.models.transformer import FRONTEND_KINDS
from repro_torch.obs.sink import make_obs
from repro_torch.obs.telemetry import emit_comm
from repro_torch.rounds import RoundProgram, RoundResolver
from repro_torch.train.metrics import MetricLogger
from repro_torch.train.prefetch import PrefetchLoader

# the only dtypes the microstep math supports
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass
class TrainerConfig:
    batch_per_replica: int = 4
    seq_len: int = 256
    intervals: int = 10
    eval_every: int = 5
    eval_batches: int = 2
    ckpt_every: int = 0             # 0 = off
    ckpt_dir: str = "checkpoints"
    log_path: Optional[str] = None
    dtype: str = "float32"
    seed: int = 0
    donate: bool = True             # the step updates params in place;
                                    # False: it works on a copy
    fused_interval: bool = False    # flat (R, P) param carrier + fused
                                    # SGD+consensus block-ends
    prefetch: bool = True           # build/copy interval k+1's batch
                                    # while interval k computes
    # observability (repro_torch.obs): a trace dir turns on the span
    # tracer + theory-bound telemetry stream + run manifest; profile
    # adds a torch.profiler trace in <trace_dir>/torch_profile/
    trace_dir: Optional[str] = None
    profile: bool = False

    def __post_init__(self):
        if self.dtype not in _DTYPES:
            raise ValueError(
                f"unknown dtype {self.dtype!r}; expected one of "
                f"{sorted(_DTYPES)}")


class ScaleTrainer:
    def __init__(self, cfg: ModelConfig, scale: TTHFScaleConfig,
                 tcfg: TrainerConfig, sync: str = "tthf",
                 dynamics: Optional[DynamicsConfig] = None,
                 hierarchy: Optional[HierarchyConfig] = None,
                 program: Optional[RoundProgram] = None,
                 device: DeviceLike = None):
        if cfg.kind in FRONTEND_KINDS:
            # the reference's interval batch carries tokens and labels
            # only, so its loss fails on batch["patches"] / ["frames"]
            raise ValueError(
                f"{cfg.name}: the scale trainer feeds token batches only; "
                f"the {cfg.kind!r} kind needs frontend inputs (patches/"
                "frames), as in the reference, whose scale trainer fails "
                "on them")
        if program is None:
            program = RoundProgram(dynamics=dynamics, hierarchy=hierarchy)
        elif dynamics is not None or hierarchy is not None:
            raise ValueError("pass either program= or the dynamics=/"
                             "hierarchy= kwargs, not both")
        self.cfg = cfg
        self.scale = scale
        self.tcfg = tcfg
        self.sync = sync
        self.program = program
        if program.is_hierarchical and sync != "tthf":
            raise ValueError("hierarchy implies tthf sync")
        if program.is_adaptive:
            if sync != "tthf":
                raise ValueError(
                    "the control plane retunes D2D consensus — star/local "
                    "sync has no Γ to control")
            if canonical_backend(scale.consensus_mode) != "fused_power":
                raise ValueError(
                    "per-interval Γ retuning folds into refreshed W = V^Γ "
                    "— only the fused_power backend consumes it")
        self.device = resolve_device(device)
        self.model: ModelApi = build_model(cfg)
        self.dtype = _DTYPES[tcfg.dtype]
        # only a tthf step carries consensus matrices to refresh: netsim
        # dynamics and the controller's Γ arrive as each interval's
        # refreshed matrices
        refreshable = ((program.is_dynamic or program.is_adaptive)
                       and sync == "tthf")
        step, self.net = make_tthf_train_step(
            self.model, scale, dtype=self.dtype, sync=sync,
            hierarchy=program.hierarchy, refreshable=refreshable,
            fused_interval=tcfg.fused_interval, device=self.device)
        # fused-interval runs carry self.params as the step's flat (R, P)
        # buffer; the spec unflattens (as views) at eval boundaries
        self._spec = getattr(step, "spec", None)
        self._step = step
        self._plan = None
        if refreshable:
            self._plan = build_mixing_plan(
                self.net, scale.gamma_d2d, backend=scale.consensus_mode,
                device=self.device)
        self._resolver = RoundResolver.for_scale(self.net, scale, program,
                                                 plan=self._plan)
        self.hierarchy = self._resolver.hierarchy
        self.tree = self._resolver.tree
        self.tvnet = self._resolver.tvnet
        self.ledger = CommLedger()
        self.metrics = MetricLogger(tcfg.log_path)
        # observability sink (NULL_OBS when trace_dir unset): spans,
        # theory-bound telemetry, manifest. Probes are built at the
        # first instrumented run and only read the parameters — an
        # instrumented run is bitwise the bare one
        self.obs = make_obs(
            tcfg.trace_dir, profile=tcfg.profile, run_name="train-scale",
            config={"model": cfg, "scale": scale, "trainer": tcfg},
            extra={"arch": cfg.name, "sync": sync})
        self._obs_probe = None
        self._obs_grad_probe = None
        self._obs_gauges = None
        self._obs_gen = None        # dedicated grad-probe batch stream
        self._make_gens()
        # resume fidelity: batches drawn so far from every train
        # generator (identical across replicas) and from the eval
        # stream — saved so that restore-and-continue replays neither
        self._train_draws = 0
        self._eval_draws = 0
        self.params = None
        self.draws: Any = None
        # hierarchical runs: the SERVED global model, taken only when the
        # root fires (between root events replicas under different fog
        # nodes disagree)
        self._global: Optional[dict] = None
        self.interval = 0

    def _make_gens(self, train_start: int = 0, eval_start: int = 0):
        """One token stream per replica and one for evaluation, seeded
        as the reference's, already past the first ``train_start`` /
        ``eval_start`` batches (restore seeks instead of replaying)."""
        tcfg, cfg = self.tcfg, self.cfg
        self._gens = [synthetic_token_batches(
            tcfg.batch_per_replica, tcfg.seq_len, cfg.vocab_size,
            seed=tcfg.seed, shard_id=r, start=train_start)
            for r in range(self.scale.replicas)]
        self._eval_gen = synthetic_token_batches(
            tcfg.batch_per_replica, tcfg.seq_len, cfg.vocab_size,
            seed=tcfg.seed + 10_000, shard_id=99, start=eval_start)

    # ------------------------------------------------------------------
    def init(self, w0: Optional[dict] = None, draws: Any = None):
        """The starting state: ``w0`` (one replica's parameter tree;
        default: the model's init from a generator seeded with
        ``tcfg.seed``) on every replica, and the draw source (default:
        :class:`~repro_torch.core.sampling.TorchDraws` continuing that
        generator)."""
        gen = torch.Generator(device=self.device).manual_seed(self.tcfg.seed)
        if w0 is None:
            w0 = self.model.init(gen, self.device)
        w0 = tree_map(lambda v: torch.as_tensor(v, device=self.device), w0)
        R = self.scale.replicas
        if self._spec is not None:
            self.params = self._spec.flatten(
                tree_map(lambda l: l.expand((R,) + tuple(l.shape)), w0))
        else:
            self.params = stack_replicas(w0, R)
        self.draws = draws if draws is not None else TorchDraws(gen)
        if self.tree is not None:
            self._global = tree_map(lambda v: v.clone(), w0)
        return self

    def _build_interval_batch(self):
        """Pure batch build (tau, R, b, T) on the host — no draw
        accounting (the prefetch worker calls this off-thread)."""
        tau, R = self.scale.tau, self.scale.replicas
        mbs = [[next(g) for _ in range(tau)] for g in self._gens]
        return {k: torch.from_numpy(np.stack(
            [[mbs[r][t][k] for r in range(R)] for t in range(tau)]))
            for k in ("tokens", "labels")}

    def _to_device(self, batch: dict) -> dict:
        return {k: v.to(self.device) for k, v in batch.items()}

    def _interval_batch(self):
        batch = self._to_device(self._build_interval_batch())
        self._train_draws += self.scale.tau
        return batch

    def _replica0(self) -> dict:
        """Replica 0's parameter tree (views, either carrier)."""
        if self._spec is not None:
            return self._spec.unflatten_one(self.params[0])
        return tree_map(lambda l: l[0], self.params)

    def _global_params(self) -> dict:
        """The served global model. Flat runs: replica 0's copy, identical
        to all others right after the interval's aggregation.
        Hierarchical runs: the root's snapshot (the initial broadcast
        until the root first fires)."""
        if self.tree is not None:
            return self._global
        return self._replica0()

    def evaluate(self) -> float:
        g = self._global_params()
        losses = []
        with torch.no_grad():
            for _ in range(self.tcfg.eval_batches):
                b = self._to_device({k: torch.from_numpy(v) for k, v in
                                     next(self._eval_gen).items()})
                self._eval_draws += 1
                losses.append(float(self.model.loss(g, b, dtype=self.dtype,
                                                    remat=False)))
        return float(np.mean(losses))

    # ------------------------------------------------------------------
    # observability
    # ------------------------------------------------------------------
    def _ensure_obs(self):
        from repro_torch.obs.telemetry import (
            TheoryGauges, default_constants, make_divergence_probe,
            make_scale_grad_probe)

        if self._obs_probe is not None:
            return
        self._obs_probe = make_divergence_probe(
            self.scale.num_clusters, self.scale.cluster_size,
            self.net.varrho)
        self._obs_grad_probe = make_scale_grad_probe(self.model, self.dtype)
        # a dedicated probe stream: grad-norm batches never touch the
        # train/eval draws, so the data trajectory is unchanged
        self._obs_gen = synthetic_token_batches(
            self.tcfg.batch_per_replica, self.tcfg.seq_len,
            self.cfg.vocab_size, seed=self.tcfg.seed + 20_000, shard_id=98)
        model_dim = int(sum(l.numel()
                            for l in tree_leaves(self._replica0())))
        self._obs_gauges = TheoryGauges(
            constants=default_constants(float(np.min(self.net.varrho))),
            tau=self.scale.tau, model_dim=model_dim, lr=self.scale.lr)

    def _probe_params(self):
        """The replica stack the divergence probe reads: the per-leaf
        tree, or the flat carrier without its pad columns."""
        if self._spec is not None:
            return self.params[:, :self._spec.total]
        return self.params

    def _emit_interval_telemetry(self, obs, loss, ledger_mark, ev):
        """One drain per interval: the probe over the parameters, then
        measured divergence + theory gauges + comms attribution into the
        shared JSONL stream. ``self.interval`` is still the 0-based
        index of the interval that just ran."""
        aux = {k: v.cpu().numpy()
               for k, v in self._obs_probe(self._probe_params()).items()}
        tau = self.scale.tau
        t = (self.interval + 1) * tau
        rec = {"train_loss": float(loss), **aux}
        rec.update(self._obs_gauges.round_gauges(t, t - tau))
        if self.scale.consensus_every:
            N = self.scale.num_clusters
            if ev.control is not None:
                # the controller's realized (billed) per-cluster rounds
                rec["gamma_used"] = np.asarray(ev.billing.consensus_gammas)
            else:
                rec["gamma_used"] = np.full((N,), self.scale.gamma_d2d)
            rec["lemma1_bound"] = self._obs_gauges.lemma1(
                self.net.lambdas, rec["gamma_used"],
                self.scale.cluster_size, aux["upsilon"])
        if ev.control is not None:
            # decision + measured-vs-assumed λ joined into the same row
            rec.update(ev.control.round_fields())
        obs.emit("round", self.interval + 1, **rec)
        emit_comm(obs, self.ledger, ledger_mark, self.interval + 1)

    def _interval(self, batch, obs):
        """ONE interval for every scenario: the resolver's aggregation
        argument and refresh into the step, the root's snapshot when a
        live root event broadcast it, then the interval's bill. Spans
        time the host's dispatch; nothing here waits for the card
        unless the sink has telemetry (the telemetry's drain)."""
        ledger_mark = len(self.ledger.events)
        ev = self._resolver.resolve_interval(self.interval, self.draws)
        params = self.params
        if not self.tcfg.donate:
            # undonated: the caller's tensors stay as they were
            params = (params.clone() if isinstance(params, torch.Tensor)
                      else tree_map(lambda l: l.clone(), params))
        with obs.span("interval", interval=self.interval,
                      tau=self.scale.tau):
            self.params, loss = self._step(params, batch, ev.agg,
                                           self.interval, ev.refresh,
                                           obs=obs)
        if ev.root_served:
            # a copy: the step updates the replicas in place
            self._global = tree_map(lambda l: l.clone(), self._replica0())
        ev.billing.charge(self.ledger)
        if obs.enabled:
            # the interval folds its consensus/aggregation events into
            # one step — mark them as instants so the trace still shows
            # the two timescales
            if ev.billing.consensus_repeats and \
                    ev.billing.consensus_edges is not None:
                obs.instant("consensus_event", interval=self.interval,
                            repeats=ev.billing.consensus_repeats)
            if ev.billing.uplinks_by_level:
                obs.instant("aggregation", interval=self.interval,
                            uplinks_by_level=ev.billing.uplinks_by_level,
                            root_served=ev.root_served)
        if obs.telemetry:
            self._emit_interval_telemetry(obs, loss, ledger_mark, ev)
        return loss

    # ------------------------------------------------------------------
    # checkpoints
    # ------------------------------------------------------------------
    def save(self, path: Optional[str] = None) -> str:
        """Write the train state in the reference's checkpoint format:
        the parameters as a per-leaf tree (whatever the carrier), the
        interval, and in ``extra`` the draw source's state, the data
        streams' positions, the ledger's counters and, under a fog
        hierarchy, the served root snapshot."""
        p = path or str(Path(self.tcfg.ckpt_dir)
                        / f"interval_{self.interval:06d}.npz")
        Path(p).parent.mkdir(parents=True, exist_ok=True)
        extra = {
            "draws": self.draws.state_dict(),
            "train_draws": np.asarray(self._train_draws),
            "eval_draws": np.asarray(self._eval_draws),
            "ledger": {k: np.asarray(v) for k, v in
                       dataclasses.asdict(self.ledger).items()
                       if not isinstance(v, (dict, list))},
            "uplinks_by_level": {
                str(k): np.asarray(v)
                for k, v in self.ledger.uplinks_by_level.items()},
        }
        if self.tree is not None:
            extra["global"] = self._global   # the served root snapshot
        params = (self._spec.unflatten(self.params)
                  if self._spec is not None else self.params)
        save_train_state(p, params, (), self.interval, extra=extra)
        return p

    def restore(self, path: str):
        """Continue from a checkpoint of :meth:`save` (or of the
        reference's trainer, whose key the port cannot use: its draws
        then come from the current source). The parameters land on this
        trainer's device in its carrier, the pad of the flat buffer
        zero; the data streams are rebuilt seeked past the consumed
        batches, so a trainer whose streams have advanced since rolls
        back without skipping twice."""
        params, _, self.interval, extra = restore_train_state(path)
        params = tree_map(lambda v: torch.from_numpy(np.asarray(v)), params)
        if self._spec is not None:
            # flattened on the host: the card holds one copy
            params = self._spec.flatten(params)
        self.params = (params.to(self.device)
                       if isinstance(params, torch.Tensor) else
                       tree_map(lambda v: v.to(self.device), params))
        if self.draws is None:
            self.draws = TorchDraws(torch.Generator(device=self.device))
        if "draws" in extra:
            self.draws.load_state_dict(extra["draws"])
        if self.tree is not None:
            # the served root snapshot (a checkpoint without one: replica
            # 0, exact from the next root event on)
            g = extra.get("global")
            self._global = (tree_map(lambda v: torch.from_numpy(
                np.asarray(v)).to(self.device), g) if g is not None else
                tree_map(lambda l: l.clone(), self._replica0()))
        if "train_draws" in extra:
            self._train_draws = int(extra["train_draws"])
            self._eval_draws = int(extra["eval_draws"])
            for k, v in extra["ledger"].items():
                setattr(self.ledger, k, type(getattr(self.ledger, k))(v))
            self.ledger.uplinks_by_level = {
                int(k): int(v)
                for k, v in extra.get("uplinks_by_level", {}).items()}
            self._make_gens(train_start=self._train_draws,
                            eval_start=self._eval_draws)
        return self

    # ------------------------------------------------------------------
    def run(self, intervals: Optional[int] = None, obs=None):
        """``intervals`` (default ``tcfg.intervals``) intervals into
        ``obs`` (default: the trainer's own sink, the trace dir's or
        ``NULL_OBS``)."""
        if self.params is None:
            self.init()
        obs = obs if obs is not None else self.obs
        if obs.telemetry:
            self._ensure_obs()
        self._resolver.obs = obs
        if self.tvnet is not None:
            self.tvnet.obs = obs
        n = intervals if intervals is not None else self.tcfg.intervals
        loader = None
        if self.tcfg.prefetch and n > 1:
            # interval k+1's batch builds/copies while k computes; draws
            # are counted here per consumed batch, so a mid-run
            # checkpoint never counts the batch in flight
            loader = PrefetchLoader(self._build_interval_batch, depth=1,
                                    put=self._to_device)
        try:
            with obs.span("run", intervals=n, tau=self.scale.tau,
                          replicas=self.scale.replicas):
                for _ in range(n):
                    with obs.span("round", interval=self.interval):
                        self._run_interval(loader, obs)
        finally:
            if loader is not None:
                loader.close()
            obs.flush()
        return self

    def _run_interval(self, loader, obs) -> None:
        """One interval of :meth:`run`: its batch, the step, the logs,
        the eval and the checkpoint that fall due."""
        if loader is not None:
            batch = loader.get()
            self._train_draws += self.scale.tau
        else:
            batch = self._interval_batch()
        loss = self._interval(batch, obs)
        self.interval += 1
        logs = {"train_loss": float(loss),
                "uplinks": self.ledger.uplinks,
                "d2d_msgs": self.ledger.d2d_msgs}
        if self.tcfg.eval_every and \
                self.interval % self.tcfg.eval_every == 0:
            with obs.span("eval", interval=self.interval):
                logs["eval_loss"] = self.evaluate()
            if obs.telemetry:
                b = self._to_device({k: torch.from_numpy(v) for k, v in
                                     next(self._obs_gen).items()})
                logs["grad_norm"] = float(self._obs_grad_probe(
                    self._global_params(), b))
                obs.emit("eval", self.interval, **logs)
        self.metrics.log(self.interval, **logs)
        if self.tcfg.ckpt_every and \
                self.interval % self.tcfg.ckpt_every == 0:
            self.save()

    def close(self):
        """Flush + close the metric and observability sinks (exports
        the Chrome trace when a trace dir is set)."""
        self.metrics.close()
        self.obs.close()


__all__ = ["ScaleTrainer", "TrainerConfig"]
