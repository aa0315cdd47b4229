"""Scale-mode trainer — the port of ``repro/train/trainer.py``: the
TT-HF interval loop with evaluation, metric logging and the
communication ledger around :func:`repro_torch.core.distributed.
make_tthf_train_step`.

Handles: data sharding per replica, interval batching (tau x R x b x
T), periodic held-out eval of the *global* model, and the ledger. Every
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
equal the reference's.

Not ported yet, and refused: checkpoints (``ckpt_every > 0``) and the
observability sink (``trace_dir``, ``profile``) — ROADMAP.md Queue 1
item 5. The reference's ``donate`` knob has no counterpart: the port's
step updates the parameters in place instead.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.configs.base import (
    DynamicsConfig, HierarchyConfig, ModelConfig)
from repro_torch.core.distributed import (
    TTHFScaleConfig, make_tthf_train_step, stack_replicas)
from repro_torch.core.energy import CommLedger
from repro_torch.core.mixing import build_mixing_plan, canonical_backend
from repro_torch.core.sampling import TorchDraws
from repro_torch.data.tokens import synthetic_token_batches
from repro_torch.kernels.runtime import DeviceLike, resolve_device
from repro_torch.models.common import tree_map
from repro_torch.models.registry import ModelApi, build_model
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
    ckpt_every: int = 0             # 0 = off (checkpoints: Queue 1 item 5)
    log_path: Optional[str] = None
    dtype: str = "float32"
    seed: int = 0
    fused_interval: bool = False    # flat (R, P) param carrier + fused
                                    # SGD+consensus block-ends
    prefetch: bool = True           # build/copy interval k+1's batch
                                    # while interval k computes
    trace_dir: Optional[str] = None   # observability: Queue 1 item 5
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
        if cfg.kind not in ("dense", "ssm"):
            raise NotImplementedError(
                f"{cfg.name}: scale mode runs the dense and ssm kinds; the "
                f"{cfg.kind!r} kind is not ported yet (ROADMAP.md Queue 1 "
                "item 6b)")
        if tcfg.ckpt_every or tcfg.trace_dir or tcfg.profile:
            raise NotImplementedError(
                "checkpoints (ckpt_every) and the observability sink "
                "(trace_dir, profile) are not ported yet (ROADMAP.md "
                "Queue 1 item 5)")
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
        self._make_gens()
        self._train_draws = 0
        self._eval_draws = 0
        self.params = None
        self.draws: Any = None
        # hierarchical runs: the SERVED global model, taken only when the
        # root fires (between root events replicas under different fog
        # nodes disagree)
        self._global: Optional[dict] = None
        self.interval = 0

    def _make_gens(self):
        """One token stream per replica and one for evaluation, seeded
        as the reference's."""
        tcfg, cfg = self.tcfg, self.cfg
        self._gens = [synthetic_token_batches(
            tcfg.batch_per_replica, tcfg.seq_len, cfg.vocab_size,
            seed=tcfg.seed, shard_id=r) for r in range(self.scale.replicas)]
        self._eval_gen = synthetic_token_batches(
            tcfg.batch_per_replica, tcfg.seq_len, cfg.vocab_size,
            seed=tcfg.seed + 10_000, shard_id=99)

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
                losses.append(float(self.model.loss(g, b, dtype=self.dtype)))
        return float(np.mean(losses))

    def _interval(self, batch):
        """ONE interval for every scenario: the resolver's aggregation
        argument and refresh into the step, the root's snapshot when a
        live root event broadcast it, then the interval's bill."""
        ev = self._resolver.resolve_interval(self.interval, self.draws)
        self.params, loss = self._step(self.params, batch, ev.agg,
                                       self.interval, ev.refresh)
        if ev.root_served:
            # a copy: the step updates the replicas in place
            self._global = tree_map(lambda l: l.clone(), self._replica0())
        ev.billing.charge(self.ledger)
        return loss

    # ------------------------------------------------------------------
    def run(self, intervals: Optional[int] = None):
        if self.params is None:
            self.init()
        n = intervals if intervals is not None else self.tcfg.intervals
        loader = None
        if self.tcfg.prefetch and n > 1:
            # interval k+1's batch builds/copies while k computes; draws
            # are counted here per consumed batch
            loader = PrefetchLoader(self._build_interval_batch, depth=1,
                                    put=self._to_device)
        try:
            for _ in range(n):
                if loader is not None:
                    batch = loader.get()
                    self._train_draws += self.scale.tau
                else:
                    batch = self._interval_batch()
                loss = self._interval(batch)
                self.interval += 1
                logs = {"train_loss": float(loss),
                        "uplinks": self.ledger.uplinks,
                        "d2d_msgs": self.ledger.d2d_msgs}
                if self.tcfg.eval_every and \
                        self.interval % self.tcfg.eval_every == 0:
                    logs["eval_loss"] = self.evaluate()
                self.metrics.log(self.interval, **logs)
        finally:
            if loader is not None:
                loader.close()
        return self

    def close(self):
        """Close the metric sink."""
        self.metrics.close()


__all__ = ["ScaleTrainer", "TrainerConfig"]
