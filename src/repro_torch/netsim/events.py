"""Seeded, deterministic network-event streams (DESIGN.md §8).

An :class:`EventStream` turns a :class:`~repro_torch.configs.base.
DynamicsConfig` into a sequence of :class:`NetworkEvent` records indexed
by the training iteration ``t``:

* **link state** — every BASE D2D edge carries an independent 2-state
  Markov chain (up/down) advanced once per iteration;
* **device availability** — every device carries a churn Markov chain
  (up/down), composed with the deterministic flash-crowd window;
* **straggler delay** — a fixed straggler subset (drawn once at
  construction) receives a fresh ``1 + LogNormal(mu, sigma)`` delay
  multiplier each iteration; everyone else is 1.0.

Determinism: the stream owns a single ``numpy`` generator seeded from
``cfg.seed``, and events are generated strictly in ``t`` order and
cached — ``at(t)`` is a pure function of ``(cfg, topology shape, t)``
no matter how callers interleave their queries. The stream never
touches JAX PRNG keys, so enabling dynamics cannot perturb the
trainers' existing sampling streams.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.configs.base import DynamicsConfig


@dataclass(frozen=True)
class NetworkEvent:
    """The network's state at one iteration.

    ``link_up``: (N, s, s) bool, symmetric — Markov state of the base
    edges (True everywhere a static network would be).
    ``device_up``: (N, s) bool — churn AND flash-crowd availability.
    ``delay_mult``: (N, s) float >= 1 — straggler tail multiplier on
    any communication this device takes part in at this iteration.
    """
    t: int
    link_up: np.ndarray
    device_up: np.ndarray
    delay_mult: np.ndarray

    @property
    def all_up(self) -> bool:
        return bool(self.link_up.all() and self.device_up.all())


class EventStream:
    """Deterministic per-iteration event source for one topology.

    ``base_adj``: (N, s, s) bool — only base edges carry link chains.
    ``at(t)`` serves any ``t >= 0`` (t=0 is the all-up initial state);
    events are cached, so repeated/interleaved queries are cheap and
    reproducible.
    """

    def __init__(self, cfg: DynamicsConfig, base_adj: np.ndarray):
        self.cfg = cfg
        self.base_adj = np.asarray(base_adj, bool)
        self.N, self.s, _ = self.base_adj.shape
        self._rng = np.random.default_rng(cfg.seed)
        # straggler membership is a device trait, not an event: draw once
        n_stragglers = int(round(cfg.straggler_frac * self.N * self.s))
        flat = self._rng.permutation(self.N * self.s)[:n_stragglers]
        self.straggler_mask = np.zeros((self.N, self.s), bool)
        self.straggler_mask.reshape(-1)[flat] = True
        # flash-crowd membership: the same deterministic subset each window
        n_flash = int(round(cfg.flash_drop_frac * self.N * self.s))
        flat = self._rng.permutation(self.N * self.s)[:n_flash]
        self.flash_mask = np.zeros((self.N, self.s), bool)
        self.flash_mask.reshape(-1)[flat] = True

        # the churn Markov chain's own state (flash overlay excluded)
        self._churn_up = np.ones((self.N, self.s), bool)
        self._events: list[NetworkEvent] = [NetworkEvent(
            t=0,
            link_up=np.ones_like(self.base_adj),
            device_up=self._device_up(0, self._churn_up),
            delay_mult=np.ones((self.N, self.s)),
        )]

    # ------------------------------------------------------------------
    def at(self, t: int) -> NetworkEvent:
        if t < 0:
            raise ValueError(f"event index must be >= 0, got {t}")
        while len(self._events) <= t:
            self._advance()
        return self._events[t]

    def _advance(self) -> None:
        cfg = self.cfg
        prev = self._events[-1]
        t = prev.t + 1
        rng = self._rng

        # --- link Markov chains (upper-triangle state, mirrored; anything
        # off the base graph reads as "up" so static streams stay all-True)
        link_up = prev.link_up.copy()
        if cfg.p_link_fail > 0.0:
            iu = np.triu(np.ones((self.s, self.s), bool), 1)[None]
            edges = self.base_adj & np.broadcast_to(iu, self.base_adj.shape)
            u = rng.random(self.base_adj.shape)
            stay_up = prev.link_up & edges & (u >= cfg.p_link_fail)
            come_up = ~prev.link_up & edges & (u < cfg.p_link_recover)
            ut = stay_up | come_up
            link_up = ut | ut.transpose(0, 2, 1) | ~self.base_adj

        # --- device churn Markov chains (flash overlay applied on top)
        if cfg.p_device_drop > 0.0:
            u = rng.random((self.N, self.s))
            drop = self._churn_up & (u < cfg.p_device_drop)
            ret = ~self._churn_up & (u < cfg.p_device_return)
            self._churn_up = self._churn_up & ~drop | ret
        device_up = self._device_up(t, self._churn_up)

        # --- straggler tail draws (fresh each iteration)
        delay_mult = np.ones((self.N, self.s))
        if self.straggler_mask.any():
            tail = rng.lognormal(cfg.straggler_mu, cfg.straggler_sigma,
                                 size=(self.N, self.s))
            delay_mult = np.where(self.straggler_mask, 1.0 + tail, 1.0)

        self._events.append(NetworkEvent(
            t=t, link_up=link_up, device_up=device_up,
            delay_mult=delay_mult))

    def _in_flash(self, t: int) -> bool:
        cfg = self.cfg
        return (cfg.flash_duration > 0
                and cfg.flash_at <= t < cfg.flash_at + cfg.flash_duration)

    def _device_up(self, t: int, churn_up: np.ndarray) -> np.ndarray:
        if self._in_flash(t):
            return churn_up & ~self.flash_mask
        return churn_up.copy()


__all__ = ["EventStream", "NetworkEvent"]
