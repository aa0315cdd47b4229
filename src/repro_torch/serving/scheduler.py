"""Batched request schedulers over the model zoo's prefill/decode steps —
the port of ``repro/serving/scheduler.py``, with the same step clock,
stats and admission rules:

* :class:`BatchScheduler` — wave batching. Up to ``slots`` requests are
  packed into one fixed-shape batch, prefilled jointly, and decoded
  together; the next wave is admitted only when the batch drains.

* :class:`ContinuousScheduler` — continuous batching over one ring
  cache: a freed slot is re-prefilled (a batch-1 prefill written into
  the live cache along the batch axis) while the other slots decode.

* :class:`PagedContinuousScheduler` — continuous batching over the
  paged cache, with prefix sharing and chunked prefill; every decode
  step runs the ``paged_decode`` kernel once per layer on the card. The
  ssm kind has no pages: its per-slot state carries across chunks.

``ssd_kernel`` (every scheduler): the ssm kind's prefill scans that
start from a zero state go through the ``ssd_scan`` kernel (True), the
plain ``ssd_chunked`` (False), or — the default, None — the kernel on a
CUDA device and the plain version on the CPU.

Prompts are right-padded to ``max_prompt`` with per-request lengths, so
padded prefixes never enter attention. The schedulers run on ``device``
(default: the CUDA device; no card and no explicit device raises), hold
the disabled observability sink ``NULL_OBS``, and copy one tensor from
the device per decode tick: the sampled tokens, which the host needs to
emit and retire requests. Temperature sampling draws from a
``torch.Generator`` seeded with ``seed`` (JAX's streams cannot be
reproduced), so parity with the reference holds at temperature 0.
A ``Request`` carries tokens only, so every scheduler refuses the vlm,
encdec and audio kinds, as the reference's do (their frontends'
patches and frames have no place in it); they are served in the serve
CLI's direct mode.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Optional

import numpy as np
import torch

from repro_torch.kernels.runtime import DeviceLike, resolve_device
from repro_torch.models.transformer import FRONTEND_KINDS
from repro_torch.obs.sink import NULL_OBS
from repro_torch.serving.pages import (
    DUMMY_PAGE, PageTable, PrefixTrie, pages_per_slot)
from repro_torch.serving.sampling import sample_tokens

if TYPE_CHECKING:  # annotation-only: keeps repro_torch.serving cycle-free
    from repro_torch.models import ModelApi


@dataclass
class Request:
    rid: int
    prompt: np.ndarray              # (T,) int32
    max_new: int = 16
    out_tokens: list = field(default_factory=list)
    done: bool = False
    budget: int = 0                 # set at admission
    # lifecycle stamps in scheduler-step clock ticks; -1 = never happened
    # (e.g. first_token of a zero-budget request)
    submit_clock: int = -1
    admit_clock: int = -1
    first_token_clock: int = -1
    retire_clock: int = -1
    # paged-scheduler provenance: how the prompt entered the cache —
    # #prefill chunks run, #pages borrowed from the trie
    prefill_chunks: int = 0
    prefix_pages_reused: int = 0


@dataclass
class RequestRecord:
    """One retired request's latency breakdown, in step-clock ticks."""
    rid: int
    submit: int
    admit: int
    first_token: int
    retire: int
    decode: int                     # tokens generated
    budget: int
    prefill_chunks: int = 0
    prefix_pages_reused: int = 0

    @property
    def queue_latency(self) -> int:
        return self.admit - self.submit if self.admit >= 0 else -1

    @property
    def ttft(self) -> int:
        return (self.first_token - self.submit
                if self.first_token >= 0 else -1)

    @property
    def prefill_latency(self) -> int:
        """Ticks between admission and the first sampled token — the
        chunked-prefill share of TTFT (TTFT = queue_latency + this)."""
        return (self.first_token - self.admit
                if self.first_token >= 0 and self.admit >= 0 else -1)


@dataclass
class SchedulerStats:
    prefills: int = 0
    decode_steps: int = 0
    tokens_generated: int = 0
    requests_done: int = 0
    slot_steps: int = 0             # slots * decode_steps
    live_slot_steps: int = 0        # slots actually generating
    # one RequestRecord per retired request, in retirement order
    records: list = field(default_factory=list)

    @property
    def utilization(self) -> float:
        return self.live_slot_steps / max(self.slot_steps, 1)


class _SchedulerBase:
    """Shared request plumbing: queue, slots, padding, sampling."""

    def __init__(self, model: ModelApi, *, slots: int = 4,
                 max_prompt: int = 64, max_total: int = 128,
                 temperature: float = 0.0, seed: int = 0,
                 cache_dtype=torch.float32, obs=NULL_OBS,
                 device: DeviceLike = None,
                 ssd_kernel: Optional[bool] = None):
        if max_prompt > max_total:
            raise ValueError(f"max_prompt {max_prompt} exceeds max_total "
                             f"{max_total}")
        if model.cfg.kind in FRONTEND_KINDS:
            raise ValueError(
                f"{type(self).__name__} serves token-only requests; "
                f"arch kind {model.cfg.kind!r} needs frontend inputs "
                "(patches/frames) that Request does not carry")
        self.model = model
        self.device = resolve_device(device)
        self.slots = slots
        self.max_prompt = max_prompt
        self.max_total = max_total
        self.temperature = temperature
        self.cache_dtype = cache_dtype
        if ssd_kernel is None:
            ssd_kernel = self.device.type == "cuda"
        self.ssd_kernel = ssd_kernel
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.queue: list[Request] = []
        self.active: list[Optional[Request]] = [None] * slots
        self.stats = SchedulerStats()
        self.obs = obs
        # the step clock: one tick per step() call (admission attempts
        # and decode steps alike) — all Request stamps use this clock
        self.clock = 0

    def _tensor(self, array, dtype=torch.int32) -> torch.Tensor:
        """A host array on the scheduler's device."""
        return torch.as_tensor(np.asarray(array), dtype=dtype,
                               device=self.device)

    def submit(self, req: Request) -> None:
        if not 1 <= len(req.prompt) <= self.max_prompt:
            raise ValueError(f"prompt of {len(req.prompt)} tokens; the "
                             f"scheduler takes 1..{self.max_prompt}")
        if req.submit_clock < 0:
            req.submit_clock = self.clock
        self.queue.append(req)

    @property
    def outstanding(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self.active)

    def _budget(self, req: Request) -> int:
        # the cache holds prompt + generated tokens: never decode past it
        return min(req.max_new, self.max_total - len(req.prompt))

    def _retire(self, req: Request) -> None:
        """Mark done, stamp the clock, append the latency record."""
        req.done = True
        req.retire_clock = self.clock
        self.stats.requests_done += 1
        self.stats.records.append(RequestRecord(
            rid=req.rid, submit=req.submit_clock, admit=req.admit_clock,
            first_token=req.first_token_clock, retire=req.retire_clock,
            decode=len(req.out_tokens), budget=req.budget,
            prefill_chunks=req.prefill_chunks,
            prefix_pages_reused=req.prefix_pages_reused))

    # -- slot lifecycle hooks (overridden by the paged scheduler) -------
    def _slot_ready(self, i: int) -> bool:
        """Is slot ``i`` producing valid logits? (Paged slots are not
        ready while their chunked prefill is still streaming in.)"""
        return True

    def _free_slot(self, i: int) -> None:
        """Release slot ``i``'s resources after retirement."""
        self.active[i] = None

    def _work_pending(self) -> bool:
        """Non-queue work in flight (e.g. unfinished chunked prefills)
        that must keep ``run`` stepping even when no tokens came out."""
        return False

    def _take_next(self) -> Optional[Request]:
        """Pop the next admissible request; zero-budget requests (prompt
        already fills the cache) complete immediately with no tokens."""
        while self.queue:
            req = self.queue.pop(0)
            req.budget = self._budget(req)
            req.admit_clock = self.clock
            if req.budget > 0:
                return req
            self._retire(req)
        return None

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        return sample_tokens(
            logits, temperature=self.temperature,
            generator=self.generator if self.temperature > 0 else None)

    def _emit(self, tok_np: np.ndarray) -> int:
        """Append sampled tokens to live requests; retire exhausted ones."""
        emitted = 0
        for i, r in enumerate(self.active):
            if r is None or r.done or not self._slot_ready(i):
                continue
            r.out_tokens.append(int(tok_np[i]))
            if r.first_token_clock < 0:
                r.first_token_clock = self.clock
            emitted += 1
            if len(r.out_tokens) >= r.budget:
                self._retire(r)
                self._free_slot(i)
        self.stats.tokens_generated += emitted
        return emitted

    def _decode_tick(self, params) -> int:
        """Sample from the held logits, emit/retire, then decode the
        batch one step (skipped when every lane just retired — the
        final tokens need no decode)."""
        tok = self._sample(self._last_logits)
        # the tick's one device-to-host copy: the host emits and retires
        emitted = self._emit(tok[:, 0].cpu().numpy())
        if not any(r is not None for r in self.active):
            return emitted
        with self.obs.span("decode_step", step=self.clock):
            self._last_logits, self._cache = self._decode(
                params, tok, self._cache, self._pos)
        self._pos = self._pos + 1
        self.stats.decode_steps += 1
        self.stats.slot_steps += self.slots
        self.stats.live_slot_steps += sum(
            r is not None and self._slot_ready(i)
            for i, r in enumerate(self.active))
        return emitted

    def _tick(self) -> None:
        """Advance the step clock + record the slot/queue gauges."""
        self.clock += 1
        if self.obs.enabled:
            self.obs.counter(
                "scheduler",
                live_slots=sum(r is not None for r in self.active),
                queue_depth=len(self.queue),
                tokens=self.stats.tokens_generated)

    def run(self, params, max_steps: int = 1000) -> SchedulerStats:
        steps = 0
        with self.obs.span("run", scheduler=type(self).__name__,
                           slots=self.slots):
            while self.outstanding and steps < max_steps:
                if self.step(params) == 0 and not self.queue \
                        and not self._work_pending():
                    break
                steps += 1
        if self.outstanding:
            warnings.warn(
                f"{type(self).__name__}.run hit max_steps={max_steps} "
                "with requests still outstanding — results are "
                "truncated; raise max_steps", RuntimeWarning,
                stacklevel=2)
        return self.stats


class BatchScheduler(_SchedulerBase):
    """Slot-based wave batching (static shapes, per-slot pos)."""

    def __init__(self, model: ModelApi, **kw):
        super().__init__(model, **kw)
        self._cache = None
        self._pos = None            # (slots,) per-slot absolute position
        self._last_logits = None

    def _decode(self, params, tok, cache, pos):
        return self.model.decode_step(params, tok, cache, pos,
                                      dtype=torch.float32)

    def _admit(self, params) -> bool:
        """Fill free slots from the queue and prefill the wave jointly.

        Prompts are RIGHT-padded to ``max_prompt`` with per-request
        ``lengths`` so padded tails never enter attention or the cache."""
        free = [i for i, r in enumerate(self.active) if r is None]
        if not free or not self.queue:
            return False
        for i in free:
            req = self._take_next()
            if req is None:
                break
            self.active[i] = req
        if not any(r is not None for r in self.active):
            return False
        toks = np.zeros((self.slots, self.max_prompt), np.int32)
        lens = np.zeros((self.slots,), np.int32)
        for i, r in enumerate(self.active):
            if r is not None:
                toks[i, : len(r.prompt)] = r.prompt
                lens[i] = len(r.prompt)
        with self.obs.span("prefill", wave=self.stats.prefills,
                           requests=int((lens > 0).sum())):
            logits, cache, pos = self.model.prefill(
                params, {"tokens": self._tensor(toks)}, dtype=torch.float32,
                cache_dtype=self.cache_dtype, cache_len=self.max_total,
                lengths=self._tensor(lens), use_kernel=self.ssd_kernel)
        self._cache = cache
        self._pos = pos             # (slots,) = per-request prompt length
        self._last_logits = logits
        self.stats.prefills += 1
        return True

    def step(self, params) -> int:
        """One decode step for all live slots; returns #tokens emitted."""
        self._tick()
        if self._cache is None:
            with self.obs.span("admission", step=self.clock):
                admitted = self._admit(params)
            if not admitted:
                return 0
        emitted = self._decode_tick(params)
        if not any(r is not None for r in self.active):
            self._cache = None  # drained -> allow the next admission wave
        return emitted


class ContinuousScheduler(_SchedulerBase):
    """Per-slot admission/retirement without draining the batch.

    The ring cache for all ``slots`` lanes is allocated once; a freed
    slot is refilled by a batch-1 prefill copied in along the batch
    axis, in place."""

    def __init__(self, model: ModelApi, **kw):
        super().__init__(model, **kw)
        self._cache = model.init_cache(self.slots, self.max_total,
                                       self.cache_dtype, device=self.device)
        self._pos = torch.zeros((self.slots,), dtype=torch.int32,
                                device=self.device)
        self._last_logits = torch.zeros(
            (self.slots, 1, model.cfg.padded_vocab), dtype=torch.float32,
            device=self.device)

    def _decode(self, params, tok, cache, pos):
        return self.model.decode_step(params, tok, cache, pos,
                                      dtype=torch.float32)

    def _admit(self, params) -> int:
        """Prefill queued requests into every free slot; others keep
        their cache/pos untouched."""
        admitted = 0
        for i, r in enumerate(self.active):
            if r is not None or not self.queue:
                continue
            req = self._take_next()
            if req is None:
                break
            self.active[i] = req
            toks = np.zeros((1, self.max_prompt), np.int32)
            toks[0, : len(req.prompt)] = req.prompt
            with self.obs.span("prefill", slot=i, rid=req.rid):
                lg1, c1, p1 = self.model.prefill(
                    params, {"tokens": self._tensor(toks)},
                    dtype=torch.float32, cache_dtype=self.cache_dtype,
                    cache_len=self.max_total,
                    lengths=self._tensor([len(req.prompt)]),
                    use_kernel=self.ssd_kernel)
                self.model.write_cache_slot(self._cache, c1, i,
                                            pos=self._pos, one_pos=p1[0])
                self._last_logits[i:i + 1] = lg1
            self.stats.prefills += 1
            admitted += 1
        return admitted

    def step(self, params) -> int:
        """Admit into free slots, then one decode step for the batch."""
        self._tick()
        with self.obs.span("admission", step=self.clock):
            self._admit(params)
        if not any(r is not None for r in self.active):
            return 0
        return self._decode_tick(params)


class PagedContinuousScheduler(_SchedulerBase):
    """Continuous batching over the PAGED cache.

    Attention K/V live in a shared refcounted page pool instead of one
    ``(slots, max_total)`` ring per lane:

    * **Admission** allocates ``ceil((plen + budget) / page_size)``
      pages up front (minus any shared prefix) — when the free list is
      short the head request DEFERS in the queue instead of failing.
    * **Prefix sharing**: prompts are matched against the resident-prefix
      trie; matched full-page chunks are retained (refcount++) and the
      prefill starts after them. Pages are published to the trie at
      prefill *completion* and forgotten when their refcount hits zero.
    * **Chunked prefill**: prompts stream in ``prefill_chunk``-sized
      pieces (a page_size multiple), at most ``chunks_per_tick`` chunks
      per scheduler tick, interleaved with decode steps for the live
      lanes. A slot flips live only after its last chunk: until then its
      page-map row is all-dummy.

    ``paged_kernel``: decode attention through the ``paged_decode``
    kernel (True), through the plain gather (False), or — the default,
    None — the kernel on a CUDA device and the plain version on the CPU.
    """

    def __init__(self, model: ModelApi, *, page_size: int = 16,
                 cache_pages: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 chunks_per_tick: int = 1,
                 paged_kernel: Optional[bool] = None, **kw):
        super().__init__(model, **kw)
        self.page_size = page_size
        self.pages_slot = pages_per_slot(self.max_total, page_size)
        if cache_pages is None:
            # every slot can hold a full-length request (+1 for the dummy
            # page) — byte-parity with the ring layout
            cache_pages = self.slots * self.pages_slot + 1
        self.cache_pages = cache_pages
        if prefill_chunk is None:
            prefill_chunk = -(-self.max_prompt // page_size) * page_size
        if prefill_chunk <= 0 or prefill_chunk % page_size:
            raise ValueError("prefill_chunk must be a positive page_size "
                             f"multiple, got {prefill_chunk}")
        self.prefill_chunk_len = prefill_chunk
        self.chunks_per_tick = chunks_per_tick
        if paged_kernel is None:
            paged_kernel = self.device.type == "cuda"
        self.paged_kernel = paged_kernel
        # page pools only exist for attention-bearing kinds; the ssm kind
        # carries O(1) per-slot state and needs no pages
        self._has_pages = model.cfg.kind != "ssm"
        self._shareable = model.cfg.kind in ("dense", "moe")
        self.table = PageTable(cache_pages, page_size)
        self.trie = PrefixTrie(page_size)
        # memory-pressure / prefix-sharing counters
        self.page_deferrals = 0
        self.prefix_pages_hit = 0
        self.prefix_pages_possible = 0

        self._page_map = np.full((self.slots, self.pages_slot), DUMMY_PAGE,
                                 np.int32)
        self._live = np.zeros((self.slots,), bool)
        self._slot_pages: list[Optional[list]] = [None] * self.slots
        self._jobs: dict[int, dict] = {}

        self._cache = model.init_paged_cache(
            self.slots, cache_pages, page_size, self.cache_dtype,
            device=self.device)
        self._pos = torch.zeros((self.slots,), dtype=torch.int32,
                                device=self.device)
        self._last_logits = torch.zeros(
            (self.slots, 1, model.cfg.padded_vocab), dtype=torch.float32,
            device=self.device)

    # -- page planning --------------------------------------------------
    def _plan_pages(self, req: Request, budget: int):
        """(shared, fresh) page lists for a request, or None to defer.

        Commit is atomic: the trie match is only retained once the fresh
        allocation is known to fit, so a deferral leaves no refcounts
        behind."""
        if not self._has_pages:
            return [], []
        plen = len(req.prompt)
        total = -(-(plen + budget) // self.page_size)
        assert total <= self.pages_slot
        shared: list = []
        if self._shareable:
            # cap: at least one prompt token always prefills, so the
            # admission logits come from a real forward pass
            cap = min((plen - 1) // self.page_size, total)
            shared = self.trie.match(np.asarray(req.prompt), cap)
            self.prefix_pages_possible += cap
        need = total - len(shared)
        if self.table.num_free < need:
            return None
        if shared:
            self.table.retain(shared)
            self.prefix_pages_hit += len(shared)
        fresh = self.table.alloc(need)
        assert fresh is not None
        return shared, fresh

    @property
    def prefix_hit_rate(self) -> float:
        return self.prefix_pages_hit / max(self.prefix_pages_possible, 1)

    # -- slot lifecycle -------------------------------------------------
    def _slot_ready(self, i: int) -> bool:
        return bool(self._live[i])

    def _free_slot(self, i: int) -> None:
        pages = self._slot_pages[i]
        if pages:
            for pg in self.table.release(pages):
                self.trie.forget(pg)
        self._slot_pages[i] = None
        self._page_map[i] = DUMMY_PAGE
        self._live[i] = False
        self._jobs.pop(i, None)
        self.active[i] = None

    def _work_pending(self) -> bool:
        return bool(self._jobs)

    # -- admission / prefill --------------------------------------------
    def _admit(self) -> int:
        """Plan pages + enqueue a chunked-prefill job per free slot.
        Head-of-line deferral: if the head request's pages don't fit,
        admission stops until retirements refill the free list."""
        admitted = 0
        for i in range(self.slots):
            if self.active[i] is not None or not self.queue:
                continue
            req = self.queue[0]
            budget = self._budget(req)
            if budget <= 0:
                self.queue.pop(0)
                req.budget = budget
                req.admit_clock = self.clock
                self._retire(req)
                continue
            plan = self._plan_pages(req, budget)
            if plan is None:
                self.page_deferrals += 1
                break
            self.queue.pop(0)
            shared, fresh = plan
            req.budget = budget
            req.admit_clock = self.clock
            req.prefix_pages_reused = len(shared)
            self.active[i] = req
            pages = shared + fresh
            self._slot_pages[i] = pages
            self._jobs[i] = {
                "req": req, "pages": pages,
                "start": len(shared) * self.page_size,
                "plen": len(req.prompt)}
            admitted += 1
        return admitted

    def _advance_prefills(self, params) -> None:
        """Run up to ``chunks_per_tick`` prefill chunks per pending job;
        completed slots put their page row in the map and flip live."""
        C = self.prefill_chunk_len
        for slot in list(self._jobs):
            job = self._jobs[slot]
            req = job["req"]
            row = np.full((self.pages_slot,), DUMMY_PAGE, np.int32)
            row[: len(job["pages"])] = job["pages"]
            for _ in range(self.chunks_per_tick):
                start, plen = job["start"], job["plen"]
                valid = min(C, plen - start)
                toks = np.zeros((1, C), np.int32)
                toks[0, :valid] = req.prompt[start:start + valid]
                with self.obs.span("prefill_chunk", slot=slot,
                                   rid=req.rid, start=start):
                    _, lg = self.model.prefill_chunk(
                        params, self._cache, self._tensor(toks), start,
                        valid, row, slot, dtype=torch.float32,
                        use_kernel=self.ssd_kernel)
                    self._last_logits[slot:slot + 1] = lg
                req.prefill_chunks += 1
                job["start"] = start + valid
                if job["start"] >= plen:
                    self._page_map[slot] = row
                    self._live[slot] = True
                    self._pos[slot] = plen
                    if self._shareable:
                        self.trie.register(
                            np.asarray(req.prompt),
                            job["pages"][: plen // self.page_size])
                    self.stats.prefills += 1
                    del self._jobs[slot]
                    break

    # -- decode ---------------------------------------------------------
    def _decode(self, params, tok, cache, pos):
        return self.model.decode_step_paged(
            params, tok, cache, pos, self._tensor(self._page_map),
            self._tensor(self._live, torch.bool), dtype=torch.float32,
            use_kernel=self.paged_kernel)

    def _tick(self) -> None:
        super()._tick()
        if self.obs.enabled:
            self.obs.counter(
                "pages", free=self.table.num_free,
                occupancy=self.table.occupancy,
                prefix_hit_rate=self.prefix_hit_rate,
                deferrals=self.page_deferrals)

    def step(self, params) -> int:
        """Admit + advance chunked prefills, then one decode step for
        the live lanes; returns #tokens emitted."""
        self._tick()
        with self.obs.span("admission", step=self.clock):
            self._admit()
        self._advance_prefills(params)
        if not self._live.any():
            return 0
        return self._decode_tick(params)


SCHEDULERS = {"wave": BatchScheduler, "continuous": ContinuousScheduler,
              "paged": PagedContinuousScheduler}


def make_scheduler(kind: str, model: ModelApi, **kw):
    try:
        cls = SCHEDULERS[kind]
    except KeyError:
        raise ValueError(
            f"unknown scheduler {kind!r}; choose from {sorted(SCHEDULERS)}")
    return cls(model, **kw)


def run_trace(sched, params, arrivals, max_steps: int = 10_000):
    """Drive a scheduler through an arrival trace.

    arrivals: iterable of ``(arrive_step, Request)`` — each request is
    submitted once the driver's step counter reaches ``arrive_step``
    (steps advance even while the scheduler idles waiting for work).
    Returns the scheduler's stats.
    """
    pending = sorted(arrivals, key=lambda a: a[0])
    i = 0
    steps = 0
    with sched.obs.span("run", scheduler=type(sched).__name__,
                        driver="trace", requests=len(pending)):
        while (i < len(pending) or sched.outstanding) and \
                steps < max_steps:
            while i < len(pending) and pending[i][0] <= steps:
                sched.submit(pending[i][1])
                i += 1
            sched.step(params)
            steps += 1
    if i < len(pending) or sched.outstanding:
        warnings.warn(
            f"run_trace hit max_steps={max_steps} with requests still "
            "outstanding — results are truncated; raise max_steps",
            RuntimeWarning, stacklevel=2)
    return sched.stats


__all__ = ["BatchScheduler", "ContinuousScheduler",
           "PagedContinuousScheduler", "Request", "RequestRecord",
           "SCHEDULERS", "SchedulerStats", "make_scheduler", "run_trace"]
