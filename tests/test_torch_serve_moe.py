"""The moe kind (llama4-scout and llama4-maverick) through the port's
serving engines, schedulers and serve CLI, against the reference on the
CPU, with the reduced configs of ``tests/test_torch_moe.py`` (d 64, 4
experts, vocabulary 128; scout 2 layers, maverick 5: two ``{dense_0,
moe}`` groups and a dropped remainder) and the reference's weights.

The engines run at the config's own capacity factor 1.25, where the
capacity binds: a prefill with ``lengths`` and a paged chunk route each
row as its own group with its pads masked out, and a decode routes every
slot of the batch as one group. The reference does the same, so it is
the oracle there. The schedulers and the CLIs run at 8.0, as the
reference's serving tests do (``tests/test_serving*.py``), since a
binding capacity makes a request's tokens depend on its batch; one paged
trace runs at 1.25, where a decode step's group takes in the idle
slots, whose tokens read the dummy page: its duplicate writes keep the
last row, as the reference's scatter does.

Tolerances: logits and cache leaves within 1e-5 (float32 on both sides,
products summed in another order), greedy tokens, scheduler stats,
records and page counters exactly; a row of a batched prefill against
the same padded row alone within 1e-5.
"""
import _torch_threads  # noqa: F401  (torch threads per xdist worker)
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.launch import serve as j_serve_cli
from repro.models import attention as j_attn
from repro.models import build_model as j_build_model
from repro.serving import (
    BatchScheduler as JBatch, ContinuousScheduler as JContinuous,
    PagedContinuousScheduler as JPaged, Request as JRequest,
    engine as j_engine, run_trace as j_run_trace,
)

from repro_torch.launch import serve as serve_cli
from repro_torch.models import attention, build_model, params_from_jax
from repro_torch.models.common import tree_items
from repro_torch.serving import (
    BatchScheduler, ContinuousScheduler, PagedContinuousScheduler, Request,
    decode_step, prefill, run_trace, write_cache_slot,
)

from test_torch_hybrid import _J, _paged_runs
from test_torch_moe import MAVERICK, SCOUT, _cfgs
from test_torch_serving import (
    RECORD_FIELDS, STAT_FIELDS, _assert_cli_counts_match,
    _assert_logits_and_tokens, _settled, _trace)

ATOL = 1e-5


@functools.lru_cache(maxsize=None)
def _tiny(arch, cf=1.25):
    """(port cfg, reference cfg, port params, reference params)."""
    cfg, jcfg = _cfgs(arch, moe_capacity_factor=cf)
    jp = jax.jit(j_build_model(jcfg).init)(jax.random.PRNGKey(0))
    return cfg, jcfg, params_from_jax(jax.tree.map(np.asarray, jp),
                                      "cpu"), jp


def _prompt(cfg, seed, n):
    return np.random.default_rng(seed).integers(
        1, cfg.vocab_size, size=n).astype(np.int32)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=0)


# ------------------------------------------------------ the ring engine

@pytest.mark.parametrize("arch", [SCOUT, MAVERICK])
def test_ring_prefill_decode_and_slot_write_match_reference(arch):
    """A right-padded prefill of prompts of 12, 5 and 9 tokens with
    ``lengths`` (per-row routing, the pads masked out), 4 decode steps
    (the 3 slots one routing group), and write_cache_slot of a batch-1
    prefill: logits and every cache leaf, in the reference's leaf order
    (``layers``, or ``groups`` of ``{dense_0, moe}``)."""
    cfg, jcfg, p, jp = _tiny(arch)
    B, T, steps, total = 3, 12, 4, 20
    rng = np.random.default_rng(4)
    toks = rng.integers(1, cfg.vocab_size, size=(B, T)).astype(np.int32)
    lens = np.asarray([12, 5, 9], np.int32)
    feed = rng.integers(1, cfg.vocab_size, size=(steps, B, 1)).astype(
        np.int32)
    kw = dict(dtype=jnp.float32, cache_dtype=jnp.float32, cache_len=total)
    tkw = dict(dtype=torch.float32, cache_dtype=torch.float32,
               cache_len=total)
    jl, jc, jpos = _J["prefill"](jp, jcfg, {"tokens": jnp.asarray(toks)},
                                 lengths=jnp.asarray(lens), **kw)
    tl, tc, tpos = prefill(p, cfg, {"tokens": torch.from_numpy(toks)},
                           lengths=torch.from_numpy(lens), **tkw)
    assert sorted(tc) == (["layers"] if arch == SCOUT else ["groups"])
    _close(tl, jl)
    for i in range(steps):
        jl, jc = _J["decode_step"](jp, jcfg, jnp.asarray(feed[i]), jc,
                                   jpos, dtype=jnp.float32)
        tl, tc = decode_step(p, cfg, torch.from_numpy(feed[i]), tc, tpos,
                             dtype=torch.float32)
        _close(tl, jl)
        jpos, tpos = jpos + 1, tpos + 1
    one = np.zeros((1, T), np.int32)
    one[0, :7] = _prompt(cfg, 5, 7)
    _, jc1, jp1 = _J["prefill"](jp, jcfg, {"tokens": jnp.asarray(one)},
                                lengths=jnp.asarray([7]), **kw)
    _, tc1, tp1 = prefill(p, cfg, {"tokens": torch.from_numpy(one)},
                          lengths=torch.tensor([7]), **tkw)
    jc, jpos = j_engine.write_cache_slot(jcfg, jc, jc1, 1, pos=jpos,
                                         one_pos=jp1[0])
    tc, tpos = write_cache_slot(cfg, tc, tc1, 1, pos=tpos, one_pos=tp1[0])
    leaves = tree_items(tc)
    assert [k for k, _ in leaves] == \
        [tuple(getattr(e, "key", e) for e in path) for path, _ in
         jax.tree_util.tree_flatten_with_path(jc)[0]]
    for (_, got), want in zip(leaves, jax.tree.leaves(jc)):
        _close(got, want)
    jl, _ = _J["decode_step"](jp, jcfg, jnp.asarray(feed[0]), jc, jpos,
                              dtype=jnp.float32)
    tl, _ = decode_step(p, cfg, torch.from_numpy(feed[0]), tc, tpos,
                        dtype=torch.float32)
    _close(tl, jl)


def test_prefill_rows_route_as_they_would_alone():
    """At the default capacity factor, each row of a mixed-length prefill
    gives the logits of the same right-padded prompt prefilled alone
    (what the continuous scheduler's admission runs): the pads take no
    expert capacity and the rows share none."""
    cfg, _, p, _ = _tiny(SCOUT)
    lens = [5, 11, 16]
    toks = np.zeros((3, 16), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = _prompt(cfg, 10 + i, n)
    kw = dict(dtype=torch.float32, cache_dtype=torch.float32, cache_len=24)
    lg, _, _ = prefill(p, cfg, {"tokens": torch.from_numpy(toks)},
                       lengths=torch.tensor(lens), **kw)
    for i, n in enumerate(lens):
        lg1, _, _ = prefill(p, cfg, {"tokens": torch.from_numpy(
            toks[i:i + 1])}, lengths=torch.tensor([n]), **kw)
        _close(lg[i], lg1[0].numpy())


# ----------------------------------------------------- the paged engine

@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("arch", [SCOUT, MAVERICK])
def test_paged_prefill_and_decode_match_reference(arch, use_kernel):
    """prefill_chunk in chunks of 8 over an 11-token prompt (the second
    chunk's 5 pad rows masked out of the routing) and 6 teacher-forced
    decode_step_paged steps (through the plain gather, or the
    ``paged_decode`` wrapper, its plain version on the CPU): logits,
    tokens and the final page pools."""
    cfg, jcfg, p, jp = _tiny(arch)
    got, ref, cache, jcache = _paged_runs(
        cfg, jcfg, p, jp, _prompt(cfg, 0, 11), _prompt(cfg, 1, 6).tolist(),
        ps=4, chunk=8, use_kernel=use_kernel)
    _assert_logits_and_tokens(got, ref)
    for (_, a), b in zip(tree_items(cache), jax.tree.leaves(jcache)):
        _close(a, b)


def test_paged_scatter_duplicates_keep_the_last_row_as_the_reference():
    """Rows that share a page offset (pad rows and idle slots write into
    the dummy page) leave the last row's values, as the reference's
    scatter does: a slot that is not live reads page 0, and its token
    takes expert capacity in a decode step's routing group."""
    rng = np.random.default_rng(3)
    pools = {k: rng.normal(size=(3, 4, 2, 8)).astype(np.float32)
             for k in ("k", "v")}
    new = {k: rng.normal(size=(64, 2, 8)).astype(np.float32)
           for k in ("k", "v")}
    flat = rng.integers(0, 6, size=64)
    want = j_attn._paged_scatter(
        {k: jnp.asarray(v) for k, v in pools.items()}, jnp.asarray(
            new["k"]), jnp.asarray(new["v"]), jnp.asarray(flat))
    got = {k: torch.from_numpy(v.copy()) for k, v in pools.items()}
    tflat = torch.from_numpy(flat)
    attention._paged_scatter(got, torch.from_numpy(new["k"]),
                             torch.from_numpy(new["v"]), tflat,
                             attention.last_writers(tflat))
    for name, w in zip(("k", "v"), want):
        assert np.array_equal(got[name].numpy(), np.asarray(w))


# ---------------------------------------------------------- schedulers

# name -> (port class, reference class, extra kwargs, trace seed,
#          requests, template, paged counters that must be positive, arch)
SCHED_CASES = {
    "paged": (PagedContinuousScheduler, JPaged,
              dict(page_size=4, prefill_chunk=8), 7, 6, 0, (), SCOUT),
    "paged-prefix": (PagedContinuousScheduler, JPaged,
                     dict(page_size=4, cache_pages=9), 11, 8, 8,
                     ("prefix_pages_hit",), SCOUT),
    "continuous": (ContinuousScheduler, JContinuous, {}, 7, 6, 0, (), SCOUT),
    "wave": (BatchScheduler, JBatch, {}, 7, 6, 0, (), SCOUT),
    # the config's capacity factor: each decode step's routing group (the
    # 2 slots, live or not) at capacity 1, an idle slot's token reading
    # the dummy page
    "paged-cf1.25": (PagedContinuousScheduler, JPaged,
                     dict(page_size=4, prefill_chunk=8), 7, 6, 0, (), SCOUT),
    "maverick-paged": (PagedContinuousScheduler, JPaged,
                       dict(page_size=4, cache_pages=9, prefill_chunk=8),
                       11, 8, 8, ("prefix_pages_hit",), MAVERICK),
}


@pytest.mark.parametrize("case", sorted(SCHED_CASES))
def test_schedulers_match_reference(case):
    """The reference's traces at temperature 0 and capacity factor 8.0
    (and one at the config's 1.25): the same tokens for every request, the same stats and latency
    records, and for the paged scheduler the same deferrals, prefix hits
    (the moe kind shares prefix pages, as the dense kind does) and free
    pages."""
    cls, jcls, extra, seed, n_req, template, positive, arch = \
        SCHED_CASES[case]
    cfg, jcfg, p, jp = _tiny(arch, cf=1.25 if "cf1.25" in case else 8.0)
    kw = dict(slots=2, max_prompt=14, max_total=20, temperature=0.0,
              **extra)
    ref = _trace(jcfg, seed, n_req, JRequest, template)
    mine = _trace(cfg, seed, n_req, Request, template)
    jsched = _settled(jcls(j_build_model(jcfg), **kw))
    sched = cls(build_model(cfg), device="cpu", **kw)
    jstats = j_run_trace(jsched, jp, ref)
    stats = run_trace(sched, p, mine)
    assert stats.requests_done == n_req
    for (_, a), (_, b) in zip(ref, mine):
        assert b.out_tokens == a.out_tokens, f"rid {a.rid} diverged"
    for f in STAT_FIELDS:
        assert getattr(stats, f) == getattr(jstats, f), f
    assert [tuple(getattr(r, f) for f in RECORD_FIELDS)
            for r in stats.records] == \
        [tuple(getattr(r, f) for f in RECORD_FIELDS) for r in jstats.records]
    assert stats.prefills > sched.slots        # slots were re-admitted
    if cls is PagedContinuousScheduler:
        for f in ("page_deferrals", "prefix_pages_hit",
                  "prefix_pages_possible"):
            assert getattr(sched, f) == getattr(jsched, f), f
        assert sched.table.num_free == jsched.table.num_free \
            == sched.cache_pages - 1                      # no leaks
        assert all(getattr(sched, f) > 0 for f in positive), positive


# ------------------------------------------------------------- the CLI

@pytest.mark.parametrize("arch,scheduler", [
    (SCOUT, "paged"), (SCOUT, "continuous"), (SCOUT, "wave"),
    (MAVERICK, "paged")])
def test_serve_cli_prints_the_reference_counts(arch, scheduler, capsys):
    """``--arch <llama4> --reduced`` (the reduced default: 2 layers, d
    256, 4 experts, capacity factor 1.25): the same trace through both
    CLIs, the same done, prefills, decode steps and tokens, and the
    paged scheduler's page line (prefix sharing on a shared template)."""
    _assert_cli_counts_match(
        ["--arch", arch, "--reduced", "--scheduler", scheduler,
         "--temperature", "0", "--prefill-chunk", "32", "--requests", "6",
         "--prompt-len", "48", "--gen", "6", "--prefix-template", "16"],
        scheduler, capsys)


def test_direct_serve_cli_tokens_match_the_reference_engine(monkeypatch,
                                                            capsys):
    """``--scheduler direct`` on the reduced scout with the reference's
    weights, at its capacity factor 1.25 (the aligned batch one routing
    group in the prefill and in each decode): the CLI's greedy tokens
    equal the reference engine's prefill and decode of the CLI's own
    prompts; the summary's first line equals the reference CLI's."""
    argv = ["--arch", SCOUT, "--reduced", "--batch", "2", "--prompt-len",
            "24", "--gen", "6", "--temperature", "0"]
    assert j_serve_cli.main(argv) == 0
    ref_lines = capsys.readouterr().out.splitlines()
    jcfg = j_get_arch(SCOUT).reduced()
    jp = j_build_model(jcfg).init(jax.random.PRNGKey(0))
    monkeypatch.setattr(serve_cli, "init_params", lambda *a: params_from_jax(
        jax.tree.map(np.asarray, jp), "cpu"))
    assert serve_cli.main(argv + ["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == ref_lines[0]
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size,
                                             size=(2, 24))
    logits, cache, pos = _J["prefill"](
        jp, jcfg, {"tokens": jnp.asarray(toks, jnp.int32)},
        dtype=jnp.float32, cache_dtype=jnp.float32, cache_len=30)
    want = []
    for _ in range(6):
        tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
        want.append(int(tok[0, 0]))
        logits, cache = _J["decode_step"](jp, jcfg, tok, cache, pos,
                                          dtype=jnp.float32)
        pos = pos + 1
    assert lines[-1] == f"sampled token ids (first row): {want}"
