"""The port's serving path against ``repro.serving`` on the CPU: the page
table, the ring and paged engines, the three schedulers and the serve
CLI, for the dense kinds and the ssm kind (mamba2-370m), on reduced
configs (2 layers, d 64, vocabulary 128, as
``tests/test_serving_paged.py``), with the reference's parameters
carried across by ``params_from_jax`` and inputs made with numpy. The
ssm kind's ``use_kernel`` takes the ``ssd_scan`` wrapper, which runs its
plain version on the CPU.

Tolerances, and why:
- logits within 1e-5 (the reference's paged-vs-ring tolerance; float32
  products summed in another order on the two sides), argmax tokens
  exactly;
- ``paged_decode_plain`` within 1e-5 of the Pallas kernel in interpret
  mode (the reference's kernel tolerance);
- scheduler tokens, trace stats and page counters exactly (at
  temperature 0 they follow from the logits and the host bookkeeping);
- a mixed-length prefill against solo prefills of the same model, the
  reference's 3e-4 (``tests/test_serving.py``).
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
from repro.kernels.paged_attn import paged_decode as j_paged_decode
from repro.launch import serve as j_serve_cli
from repro.models import build_model as j_build_model
from repro.serving import (
    BatchScheduler as JBatch, ContinuousScheduler as JContinuous,
    PagedContinuousScheduler as JPaged, PageTable as JPageTable,
    PrefixTrie as JPrefixTrie, Request as JRequest, engine as j_engine,
    run_trace as j_run_trace,
)

from repro_torch.configs import get_arch
from repro_torch.kernels.paged_decode import paged_decode, paged_decode_plain
from repro_torch.launch import serve as serve_cli
from repro_torch.models import build_model, params_from_jax
from repro_torch.serving import (
    BatchScheduler, ContinuousScheduler, PagedContinuousScheduler,
    PageTable, PrefixTrie, Request, decode_step, decode_step_paged,
    init_cache_tree, init_paged_cache_tree, pages_per_slot, prefill,
    prefill_chunk, run_trace, write_cache_slot,
)

ATOL = 1e-5

# name -> (arch, serve_window, config overrides)
FAMILIES = {
    "dense": ("qwen1.5-0.5b", 0, ()),
    "dense-window": ("qwen1.5-0.5b", 8, ()),
    "sliding": ("starcoder2-3b", 0, (("sliding_window", 8),)),
    "mqa": ("gemma-2b", 0, ()),
    "ssm": ("mamba2-370m", 0, ()),
}


@functools.lru_cache(maxsize=None)
def _tiny(arch, over=()):
    """(port cfg, reference cfg, port params, reference params)."""
    def make(get):
        cfg = get(arch).reduced(num_layers=2, d_model=64, d_ff=128,
                                vocab_size=128)
        return dataclasses.replace(cfg, **dict(over)) if over else cfg
    jcfg, cfg = make(j_get_arch), make(get_arch)
    jp = j_build_model(jcfg).init(jax.random.PRNGKey(0))
    return cfg, jcfg, params_from_jax(jax.tree.map(np.asarray, jp),
                                      "cpu"), jp


def _prompt(cfg, seed, n):
    return np.random.default_rng(seed).integers(
        1, cfg.vocab_size, size=n).astype(np.int32)


# ---------------------------------------------------------------- pages

def test_page_table_and_trie_follow_the_reference():
    """The same random sequence of operations on both copies gives the
    same results and state after every step."""
    rng = np.random.default_rng(3)
    ps = 4
    tables = (PageTable(12, ps), JPageTable(12, ps))
    tries = (PrefixTrie(ps), JPrefixTrie(ps))
    owned = []                      # page lists handed out, to release
    prompts = [rng.integers(1, 6, size=int(rng.integers(2, 14)))
               .astype(np.int32) for _ in range(6)]
    for _ in range(200):
        op = rng.integers(0, 5)
        if op == 0:
            n = int(rng.integers(0, 5))
            got = [t.alloc(n) for t in tables]
            assert got[0] == got[1]
            if got[0]:
                owned.append(got[0])
        elif op == 1 and owned:
            pages = owned.pop(int(rng.integers(0, len(owned))))
            freed = [t.release(pages) for t in tables]
            assert freed[0] == freed[1]
            for trie in tries:
                for pg in freed[0]:
                    trie.forget(pg)
        elif op == 2 and owned:
            pages = owned[int(rng.integers(0, len(owned)))]
            for t in tables:
                t.retain(pages)
            owned.append(list(pages))
        elif op == 3 and owned:
            prompt = prompts[int(rng.integers(0, len(prompts)))]
            pages = owned[int(rng.integers(0, len(owned)))]
            n = min(len(pages), len(prompt) // ps)
            assert (tries[0].register(prompt, pages[:n])
                    == tries[1].register(prompt, pages[:n]))
        elif op == 4:
            prompt = prompts[int(rng.integers(0, len(prompts)))]
            cap = (len(prompt) - 1) // ps
            assert tries[0].match(prompt, cap) == tries[1].match(prompt, cap)
        assert tables[0].num_free == tables[1].num_free
        assert tables[0].occupancy == tables[1].occupancy
        assert tables[0]._ref == tables[1]._ref
        assert tables[0]._free == tables[1]._free
        assert tries[0]._nodes == tries[1]._nodes
    assert pages_per_slot(17, 4) == 5


# ------------------------------------------------- paged engine parity

def _j_paged_run(cfg, jp, prompt, max_new, serve_window, *, ps, chunk,
                 feed):
    """The reference's paged prefill + decode; decode is fed ``feed``
    (teacher forcing). Returns the logits of every step."""
    plen = len(prompt)
    P = pages_per_slot(plen + max_new, ps)
    cache = j_engine.init_paged_cache_tree(cfg, 1, P + 1, ps, jnp.float32)
    row = jnp.arange(1, P + 1, dtype=jnp.int32)
    padded = np.zeros(-(-plen // chunk) * chunk, np.int32)
    padded[:plen] = prompt
    start = 0
    while start < plen:
        valid = min(chunk, plen - start)
        cache, logits = j_engine.prefill_chunk(
            jp, cfg, cache, jnp.asarray(padded[start:start + chunk])[None],
            start, valid, row, 0, dtype=jnp.float32,
            serve_window=serve_window)
        start += valid
    out = [np.asarray(logits[0, 0])]
    pos = jnp.asarray([plen], jnp.int32)
    for tok in feed:
        logits, cache = j_engine.decode_step_paged(
            jp, cfg, jnp.asarray([[tok]], jnp.int32), cache, pos, row[None],
            jnp.asarray([True]), dtype=jnp.float32,
            serve_window=serve_window)
        out.append(np.asarray(logits[0, 0]))
        pos = pos + 1
    return out


def _paged_run(cfg, p, prompt, max_new, serve_window, *, ps, chunk, feed,
               use_kernel=False):
    """The port's paged prefill + decode, the same steps as
    :func:`_j_paged_run`."""
    plen = len(prompt)
    P = pages_per_slot(plen + max_new, ps)
    cache = init_paged_cache_tree(cfg, 1, P + 1, ps, torch.float32,
                                  device="cpu")
    row = np.arange(1, P + 1, dtype=np.int32)
    padded = np.zeros(-(-plen // chunk) * chunk, np.int32)
    padded[:plen] = prompt
    start = 0
    while start < plen:
        valid = min(chunk, plen - start)
        cache, logits = prefill_chunk(
            p, cfg, cache, torch.from_numpy(padded[start:start + chunk])[None],
            start, valid, row, 0, dtype=torch.float32,
            serve_window=serve_window, use_kernel=use_kernel)
        start += valid
    out = [logits[0, 0].numpy()]
    pos = torch.tensor([plen], dtype=torch.int32)
    page_map = torch.from_numpy(row)[None]
    for tok in feed:
        logits, cache = decode_step_paged(
            p, cfg, torch.tensor([[tok]], dtype=torch.int32), cache, pos,
            page_map, torch.tensor([True]), dtype=torch.float32,
            serve_window=serve_window, use_kernel=use_kernel)
        out.append(logits[0, 0].numpy())
        pos = pos + 1
    return out


def _assert_logits_and_tokens(mine, ref):
    err = max(float(np.abs(a - b).max()) for a, b in zip(mine, ref))
    assert err <= ATOL, f"max |logits diff| {err}"
    assert [int(a.argmax()) for a in mine] == [int(b.argmax()) for b in ref]


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_paged_prefill_and_decode_match_reference(family, use_kernel):
    """prefill_chunk (two chunks) and decode_step_paged (through the
    plain gather, or the kernel's wrapper, which takes its plain version
    on the CPU), the sliding band past the window included; for the ssm
    kind the first chunk's scan through the ``ssd_scan`` wrapper and the
    second carrying the slot's state."""
    arch, sw, over = FAMILIES[family]
    cfg, jcfg, p, jp = _tiny(arch, over)
    prompt = _prompt(cfg, 0, 11)
    feed = _prompt(cfg, 1, 6).tolist()
    ref = _j_paged_run(jcfg, jp, prompt, 7, sw, ps=4, chunk=8, feed=feed)
    mine = _paged_run(cfg, p, prompt, 7, sw, ps=4, chunk=8, feed=feed,
                      use_kernel=use_kernel)
    _assert_logits_and_tokens(mine, ref)


def test_chunked_prefill_matches_one_shot():
    cfg, _, p, _ = _tiny("qwen1.5-0.5b")
    prompt = _prompt(cfg, 1, 13)
    feed = _prompt(cfg, 2, 3).tolist()
    one = _paged_run(cfg, p, prompt, 4, 0, ps=4, chunk=16, feed=feed)
    chunked = _paged_run(cfg, p, prompt, 4, 0, ps=4, chunk=4, feed=feed)
    _assert_logits_and_tokens(chunked, one)


def test_paged_decode_plain_matches_pallas_interpret():
    """The reference kernel's test shape (tests/test_serving_paged.py),
    plus an all-dummy row whose position is past its pages: with the
    window every key is masked and both take the uniform mean."""
    rng = np.random.default_rng(2)
    B, P, ps, K, G, hd = 4, 3, 4, 2, 2, 8
    q = rng.normal(size=(B, K, G, hd)).astype(np.float32)
    kp = rng.normal(size=(P + 1, ps, K, hd)).astype(np.float32)
    vp = rng.normal(size=(P + 1, ps, K, hd)).astype(np.float32)
    page_map = np.asarray([[1, 2, 3], [3, 1, 2], [0, 0, 0], [2, 3, 1]],
                          np.int32)
    pos = np.asarray([5, 9, 40, 11], np.int32)
    for window in (0, 4):
        ref = np.asarray(j_paged_decode(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(page_map), jnp.asarray(pos), window=window,
            interpret=True))
        args = [torch.from_numpy(a) for a in (q, kp, vp, page_map, pos)]
        plain = paged_decode_plain(*args, window=window).numpy()
        before = paged_decode.launches
        wrapped = paged_decode(*args, window=window).numpy()
        assert paged_decode.launches == before
        np.testing.assert_allclose(plain, ref, atol=ATOL, rtol=0)
        np.testing.assert_array_equal(wrapped, plain)


# --------------------------------------------------- ring engine parity

@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_ring_prefill_decode_and_slot_write_match_reference(family):
    """prefill with mixed lengths (right-padded), decode_step with
    per-slot positions past the ring's wrap for the windowed cases, and
    write_cache_slot of a batch-1 prefill: logits and caches (the ssm
    kind's state, the conv contexts and h, included)."""
    arch, sw, over = FAMILIES[family]
    cfg, jcfg, p, jp = _tiny(arch, over)
    B, T, steps, total = 3, 12, 5, 20
    rng = np.random.default_rng(4)
    toks = rng.integers(1, cfg.vocab_size, size=(B, T)).astype(np.int32)
    lens = np.asarray([12, 5, 9], np.int32)
    feed = rng.integers(1, cfg.vocab_size, size=(steps, B, 1)).astype(
        np.int32)

    jl, jc, jpos = j_engine.prefill(
        jp, jcfg, {"tokens": jnp.asarray(toks)}, dtype=jnp.float32,
        cache_dtype=jnp.float32, serve_window=sw, cache_len=total,
        lengths=jnp.asarray(lens))
    tl, tc, tpos = prefill(
        p, cfg, {"tokens": torch.from_numpy(toks)}, dtype=torch.float32,
        cache_dtype=torch.float32, serve_window=sw, cache_len=total,
        lengths=torch.from_numpy(lens))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    assert tpos.tolist() == np.asarray(jpos).tolist()
    for i in range(steps):
        jl, jc = j_engine.decode_step(jp, jcfg, jnp.asarray(feed[i]), jc,
                                      jpos, dtype=jnp.float32,
                                      serve_window=sw)
        tl, tc = decode_step(p, cfg, torch.from_numpy(feed[i]), tc, tpos,
                             dtype=torch.float32, serve_window=sw)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=0)
        jpos, tpos = jpos + 1, tpos + 1

    one = _prompt(cfg, 5, 7)
    one_pad = np.zeros((1, T), np.int32)
    one_pad[0, :7] = one
    _, jc1, jp1 = j_engine.prefill(
        jp, jcfg, {"tokens": jnp.asarray(one_pad)}, dtype=jnp.float32,
        cache_dtype=jnp.float32, serve_window=sw, cache_len=total,
        lengths=jnp.asarray([7]))
    _, tc1, tp1 = prefill(
        p, cfg, {"tokens": torch.from_numpy(one_pad)}, dtype=torch.float32,
        cache_dtype=torch.float32, serve_window=sw, cache_len=total,
        lengths=torch.tensor([7]))
    jc, jpos = j_engine.write_cache_slot(jcfg, jc, jc1, 1, pos=jpos,
                                         one_pos=jp1[0])
    tc, tpos = write_cache_slot(cfg, tc, tc1, 1, pos=tpos, one_pos=tp1[0])
    assert tpos.tolist() == np.asarray(jpos).tolist()
    for name in tc["layers"]:          # k, v; or the ssm state leaves
        np.testing.assert_allclose(tc["layers"][name].numpy(),
                                   np.asarray(jc["layers"][name]),
                                   atol=ATOL, rtol=0)
    jl, _ = j_engine.decode_step(jp, jcfg, jnp.asarray(feed[0]), jc, jpos,
                                 dtype=jnp.float32, serve_window=sw)
    tl, _ = decode_step(p, cfg, torch.from_numpy(feed[0]), tc, tpos,
                        dtype=torch.float32, serve_window=sw)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)


def test_ring_aligned_batch_matches_reference():
    """prefill without lengths (scalar pos) and a prompt longer than the
    sliding window (the ring's wrapped fill)."""
    cfg, jcfg, p, jp = _tiny("starcoder2-3b", (("sliding_window", 8),))
    toks = np.random.default_rng(6).integers(
        1, cfg.vocab_size, size=(2, 11)).astype(np.int32)
    jl, jc, jpos = j_engine.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                                    dtype=jnp.float32,
                                    cache_dtype=jnp.float32, cache_len=16)
    tl, tc, tpos = prefill(p, cfg, {"tokens": torch.from_numpy(toks)},
                           dtype=torch.float32, cache_dtype=torch.float32,
                           cache_len=16)
    assert tc["layers"]["k"].shape[2] == 8 and int(tpos) == int(jpos) == 11
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    tok = np.argmax(np.asarray(jl), -1).astype(np.int32)
    for _ in range(3):
        jl, jc = j_engine.decode_step(jp, jcfg, jnp.asarray(tok), jc, jpos,
                                      dtype=jnp.float32)
        tl, tc = decode_step(p, cfg, torch.from_numpy(tok), tc, tpos,
                             dtype=torch.float32)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=0)
        tok = np.argmax(np.asarray(jl), -1).astype(np.int32)
        jpos, tpos = jpos + 1, tpos + 1


# ------------------------------------------------- ssm kind (mamba2)

def _greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_ssm_prefill_lengths_matches_solo(use_kernel):
    """tests/test_serving.py's mixed-length case for mamba2-370m (its
    reduced default, d 256): a right-padded two-row prefill equals the
    reference's (logits, pos, 4 greedy decode steps) and each row's solo
    prefill and decode in the port."""
    cfg, jcfg = get_arch(MAMBA).reduced(), j_get_arch(MAMBA).reduced()
    jp = j_build_model(jcfg).init(jax.random.PRNGKey(0))
    p = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    lens = [5, 11]
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab_size - 1, size=n).astype(np.int32)
               for n in lens]
    toks = np.zeros((2, 16), np.int32)
    for i, pr in enumerate(prompts):
        toks[i, :len(pr)] = pr
    kw = dict(dtype=torch.float32, cache_dtype=torch.float32, cache_len=32)
    lg, cache, pos = prefill(p, cfg, {"tokens": torch.from_numpy(toks)},
                             lengths=torch.tensor(lens),
                             use_kernel=use_kernel, **kw)
    jlg, jcache, jpos = j_engine.prefill(
        jp, jcfg, {"tokens": jnp.asarray(toks)}, dtype=jnp.float32,
        cache_dtype=jnp.float32, cache_len=32, lengths=jnp.asarray(lens))
    assert pos.tolist() == lens == np.asarray(jpos).tolist()
    solo = [prefill(p, cfg, {"tokens": torch.from_numpy(pr[None])},
                    use_kernel=use_kernel, **kw) for pr in prompts]
    for step in range(5):
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=ATOL,
                                   rtol=0)
        for i, (lgs, _, _) in enumerate(solo):
            np.testing.assert_allclose(lg[i].numpy(), lgs[0].numpy(),
                                       atol=3e-4)
        if step == 4:
            break
        tb = _greedy(lg)
        assert tb[:, 0].tolist() == [int(_greedy(l)[0, 0]) for l, _, _ in solo]
        solo = [(*decode_step(p, cfg, _greedy(l), c, ps,
                              dtype=torch.float32), ps + 1)
                for l, c, ps in solo]
        jlg, jcache = j_engine.decode_step(jp, jcfg, jnp.asarray(tb.numpy()),
                                           jcache, jpos, dtype=jnp.float32)
        lg, cache = decode_step(p, cfg, tb, cache, pos, dtype=torch.float32)
        pos, jpos = pos + 1, jpos + 1


def test_ssm_write_cache_slot_roundtrip():
    """tests/test_serving.py's slot-write case for mamba2-370m: batch-1
    prefills written into a live cache are their solo caches row for row
    (the state and the conv contexts), equal the reference's, and decode
    like their solo continuations."""
    cfg, jcfg, p, jp = _tiny(MAMBA)
    rng = np.random.default_rng(2)
    cache = init_cache_tree(cfg, 2, 32, torch.float32, device="cpu")
    jcache = j_engine.init_cache_tree(jcfg, 2, 32, jnp.float32)
    pos = torch.zeros(2, dtype=torch.int32)
    jpos = jnp.zeros((2,), jnp.int32)
    solos = []
    for slot, n in enumerate((7, 10)):
        pr = rng.integers(1, cfg.vocab_size - 1, size=n).astype(np.int32)
        lg1, c1, p1 = prefill(p, cfg, {"tokens": torch.from_numpy(pr[None])},
                              dtype=torch.float32, cache_dtype=torch.float32,
                              cache_len=32)
        _, jc1, jp1 = j_engine.prefill(
            jp, jcfg, {"tokens": jnp.asarray(pr[None])}, dtype=jnp.float32,
            cache_dtype=jnp.float32, cache_len=32)
        cache, pos = write_cache_slot(cfg, cache, c1, slot, pos=pos,
                                      one_pos=p1)
        jcache, jpos = j_engine.write_cache_slot(jcfg, jcache, jc1, slot,
                                                 pos=jpos, one_pos=jp1)
        solos.append((lg1, c1, p1))
    assert pos.tolist() == [7, 10] == np.asarray(jpos).tolist()
    assert sorted(cache["layers"]) == ["conv_B", "conv_C", "conv_x", "h"]
    for name, leaf in cache["layers"].items():
        np.testing.assert_allclose(leaf.numpy(),
                                   np.asarray(jcache["layers"][name]),
                                   atol=ATOL, rtol=0)
        for slot, (_, c1, _) in enumerate(solos):
            assert torch.equal(leaf[:, slot], c1["layers"][name][:, 0])
    lgb = torch.cat([s[0] for s in solos])
    for _ in range(3):
        tb = _greedy(lgb)
        assert tb[:, 0].tolist() == [int(_greedy(l)[0, 0])
                                     for l, _, _ in solos]
        solos = [(*decode_step(p, cfg, _greedy(l), c, ps,
                               dtype=torch.float32), ps + 1)
                 for l, c, ps in solos]
        lgb, cache = decode_step(p, cfg, tb, cache, pos, dtype=torch.float32)
        pos = pos + 1
        for i, (l, _, _) in enumerate(solos):
            np.testing.assert_allclose(lgb[i].numpy(), l[0].numpy(),
                                       atol=ATOL, rtol=0)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_ssm_paged_decode_matches_ring(use_kernel):
    """tests/test_serving_paged.py's ssm family: chunked paged prefill
    (chunks of 4 across an 11-token prompt: the first from a zero state,
    the later ones from the carried state) and paged decode equal the
    ring prefill and decode, greedy tokens and logits."""
    cfg, _, p, _ = _tiny(MAMBA)
    prompt = _prompt(cfg, 0, 11)
    lg, cache, pos = prefill(p, cfg, {"tokens": torch.from_numpy(
        prompt[None])}, dtype=torch.float32, cache_dtype=torch.float32,
        cache_len=16, use_kernel=use_kernel)
    ring = [lg[0, 0].numpy()]
    tok = _greedy(lg)
    feed = []
    for _ in range(4):
        feed.append(int(tok[0, 0]))
        lg, cache = decode_step(p, cfg, tok, cache, pos, dtype=torch.float32)
        ring.append(lg[0, 0].numpy())
        tok, pos = _greedy(lg), pos + 1
    paged = _paged_run(cfg, p, prompt, 5, 0, ps=4, chunk=4, feed=feed,
                       use_kernel=use_kernel)
    _assert_logits_and_tokens(paged, ring)
    assert [int(a.argmax()) for a in ring[:-1]] == feed


# ------------------------------------------------- scheduler-level e2e

def _trace(cfg, seed, n_req, request_cls, template=0):
    """The reference's trace (tests/test_serving_paged.py::_trace)."""
    rng = np.random.default_rng(seed)
    tmpl = rng.integers(1, cfg.vocab_size, size=template).astype(np.int32)
    arrivals, step = [], 0
    for rid in range(n_req):
        tail = rng.integers(1, cfg.vocab_size,
                            size=int(rng.integers(3, 10))).astype(np.int32)
        prompt = np.concatenate([tmpl, tail])[:14].astype(np.int32)
        arrivals.append((step, request_cls(
            rid=rid, prompt=prompt, max_new=int(rng.integers(2, 6)))))
        step += int(rng.poisson(2.0))
    return arrivals


STAT_FIELDS = ("prefills", "decode_steps", "tokens_generated",
               "requests_done", "slot_steps", "live_slot_steps")
RECORD_FIELDS = ("rid", "submit", "admit", "first_token", "retire",
                 "decode", "budget", "prefill_chunks", "prefix_pages_reused")

# name -> (port class, reference class, extra kwargs, trace seed,
#          requests, template, paged counters that must be positive,
#          arch)
QWEN, MAMBA = "qwen1.5-0.5b", "mamba2-370m"
SCHED_CASES = {
    "paged": (PagedContinuousScheduler, JPaged,
              dict(page_size=4, prefill_chunk=8), 7, 6, 0, (), QWEN),
    "paged-prefix": (PagedContinuousScheduler, JPaged,
                     dict(page_size=4, cache_pages=9), 11, 8, 8,
                     ("prefix_pages_hit",), QWEN),
    "paged-deferral": (PagedContinuousScheduler, JPaged,
                       dict(page_size=4, cache_pages=7), 11, 8, 8,
                       ("prefix_pages_hit", "page_deferrals"), QWEN),
    "continuous": (ContinuousScheduler, JContinuous, {}, 7, 6, 0, (), QWEN),
    "wave": (BatchScheduler, JBatch, {}, 7, 6, 0, (), QWEN),
    # the ssm kind: no pages (the pool stays free, the trie empty), its
    # state carried across chunks of 8
    "ssm-paged": (PagedContinuousScheduler, JPaged,
                  dict(page_size=4, prefill_chunk=8), 11, 8, 8, (), MAMBA),
    "ssm-continuous": (ContinuousScheduler, JContinuous, {}, 7, 6, 0, (),
                       MAMBA),
    "ssm-wave": (BatchScheduler, JBatch, {}, 7, 6, 0, (), MAMBA),
}


def _settled(jsched):
    """The reference scheduler with every decode waited for before the
    host goes on. Its paged scheduler hands ``jnp.asarray(self._live)``
    (and the page map) to a decode dispatched asynchronously, then sets
    ``_live[slot]`` in place in the next tick's ``_advance_prefills``; on
    the CPU the pending decode can read the new mask and advance a slot
    whose prefill is still running, which changes that request's tokens
    from run to run."""
    decode = jsched._decode
    jsched._decode = lambda *a: jax.block_until_ready(decode(*a))
    return jsched


@pytest.mark.parametrize("case", sorted(SCHED_CASES))
def test_schedulers_match_reference(case):
    """The reference's traces at temperature 0: the same tokens for every
    request, the same stats and latency records, and for the paged
    scheduler the same deferrals, prefix hits and free pages (the
    reference's ``cache_pages=9`` trace shares an 8-token template; at 7
    pages admission also defers)."""
    cls, jcls, extra, seed, n_req, template, positive, arch = \
        SCHED_CASES[case]
    cfg, jcfg, p, jp = _tiny(arch)
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
    if cls is PagedContinuousScheduler:
        for f in ("page_deferrals", "prefix_pages_hit",
                  "prefix_pages_possible"):
            assert getattr(sched, f) == getattr(jsched, f), f
        assert sched.table.num_free == jsched.table.num_free \
            == sched.cache_pages - 1                      # no leaks
        assert len(sched.trie) == 0
        assert all(getattr(sched, f) > 0 for f in positive), positive
        if "prefill_chunk" in extra:
            assert any(r.prefill_chunks >= 2 for r in stats.records)


@pytest.mark.parametrize("sched_cls", [BatchScheduler, ContinuousScheduler,
                                       PagedContinuousScheduler])
def test_cache_dtype_reaches_every_cache_leaf(sched_cls):
    cfg, _, p, _ = _tiny("qwen1.5-0.5b")
    sched = sched_cls(build_model(cfg), slots=2, max_prompt=8, max_total=16,
                      cache_dtype=torch.bfloat16, device="cpu")
    sched.submit(Request(rid=0, prompt=np.arange(1, 7, dtype=np.int32),
                         max_new=2))
    leaves = []
    for _ in range(16):
        sched.step(p)
        if sched._cache is not None:
            leaves = list(sched._cache["layers"].values())
        if not sched.outstanding:
            break
    assert leaves and all(l.dtype == torch.bfloat16 for l in leaves)
    assert sched.stats.requests_done == 1


def _assert_cli_counts_match(argv, scheduler, capsys):
    assert j_serve_cli.main(argv) == 0
    ref = capsys.readouterr().out.splitlines()
    assert serve_cli.main(argv + ["--device", "cpu"]) == 0
    mine = capsys.readouterr().out.splitlines()

    def counts(lines):
        line = next(l for l in lines if l.startswith("done="))
        return line.split(" util=")[0]

    assert counts(mine) == counts(ref)
    assert mine[0] == ref[0]
    if scheduler == "paged":
        assert mine[-1] == ref[-1]          # pages: ... deferrals=...


@pytest.mark.parametrize("scheduler", ["paged", "continuous", "wave"])
def test_serve_cli_prints_the_reference_counts(scheduler, capsys):
    """The same trace through both CLIs: the same done, prefills,
    decode_steps and tokens (they follow from the trace, not from the
    weights, which the two packages draw differently)."""
    _assert_cli_counts_match(
        ["--reduced", "--scheduler", scheduler, "--temperature", "0",
         "--prefill-chunk", "32", "--prefix-template", "20"],
        scheduler, capsys)


@pytest.mark.parametrize("scheduler", ["paged", "continuous", "wave"])
def test_serve_cli_prints_the_reference_counts_ssm(scheduler, capsys):
    """``--arch mamba2-370m --reduced``: the same counts as the
    reference's CLI, the paged scheduler's page line (no page used)
    included."""
    _assert_cli_counts_match(
        ["--arch", "mamba2-370m", "--reduced", "--scheduler", scheduler,
         "--temperature", "0", "--prefill-chunk", "32",
         "--prefix-template", "20"], scheduler, capsys)


def test_entry_points_refuse_to_run_quietly_on_the_cpu(monkeypatch):
    """No card and no explicit device: the serve CLI and the schedulers
    raise instead of carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, _, _, _ = _tiny("qwen1.5-0.5b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_cli.main(["--reduced", "--scheduler", "paged"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PagedContinuousScheduler(build_model(cfg))


def test_non_dense_kinds_and_unported_flags_raise():
    """Kept under its old name: the moe kind is served now (held to the
    reference in tests/test_torch_serve_moe.py), so a reduced llama4 of
    each layout runs a request through the paged scheduler; the vlm and
    audio kinds still raise in the schedulers (token-only, as the
    reference's), and direct serving, once refused (item 6c), runs them
    (held to the forward in tests/test_torch_serve_vlm_audio.py)."""
    for arch in ("llama4-maverick-400b-a17b", "llama4-scout-17b-a16e"):
        model = build_model(get_arch(arch).reduced(d_model=64, d_ff=128,
                                                   vocab_size=128))
        sched = PagedContinuousScheduler(model, slots=2, max_prompt=8,
                                         max_total=12, device="cpu")
        req = Request(rid=0, prompt=np.arange(1, 7, dtype=np.int32),
                      max_new=3)
        stats = run_trace(sched, model.init(torch.Generator().manual_seed(0),
                                            "cpu"), [(0, req)])
        assert stats.requests_done == 1 and len(req.out_tokens) == 3
    for arch in ("whisper-small", "paligemma-3b"):
        model = build_model(get_arch(arch).reduced())
        with pytest.raises(ValueError, match="token-only"):
            PagedContinuousScheduler(model, device="cpu")
        assert serve_cli.main(["--arch", arch, "--reduced", "--batch", "2",
                               "--prompt-len", "8", "--gen", "2",
                               "--device", "cpu"]) == 0
    # --trace-dir and --profile are ported (tests/test_torch_obs.py)
    for flags, item in ((["--mesh", "host"], "item 8"),
                        (["--host-devices", "8"], "item 8")):
        with pytest.raises(NotImplementedError, match=item):
            serve_cli.main(["--reduced", "--device", "cpu"] + flags)
