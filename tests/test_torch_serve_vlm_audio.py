"""Serving the vlm kind (paligemma-3b) and the audio kind (whisper-small)
in the port against the reference on the CPU: the ring engine's prefill
and decode against the model's forward and against the reference's
engine, a mixed-length prefill against solo prefills, a slot write, the
serve CLI's direct mode, and the refusals (the request schedulers and
scale mode serve tokens only, as the reference's do).

Configs are the archs' ``reduced()`` defaults (2 layers, d 256,
vocabulary 512; paligemma keeps its 256 patches, whisper has 2 encoder
layers over 16 frames). Weights are the reference's, carried by
``params_from_jax``; inputs are seeded numpy draws.

Tolerances, and why:
- prefill and decode logits against the forward within 5e-5, a
  mixed-length prefill and its per-slot decode against solo runs within
  3e-4: the reference's own (``tests/test_serving.py``);
- the port's engine against the reference's engine on the same inputs
  within 1e-5 (float32 on both sides, products summed in another order);
  ``pos`` and greedy tokens exactly.
"""
import _torch_threads  # noqa: F401  (torch threads per xdist worker)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.core.distributed import TTHFScaleConfig as JScaleConfig
from repro.models import build_model as j_build_model
from repro.serving import engine as j_engine
from repro.train.trainer import (
    ScaleTrainer as JScaleTrainer, TrainerConfig as JTrainerConfig)

from repro_torch.configs import get_arch
from repro_torch.core.distributed import TTHFScaleConfig
from repro_torch.launch import serve as serve_cli
from repro_torch.models import build_model, params_from_jax
from repro_torch.serving import (
    BatchScheduler, ContinuousScheduler, PagedContinuousScheduler,
    decode_step, init_cache_tree, prefill, write_cache_slot)
from repro_torch.train.trainer import ScaleTrainer, TrainerConfig

ARCHS = ["paligemma-3b", "whisper-small"]
ATOL = 1e-5

# the reference's engine, compiled once per shape
_STATIC = {"prefill": ("dtype", "cache_dtype", "cache_len", "serve_window"),
           "decode_step": ("dtype", "serve_window")}
_J = {name: jax.jit(getattr(j_engine, name), static_argnums=(1,),
                    static_argnames=static)
      for name, static in _STATIC.items()}


@functools.lru_cache(maxsize=None)
def _tiny(arch):
    """(port cfg, reference cfg, port params, reference params)."""
    cfg, jcfg = get_arch(arch).reduced(), j_get_arch(arch).reduced()
    jp = jax.jit(j_build_model(jcfg).init)(jax.random.PRNGKey(0))
    return cfg, jcfg, params_from_jax(jax.tree.map(np.asarray, jp),
                                      "cpu"), jp


def _frontend(cfg, B, seed):
    """{"patches" or "frames": (B, enc_seq_len, d) float32}."""
    name = "patches" if cfg.kind == "vlm" else "frames"
    return {name: np.random.default_rng(seed).standard_normal(
        (B, cfg.enc_seq_len, cfg.d_model), dtype=np.float32) * 0.1}


def _prefix(cfg):
    return cfg.enc_seq_len if cfg.kind == "vlm" else 0


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=0)


def _greedy(logits):
    return np.argmax(np.asarray(logits)[:, -1], -1)[:, None].astype(np.int32)


@pytest.mark.parametrize("serve_window", [0, 8])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_forward(arch, serve_window):
    """``tests/test_serving.py``'s case: a prefill of 21 of 24 tokens and
    3 decode steps fed the rest equal the forward over all 24 (5e-5),
    and the reference's engine on the same inputs (1e-5); the vlm cache
    holds the 256 patches and ``pos`` starts past them. With
    ``serve_window`` 8 the ring decode slides while the prefill keeps
    the reference's masks (the vlm prefix mask, the audio causal mask, at
    window 0), so it is held to the reference's engine only."""
    cfg, jcfg, p, jp = _tiny(arch)
    T, n_dec, B = 24, 3, 2
    Tp = T - n_dec
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(B, T)).astype(np.int32)
    front = _frontend(cfg, B, seed=2)
    full, _ = build_model(cfg).forward(p, _t({"tokens": toks, **front}),
                                       dtype=torch.float32)
    pb = {"tokens": toks[:, :Tp], **front}
    cl = T + _prefix(cfg)
    kw = dict(cache_len=cl, serve_window=serve_window)
    jl, jc, jpos = _J["prefill"](jp, jcfg, _j(pb), dtype=jnp.float32,
                                 cache_dtype=jnp.float32, **kw)
    tl, tc, tpos = prefill(p, cfg, _t(pb), dtype=torch.float32,
                           cache_dtype=torch.float32, **kw)
    assert int(tpos) == int(jpos) == Tp + _prefix(cfg)
    S = serve_window or cl
    assert tc["layers"]["k"].shape == (2, B, S, cfg.num_kv_heads,
                                       cfg.head_dim)
    if cfg.kind == "audio":
        assert tc["layers"]["cross_k"].shape == (
            2, B, cfg.enc_seq_len, cfg.num_kv_heads, cfg.head_dim)
    _close(tl, jl)
    if not serve_window:
        _close(tl[:, 0], full[:, Tp - 1].detach(), atol=5e-5)
    for i in range(n_dec):
        tok = toks[:, Tp + i:Tp + i + 1]
        jl, jc = _J["decode_step"](jp, jcfg, jnp.asarray(tok), jc, jpos,
                                   dtype=jnp.float32,
                                   serve_window=serve_window)
        tl, tc = decode_step(p, cfg, torch.from_numpy(tok), tc, tpos,
                             dtype=torch.float32, serve_window=serve_window)
        _close(tl, jl)
        if not serve_window:
            _close(tl[:, 0], full[:, Tp + i].detach(), atol=5e-5)
        jpos, tpos = jpos + 1, tpos + 1
    for (name, leaf), want in zip(sorted(tc["layers"].items()),
                                  jax.tree.leaves(jc["layers"])):
        _close(leaf, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_lengths_matches_solo(arch):
    """``tests/test_serving.py``'s mixed-length case: a right-padded
    two-row prefill (lengths 5 and 11, shifted by the vlm prefix) equals
    each row's solo prefill and 4 greedy per-slot decode steps equal the
    solo continuations (3e-4); logits, ``pos`` and caches equal the
    reference's engine on the same inputs."""
    cfg, jcfg, p, jp = _tiny(arch)
    lens = [5, 11]
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab_size - 1, size=n).astype(np.int32)
               for n in lens]
    cl = 32 + _prefix(cfg)
    front = _frontend(cfg, 2, seed=3)
    toks = np.zeros((2, 16), np.int32)
    for i, pr in enumerate(prompts):
        toks[i, :len(pr)] = pr
    kw = dict(dtype=torch.float32, cache_dtype=torch.float32, cache_len=cl)
    lg, cache, pos = prefill(p, cfg, _t({"tokens": toks, **front}),
                             lengths=torch.tensor(lens), **kw)
    jlg, jcache, jpos = j_engine.prefill(
        jp, jcfg, _j({"tokens": toks, **front}), dtype=jnp.float32,
        cache_dtype=jnp.float32, cache_len=cl, lengths=jnp.asarray(lens))
    want_pos = [n + _prefix(cfg) for n in lens]
    assert pos.tolist() == want_pos == np.asarray(jpos).tolist()
    _close(lg, jlg)
    for (name, leaf), want in zip(sorted(cache["layers"].items()),
                                  jax.tree.leaves(jcache["layers"])):
        _close(leaf, want)
    solo = [prefill(p, cfg, _t({"tokens": pr[None],
                                **{k: v[i:i + 1] for k, v in front.items()}}),
                    **kw) for i, pr in enumerate(prompts)]
    for step in range(5):
        for i, (lgs, _, _) in enumerate(solo):
            np.testing.assert_allclose(lg[i].numpy(), lgs[0].numpy(),
                                       atol=3e-4, err_msg=f"step {step}")
        if step == 4:
            break
        tb = _greedy(lg)
        assert tb[:, 0].tolist() == [int(_greedy(l)[0, 0])
                                     for l, _, _ in solo]
        solo = [(*decode_step(p, cfg, torch.from_numpy(_greedy(l)), c, ps,
                              dtype=torch.float32), ps + 1)
                for l, c, ps in solo]
        jlg, jcache = j_engine.decode_step(jp, jcfg, jnp.asarray(tb), jcache,
                                           jpos, dtype=jnp.float32)
        lg, cache = decode_step(p, cfg, torch.from_numpy(tb), cache, pos,
                                dtype=torch.float32)
        _close(lg, jlg)
        pos, jpos = pos + 1, jpos + 1


@pytest.mark.parametrize("arch", ARCHS)
def test_write_cache_slot_roundtrip(arch):
    """Batch-1 prefills written into slots of a live cache: every leaf
    (the audio kind's ``cross_k``/``cross_v`` along their batch axis too)
    is its solo cache row for row and equals the reference's
    ``write_cache_slot``; the batch then decodes like the solo runs."""
    cfg, jcfg, p, jp = _tiny(arch)
    cl = 24 + _prefix(cfg)
    rng = np.random.default_rng(2)
    cache = init_cache_tree(cfg, 2, cl, torch.float32, device="cpu")
    jcache = j_engine.init_cache_tree(jcfg, 2, cl, jnp.float32)
    pos = torch.zeros(2, dtype=torch.int32)
    jpos = jnp.zeros((2,), jnp.int32)
    solos = []
    for slot, n in enumerate((7, 10)):
        pr = rng.integers(1, cfg.vocab_size - 1, size=n).astype(np.int32)
        one = {"tokens": pr[None], **_frontend(cfg, 1, seed=10 + slot)}
        lg1, c1, p1 = prefill(p, cfg, _t(one), dtype=torch.float32,
                              cache_dtype=torch.float32, cache_len=cl)
        _, jc1, jp1 = j_engine.prefill(jp, jcfg, _j(one), dtype=jnp.float32,
                                       cache_dtype=jnp.float32, cache_len=cl)
        cache, pos = write_cache_slot(cfg, cache, c1, slot, pos=pos,
                                      one_pos=p1)
        jcache, jpos = j_engine.write_cache_slot(jcfg, jcache, jc1, slot,
                                                 pos=jpos, one_pos=jp1)
        solos.append((lg1, c1, p1))
    want_pos = [7 + _prefix(cfg), 10 + _prefix(cfg)]
    assert pos.tolist() == want_pos == np.asarray(jpos).tolist()
    names = ["k", "v"] + (["cross_k", "cross_v"] if cfg.kind == "audio"
                          else [])
    assert sorted(cache["layers"]) == sorted(names)
    for name, leaf in cache["layers"].items():
        _close(leaf, jcache["layers"][name])
        for slot, (_, c1, _) in enumerate(solos):
            assert torch.equal(leaf[:, slot], c1["layers"][name][:, 0])
    lgb = torch.cat([s[0] for s in solos])
    for _ in range(3):
        tb = _greedy(lgb)
        assert tb[:, 0].tolist() == [int(_greedy(l)[0, 0])
                                     for l, _, _ in solos]
        solos = [(*decode_step(p, cfg, torch.from_numpy(_greedy(l)), c, ps,
                               dtype=torch.float32), ps + 1)
                 for l, c, ps in solos]
        lgb, cache = decode_step(p, cfg, torch.from_numpy(tb), cache, pos,
                                 dtype=torch.float32)
        pos = pos + 1
        for i, (l, _, _) in enumerate(solos):
            _close(lgb[i], l[0].numpy())


@pytest.mark.parametrize("arch", ARCHS)
def test_direct_serve_cli_tokens_match_forward(arch, monkeypatch, capsys):
    """``serve_cli.main`` in direct mode (the default scheduler) on the
    CPU returns 0, and its greedy tokens are the teacher-forced forward's
    over the frontend's embeddings, the prompt and the tokens themselves:
    the argmax at each prompt end and generated position."""
    cfg, _, p, _ = _tiny(arch)
    monkeypatch.setattr(serve_cli, "init_params", lambda *a: p)
    B, T, gen = 2, 12, 6
    assert serve_cli.main(["--arch", arch, "--reduced", "--batch", str(B),
                           "--prompt-len", str(T), "--gen", str(gen),
                           "--temperature", "0", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == f"arch={cfg.name} B={B} prompt={T} gen={gen} devices=1"
    args = serve_cli.parse_args(["--batch", str(B), "--prompt-len", str(T),
                                 "--gen", str(gen), "--temperature", "0"])
    run = serve_cli.run_direct(args, cfg, build_model(cfg),
                               torch.device("cpu"), p, keep_logits=True)
    batch = run["batch"]
    assert set(batch) == {"tokens", "patches" if cfg.kind == "vlm"
                          else "frames"}
    fe = next(v for k, v in batch.items() if k != "tokens")
    assert fe.dtype == np.float32 and fe.shape == (B, cfg.enc_seq_len,
                                                  cfg.d_model)
    sampled = run["sampled"]
    assert lines[-1] == f"sampled token ids (first row): {sampled[0].tolist()}"
    seq = np.concatenate([batch["tokens"], sampled], axis=1)
    full, _ = build_model(cfg).forward(
        p, _t({**batch, "tokens": seq}), dtype=torch.float32)
    want = full[:, T - 1:T - 1 + gen].argmax(-1).numpy()
    np.testing.assert_array_equal(sampled, want)
    _close(run["logits"], full[:, T - 1:].detach(), atol=5e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_schedulers_and_scale_mode_refuse(arch):
    """The request schedulers serve tokens only and refuse both kinds
    (token-only), as the reference's do; the paged cache too. Scale mode:
    the reference's ``ScaleTrainer`` fails on these kinds with a
    ``KeyError`` on the batch's missing ``patches`` / ``frames`` (its
    interval batch holds tokens and labels), and the port's refuses them
    at construction with a ``ValueError``."""
    cfg, jcfg, _, _ = _tiny(arch)
    model = build_model(cfg)
    for cls in (BatchScheduler, ContinuousScheduler,
                PagedContinuousScheduler):
        with pytest.raises(ValueError, match="token-only"):
            cls(model, device="cpu")
    with pytest.raises(ValueError, match="token-only"):
        model.init_paged_cache(2, 4, 4, torch.float32, device="cpu")
    sc = dict(replicas=2, cluster_size=2, tau=1, consensus_every=1,
              gamma_d2d=1)
    tr = JScaleTrainer(jcfg, JScaleConfig(**sc),
                       JTrainerConfig(batch_per_replica=1, seq_len=8,
                                      intervals=1, eval_every=0,
                                      prefetch=False))
    with pytest.raises(KeyError, match="patches|frames"):
        tr.run(1)
    with pytest.raises(ValueError, match="token batches only"):
        ScaleTrainer(cfg, TTHFScaleConfig(**sc), TrainerConfig(),
                     device="cpu")
