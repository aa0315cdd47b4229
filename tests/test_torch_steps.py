"""The port's step builders (``repro_torch.launch.steps``) against the
reference's (``repro.launch.steps``), and the TT-HF shardings of
``repro_torch.core.distributed``.

* ``make_train_step`` (sgd, momentum, adamw; accumulation 1 and 2) on a
  reduced qwen, two steps, against the reference's unsharded jitted step
  with ``remat=False``: loss rtol 1e-5, parameters 1e-5.
* ``accum_steps_for``, ``serve_window_for``, ``param_dtype_for``,
  ``model_flops_for`` and ``input_specs``' shapes and dtypes, exactly, for
  the 10 archs x 4 shapes on the pod and multi-pod geometries.
* The resolution of ``TRAIN_RULES`` (params, batches),
  ``CACHE_RULES_DECODE`` and ``CACHE_RULES_LONG`` (ring caches) and
  ``tthf_shardings`` (both granularities) for every leaf of the 10 archs
  at full size, exactly, against the reference's ``ShardingRules.spec``
  on ``AbstractMesh``es.
* The builders' programs on a one-rank gloo mesh: the train step equals
  the unsharded step; the train step and the fused TT-HF interval
  (``build_tthf_program``) with remat equal themselves without it,
  bitwise, on DTensors; prefill, decode and both serving pairs run and
  write their caches.
"""
import _torch_threads  # noqa: F401  (torch threads per xdist worker)

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JMesh

from repro.configs import INPUT_SHAPES as J_SHAPES
from repro.configs import get_arch as j_get_arch
from repro.core import distributed as jdist
from repro.launch import analysis as janalysis
from repro.launch import steps as jsteps
from repro.models import build_model as j_build_model
from repro_torch.configs import ARCHS, INPUT_SHAPES, get_arch
from repro_torch.core import distributed as tdist
from repro_torch.dist import sharding as sh
from repro_torch.launch import analysis, steps
from repro_torch.models import build_model
from repro_torch.models.common import params_from_jax, tree_items

GEOMETRIES = {"pod": ((16, 16), ("data", "model")),
              "multipod": ((2, 16, 16), ("pod", "data", "model"))}
ALL_ARCHS = sorted(ARCHS)
ALL_SHAPES = sorted(INPUT_SHAPES)
_KW = dict(d_model=64, d_ff=128, vocab_size=128)
_JCFG = j_get_arch("qwen1.5-0.5b").reduced(**_KW)
_CFG = get_arch("qwen1.5-0.5b").reduced(**_KW)
B, T = 4, 16


def _meshes(name):
    sizes, names = GEOMETRIES[name]
    return sh.AbstractMesh(sizes, names), JMesh(sizes, names)


def _jax_mesh_like(name):
    """What the reference's ``accum_steps_for`` reads of a mesh."""
    sizes, names = GEOMETRIES[name]
    return types.SimpleNamespace(axis_names=names,
                                 devices=np.empty(sizes, dtype=np.int8))


def _jax_items(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, tuple))[0]
    return [(tuple(k.key for k in path), leaf) for path, leaf in flat]


def _spec_of(place, mesh) -> tuple:
    """The spec of DTensor placements, up to its last sharded dim."""
    from torch.distributed.tensor import Shard
    names = sh.mesh_axis_names(mesh)
    dims: dict = {}
    for m, pl in zip(names, place):
        if isinstance(pl, Shard):
            dims.setdefault(pl.dim, []).append(m)
    n = max(dims, default=-1) + 1
    return tuple(None if d not in dims else dims[d][0]
                 if len(dims[d]) == 1 else tuple(dims[d]) for d in range(n))


def _trim(spec) -> tuple:
    spec = tuple(spec)
    while spec and spec[-1] is None:
        spec = spec[:-1]
    return spec


# ---------------------------------------------------------------------------
# make_train_step against the reference's jitted step
# ---------------------------------------------------------------------------

def _batches(n):
    rng = np.random.default_rng(0)
    return [{k: rng.integers(0, _CFG.vocab_size, size=(B, T)).astype(
        np.int32) for k in ("tokens", "labels")} for _ in range(n)]


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("optimizer", ["sgd", "momentum", "adamw"])
def test_train_step_matches_reference(optimizer, accum):
    jmodel, model = j_build_model(_JCFG), build_model(_CFG)
    jparams = jmodel.init(jax.random.PRNGKey(0), jnp.float32)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    jstep, jo = jsteps.make_train_step(
        jmodel, optimizer=optimizer, lr=1e-3, dtype=jnp.float32,
        remat=False, accum_steps=accum)
    step, opt = steps.make_train_step(model, optimizer=optimizer, lr=1e-3,
                                      dtype=torch.float32,
                                      accum_steps=accum)
    jstep = jax.jit(jstep)
    jstate, state = jo.init(jparams), opt.init(params)
    leaves = [v for _, v in tree_items(params)]
    jstates = []
    for i, b in enumerate(_batches(2)):
        jparams, jstate, jloss = jstep(jparams, jstate, b, i)
        jstates.append(jstate)
        out, state, loss = step(
            params, state, {k: torch.from_numpy(v) for k, v in b.items()},
            i)
        assert out is params          # updated in place
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert [v for _, v in tree_items(params)][0] is leaves[0]
    keep = {}
    if optimizer == "adamw":
        # AdamW's step m̂ / (sqrt(v̂) + eps) turns an absolute gradient
        # difference into a step difference of lr times it over
        # sqrt(v̂): where a gradient is near 0 (the key bias's is 0 in
        # exact arithmetic: softmax ignores a shift of every score) or
        # m̂ cancels to a small part of sqrt(v̂), the two frameworks'
        # rounding moves the step by up to 2 lr. The moments are held to
        # 1e-5 everywhere; the params to 1e-5 where every step was well
        # conditioned (sqrt(v̂) > 1e-6 and |m̂| > sqrt(v̂) / 10), the rest
        # to 2 lr.
        for name in ("m", "v"):
            for (path, t), (_, j) in zip(tree_items(state[name]),
                                         _jax_items(jstate[name])):
                np.testing.assert_allclose(t.numpy(), np.asarray(j),
                                           atol=1e-5, rtol=1e-5,
                                           err_msg=str(path))
        for t, js in enumerate(jstates, start=1):
            c1, c2 = 1 - 0.9 ** t, 1 - 0.999 ** t
            for (path, m), (_, v) in zip(_jax_items(js["m"]),
                                         _jax_items(js["v"])):
                den = np.sqrt(np.asarray(v) / c2)
                good = (den > 1e-6) & (np.abs(np.asarray(m) / c1)
                                       > den / 10)
                keep[path] = keep.get(path, True) & good
    held = []
    for (path, t), (_, j) in zip(tree_items(params), _jax_items(jparams)):
        t, j = t.numpy(), np.asarray(j)
        ok = keep.get(path, np.ones(t.shape, bool))
        held.append((ok.sum(), ok.size))
        np.testing.assert_allclose(t[ok], j[ok], atol=1e-5, rtol=0,
                                   err_msg=str(path))
        np.testing.assert_allclose(t[~ok], j[~ok], atol=2 * 2e-3, rtol=0,
                                   err_msg=str(path))
    assert sum(a for a, _ in held) / sum(n for _, n in held) > 0.9


# ---------------------------------------------------------------------------
# host-side helpers, every arch x shape x geometry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_host_helpers_match_reference(arch, geometry):
    cfg, jcfg = get_arch(arch), j_get_arch(arch)
    mesh, _ = _meshes(geometry)
    jmesh = _jax_mesh_like(geometry)
    model, jmodel = build_model(cfg), j_build_model(jcfg)
    assert ((steps.param_dtype_for(cfg) == torch.bfloat16)
            == (jsteps.param_dtype_for(jcfg) == jnp.bfloat16))
    for name in ALL_SHAPES:
        shape, jshape = INPUT_SHAPES[name], J_SHAPES[name]
        assert (steps.accum_steps_for(cfg, shape, mesh)
                == jsteps.accum_steps_for(jcfg, jshape, jmesh)), name
        assert (steps.serve_window_for(cfg, shape)
                == jsteps.serve_window_for(jcfg, jshape)), name
        assert (analysis.model_flops_for(cfg, shape)
                == janalysis.model_flops_for(jcfg, jshape)), name
        sw = steps.serve_window_for(cfg, shape)
        got = dict(tree_items(model.input_specs(shape, serve_window=sw)))
        want = dict(_jax_items(jmodel.input_specs(jshape, serve_window=sw)))
        assert sorted(got) == sorted(want), name
        for path, t in got.items():
            j = want[path]
            assert t.device.type == "meta", (name, path)
            assert tuple(t.shape) == tuple(j.shape), (name, path)
            assert str(t.dtype).split(".")[-1] == str(j.dtype), (name, path)


# ---------------------------------------------------------------------------
# rule resolution, every leaf of every arch at full size
# ---------------------------------------------------------------------------

def _same_specs(port_items, jax_items, resolve, jresolve):
    port, ref = dict(port_items), dict(jax_items)
    assert sorted(port) == sorted(ref)
    for path, axes in port.items():
        assert tuple(axes) == tuple(ref[path]), path
        got, want = resolve(tuple(axes)), jresolve(tuple(axes))
        assert tuple(got) == tuple(want), (path, got, want)


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_train_and_cache_rules_match_reference(arch, geometry):
    mesh, jmesh = _meshes(geometry)
    model, jmodel = build_model(get_arch(arch)), j_build_model(
        j_get_arch(arch))
    _, axes = model.abstract_params()
    _, jaxes = jmodel.abstract_params()
    _same_specs(tree_items(axes), _jax_items(jaxes),
                lambda a: steps.TRAIN_RULES.spec(a, mesh),
                lambda a: jsteps.TRAIN_RULES.spec(a, jmesh))
    for rules, jrules, long in (
            (steps.CACHE_RULES_DECODE, jsteps.CACHE_RULES_DECODE, False),
            (steps.CACHE_RULES_LONG, jsteps.CACHE_RULES_LONG, True)):
        _same_specs(tree_items(model.cache_axes(long_context=long)),
                    _jax_items(jmodel.cache_axes(long_context=long)),
                    lambda a: rules.spec(a, mesh),
                    lambda a: jrules.spec(a, jmesh))
    # the placements shard_tree gives are these specs
    place = dict(tree_items(steps.shard_tree(axes, mesh, steps.TRAIN_RULES)))
    for path, ax in tree_items(axes):
        assert _spec_of(place[path], mesh) == _trim(
            steps.TRAIN_RULES.spec(tuple(ax), mesh)), path
    batch = model.input_specs(INPUT_SHAPES["train_4k"])["batch"]
    for k, pl in steps.batch_shardings(batch, mesh,
                                       steps.TRAIN_RULES).items():
        assert _spec_of(pl, mesh) == _trim(jsteps.TRAIN_RULES.spec(
            ("batch",) + (None,) * (batch[k].ndim - 1), jmesh)), k


@pytest.mark.parametrize("granularity", ["dp", "pod"])
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_tthf_shardings_match_reference(geometry, granularity):
    mesh, jmesh = _meshes(geometry)
    R = 2 if granularity == "pod" and geometry == "multipod" else 16
    scale = tdist.TTHFScaleConfig(replicas=R, cluster_size=R,
                                  granularity=granularity)
    jscale = jdist.TTHFScaleConfig(replicas=R, cluster_size=R,
                                   granularity=granularity)
    for arch in ALL_ARCHS:
        model, jmodel = build_model(get_arch(arch)), j_build_model(
            j_get_arch(arch))
        pdt = steps.param_dtype_for(model.cfg)
        p_abs, place, batch = tdist.tthf_shardings(model, scale, mesh,
                                                   param_dtype=pdt)
        jp_abs, jsh, jbatch = jdist.tthf_shardings(
            jmodel, jscale, jmesh, param_dtype=jsteps.param_dtype_for(
                jmodel.cfg))
        jplace = dict(_jax_items(jax.tree.map(
            lambda s: tuple(s.spec), jsh,
            is_leaf=lambda x: hasattr(x, "spec"))))
        jshapes = dict(_jax_items(jax.tree.map(
            lambda s: (tuple(s.shape), str(s.dtype)), jp_abs)))
        for path, pl in tree_items(place):
            assert _spec_of(pl, mesh) == _trim(jplace[path]), (arch, path)
        for path, t in tree_items(p_abs):
            assert (tuple(t.shape), str(t.dtype).split(".")[-1]) \
                == jshapes[path], (arch, path)
        assert _spec_of(batch, mesh) == _trim(jbatch.spec), arch
        _, axes = model.abstract_params()
        for path, ax in tree_items(tdist.replica_axes_tree(axes)):
            assert ax[0] == "replica" and ax[1:] == tuple(
                dict(tree_items(axes))[path]), path
    assert dict(tdist.TTHF_PARAM_RULES) == dict(jdist.TTHF_PARAM_RULES)
    with pytest.raises(ValueError, match="granularity"):
        tdist.tthf_rules(tdist.TTHFScaleConfig(granularity="chip"))


# ---------------------------------------------------------------------------
# the programs on a one-rank gloo mesh
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def one_rank_mesh():
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield init_device_mesh("cpu", (1, 1),
                               mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("optimizer", ["sgd", "adamw"])
def test_train_program_on_a_mesh_equals_the_step(one_rank_mesh, optimizer):
    from repro_torch.configs import InputShape
    from repro_torch.dist.sharding import local
    from repro_torch.optim import make_optimizer
    model = build_model(_CFG)
    shape = InputShape("train_4k", T, B, "train")
    fn, args = steps.build_program(model, shape, one_rank_mesh,
                                   optimizer=optimizer, lr=1e-2,
                                   dtype=torch.float32, accum_steps=2)
    assert all(t.device.type == "meta" for _, t in tree_items(args[0]))
    assert tuple(args[2]["tokens"].shape) == (B, T)
    step, _ = steps.make_train_step(model, optimizer=optimizer, lr=1e-2,
                                    dtype=torch.float32, accum_steps=2)
    p_mesh = model.init(torch.Generator().manual_seed(0), "cpu")
    p_bare = model.init(torch.Generator().manual_seed(0), "cpu")
    opt = make_optimizer(optimizer)
    s_mesh, s_bare = opt.init(p_mesh), opt.init(p_bare)
    idx = torch.zeros((), dtype=torch.int32)
    for b in _batches(2):
        b = {k: torch.from_numpy(v) for k, v in b.items()}
        _, s_mesh, l_mesh = fn(p_mesh, s_mesh, b, idx)
        _, s_bare, l_bare = step(p_bare, s_bare, b, idx)
        assert float(local(l_mesh)) == float(l_bare)
    for (path, a), (_, b) in zip(tree_items(p_mesh), tree_items(p_bare)):
        assert torch.equal(a, b), path


def test_programs_with_and_without_remat_are_bitwise(one_rank_mesh):
    """``build_program``'s train step and ``build_tthf_program``'s fused
    interval on DTensors, with remat (the default) and without: the same
    losses and parameters bitwise."""
    from repro_torch.configs import InputShape
    from repro_torch.core.distributed import FlatParamSpec, stack_replicas
    from repro_torch.dist.sharding import local
    from repro_torch.launch.dryrun import build_tthf_program
    model = build_model(_CFG)
    shape = InputShape("train_4k", T, B, "train")
    idx = torch.zeros((), dtype=torch.int32)
    runs = []
    for remat in (True, False):
        fn, _ = steps.build_program(model, shape, one_rank_mesh, lr=1e-2,
                                    dtype=torch.float32, remat=remat)
        params = model.init(torch.Generator().manual_seed(0), "cpu")
        losses = [float(local(fn(params, (), {k: torch.from_numpy(v) for
                                              k, v in b.items()}, idx)[2]))
                  for b in _batches(2)]
        runs.append((losses, [t.clone() for _, t in tree_items(params)]))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    flat = FlatParamSpec.for_model(model).flatten(stack_replicas(
        model.init(torch.Generator().manual_seed(0), "cpu"), 2))
    outs = []
    for remat in (True, False):
        fn, args = build_tthf_program(model, shape, one_rank_mesh, "tthf",
                                      "fused", tau=2, consensus_every=2,
                                      fused_interval=True, replicas=2,
                                      remat=remat)
        toks = torch.from_numpy(np.random.default_rng(1).integers(
            0, _CFG.vocab_size, size=tuple(args[1]["tokens"].shape)).astype(
                np.int32))
        picks = torch.zeros(tuple(args[2].shape), dtype=torch.int32)
        out, loss = fn(flat.clone(), {"tokens": toks,
                                      "labels": toks.roll(1, dims=-1)},
                       picks, idx)
        outs.append((float(local(loss)), local(out).clone()))
    assert outs[0][0] == outs[1][0] and torch.equal(outs[0][1], outs[1][1])


def test_serving_programs_run_on_a_mesh(one_rank_mesh):
    model = build_model(_CFG)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(1)
    from repro_torch.configs import InputShape
    from repro_torch.dist.sharding import local

    fn, args = steps.build_program(
        model, InputShape("prefill_32k", T, 2, "prefill"), one_rank_mesh,
        dtype=torch.float32)
    toks = torch.from_numpy(rng.integers(1, 100, (2, T)).astype(np.int32))
    logits, cache, pos = fn(params, {"tokens": toks})
    assert tuple(logits.shape) == (2, 1, _CFG.padded_vocab)
    want, _, _ = model.prefill(params, {"tokens": toks}, dtype=torch.float32)
    torch.testing.assert_close(local(logits), want, rtol=0, atol=0)

    fn, args = steps.build_program(
        model, InputShape("decode_32k", 2 * T, 2, "decode"), one_rank_mesh,
        dtype=torch.float32)
    cache = model.init_cache(2, 2 * T, torch.float32, device="cpu")
    lg, _ = fn(params, toks[:, :1], cache, torch.tensor(0, dtype=torch.int32))
    assert tuple(lg.shape) == (2, 1, _CFG.padded_vocab)

    ring = steps.build_serve_program(model, one_rank_mesh, slots=2,
                                     max_prompt=T, max_total=2 * T,
                                     dtype=torch.float32)
    adm, adm_args = ring["admission"]
    assert sorted(ring) == ["admission", "decode"]
    cache = model.init_cache(2, 2 * T, torch.float32, device="cpu")
    pos = torch.zeros(2, dtype=torch.int32)
    logits = torch.zeros((2, 1, _CFG.padded_vocab))
    adm(params, cache, pos, logits, toks[:1], torch.tensor([T]), 1)
    assert int(pos[1]) == T and int(pos[0]) == 0
    assert float(logits[1].abs().sum()) > 0 and float(logits[0].abs().sum()) == 0
    dec, _ = ring["decode"]
    lg, _ = dec(params, toks[:, :1], cache, pos)
    assert torch.isfinite(local(lg)).all()

    paged = steps.build_paged_serve_program(
        model, one_rank_mesh, slots=2, max_prompt=T, max_total=2 * T,
        page_size=8, dtype=torch.float32)
    adm, adm_args = paged["admission_chunk"]
    P = 4
    assert tuple(adm_args[6]) == tuple(range(1, P + 1))
    cache = model.init_paged_cache(2, 2 * P + 1, 8, torch.float32,
                                   device="cpu")
    logits = torch.zeros((2, 1, _CFG.padded_vocab))
    adm(params, cache, logits, toks[:1], 0, T, np.arange(1, P + 1), 0)
    assert float(logits[0].abs().sum()) > 0
    dec, dec_args = paged["decode"]
    assert dec_args[5].dtype == torch.bool
    page_map = torch.tensor([[1, 2, 3, 4], [0, 0, 0, 0]], dtype=torch.int32)
    lg, _ = dec(params, toks[:, :1], cache,
                torch.tensor([T, 0], dtype=torch.int32), page_map,
                torch.tensor([True, False]))
    assert torch.isfinite(local(lg)).all()

    vlm = build_model(get_arch("paligemma-3b").reduced(**_KW))
    with pytest.raises(ValueError, match="token-only"):
        steps.build_serve_program(vlm, one_rank_mesh)
