"""The port's logical-axis sharding layer (``repro_torch.dist``,
``repro_torch.serving.sharding``, ``repro_torch.launch.mesh``) resolves
exactly as the reference's does on the host: the reference's meshes are
``jax.sharding.AbstractMesh``es of the production multi-pod geometry
(2 x 16 x 16) and of an 8-device host (2 x 4), the port's
``AbstractMesh``es of the same sizes, and a resolved spec (a tuple) is
compared with the reference's ``PartitionSpec`` entry by entry.

For every arch of the registry at full size: the logical-axes trees of
the ring and paged caches, the abstract shapes of the params and of both
caches, and the spec of every param, ring-cache and paged-cache leaf
under the serve tables. Then the maverick sequence fallback, the rule
table's own contract (``spec``, ``spec_for_shape``, ``with_overrides``,
its errors), ``resolve_hint_spec`` under nested ``drop_hint_axes``,
``placements`` and the serve meshes' shapes and errors.
"""
import _torch_threads  # noqa: F401  (torch threads per xdist worker)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import AbstractMesh as JMesh

from repro.configs import ARCHS as J_ARCHS
from repro.configs import get_arch as j_get_arch
from repro.dist import sharding as jsh
from repro.models import build_model as j_build_model
from repro.serving import SERVE_CACHE_RULES as J_CACHE_RULES
from repro.serving import SERVE_PARAM_RULES as J_PARAM_RULES
from repro_torch.configs import ARCHS, get_arch
from repro_torch.dist import sharding as sh
from repro_torch.launch.mesh import (
    chips_in, make_production_mesh, serve_mesh_shape)
from repro_torch.models import build_model
from repro_torch.models.common import tree_items
from repro_torch.serving import (
    SERVE_CACHE_RULES, SERVE_PARAM_RULES, cache_shardings,
    paged_cache_shardings, param_shardings, serve_shardings)
from repro_torch.serving.engine import PAGED_KINDS
from repro_torch.serving.pages import pages_per_slot
from repro_torch.serving.sharding import specs_for, token_placements

MESHES = {
    "multipod": ((2, 16, 16), ("pod", "data", "model")),
    "host8": ((2, 4), ("data", "model")),
}
ALL_ARCHS = sorted(ARCHS)
SLOTS, SEQ, PAGE = 8, 2048, 16


def _meshes(name):
    sizes, names = MESHES[name]
    return sh.AbstractMesh(sizes, names), JMesh(sizes, names)


def _same(spec, jspec):
    """A port spec equals a reference PartitionSpec entry by entry."""
    assert tuple(spec) == tuple(jspec), (spec, jspec)


def spec_of(place, mesh) -> tuple:
    """The spec of DTensor placements (the inverse of ``placements``), up
    to its last sharded dim."""
    from torch.distributed.tensor import Shard
    names = sh.mesh_axis_names(mesh)
    dims: dict = {}
    for m, pl in zip(names, place):
        if isinstance(pl, Shard):
            dims.setdefault(pl.dim, []).append(m)
    n = max(dims, default=-1) + 1
    return tuple(None if d not in dims else dims[d][0]
                 if len(dims[d]) == 1 else tuple(dims[d]) for d in range(n))


def _jax_items(tree):
    """{key path: leaf} of a reference pytree of dicts."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, tuple))[0]
    return {tuple(k.key for k in path): leaf for path, leaf in flat}


@functools.lru_cache(maxsize=None)
def _trees(name):
    """(port, reference) of: params' axes and shapes, the ring cache's
    axes and shapes, and the paged cache's (None off the paged kinds)."""
    model, jmodel = build_model(get_arch(name)), j_build_model(j_get_arch(name))
    p_abs, p_ax = model.abstract_params()
    jp_abs, jp_ax = jmodel.abstract_params(dtype=jnp.float32)
    out = {"params": ((p_ax, p_abs), (jp_ax, jp_abs)),
           "cache": ((model.cache_axes(), model.abstract_cache(SLOTS, SEQ)),
                     (jmodel.cache_axes(),
                      jmodel.abstract_cache(SLOTS, SEQ, jnp.bfloat16)))}
    if model.cfg.kind in PAGED_KINDS:
        pages = SLOTS * pages_per_slot(SEQ, PAGE) + 1
        out["paged"] = (
            (model.paged_cache_axes(),
             model.abstract_paged_cache(SLOTS, pages, PAGE)),
            (jmodel.paged_cache_axes(),
             jmodel.abstract_paged_cache(SLOTS, pages, PAGE, jnp.bfloat16)))
    return out


def test_every_reference_arch_is_in_the_port():
    assert sorted(J_ARCHS) == ALL_ARCHS and len(ALL_ARCHS) == 10


@pytest.mark.parametrize("tree", ["params", "cache", "paged"])
@pytest.mark.parametrize("name", ALL_ARCHS)
def test_axes_trees_and_abstract_shapes_match(name, tree):
    trees = _trees(name)
    if tree not in trees:
        assert get_arch(name).kind not in PAGED_KINDS
        with pytest.raises(ValueError, match="token-only"):
            build_model(get_arch(name)).paged_cache_axes()
        return
    (ax, ab), (jax_ax, jab) = trees[tree]
    assert ax == jax_ax                      # structure and tuples
    shapes = {p: tuple(x.shape) for p, x in tree_items(ab)}
    jshapes = {p: tuple(x.shape) for p, x in _jax_items(jab).items()}
    assert shapes == jshapes
    assert all(x.device.type == "meta" for _, x in tree_items(ab))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("tree", ["params", "cache", "paged"])
@pytest.mark.parametrize("name", ALL_ARCHS)
def test_leaf_specs_match_the_reference(name, tree, mesh):
    """The spec of every leaf (``serving.sharding._shard_shaped``'s
    inputs) under the serve tables, as the reference resolves it."""
    trees = _trees(name)
    if tree not in trees:
        return
    (ax, ab), (jax_ax, jab) = trees[tree]
    rules, jrules = ((SERVE_PARAM_RULES, J_PARAM_RULES) if tree == "params"
                     else (SERVE_CACHE_RULES, J_CACHE_RULES))
    m, jm = _meshes(mesh)
    specs = dict(tree_items(specs_for(ax, ab, m, rules)))
    jaxes, jabs = _jax_items(jax_ax), _jax_items(jab)
    assert set(specs) == set(jaxes)
    for path, spec in specs.items():
        _same(spec, jrules.spec_for_shape(tuple(jaxes[path]),
                                          tuple(jabs[path].shape), jm))


@pytest.mark.parametrize("name", ["qwen1.5-0.5b", "llama4-scout-17b-a16e",
                                  "mamba2-370m", "recurrentgemma-9b"])
def test_placement_trees_follow_the_specs(name):
    """param_shardings / cache_shardings / paged_cache_shardings are the
    specs' placements, on the host geometry."""
    from torch.distributed.tensor import Replicate, Shard
    model = build_model(get_arch(name))
    m, _ = _meshes("host8")
    trees = _trees(name)
    got = {"params": param_shardings(model, m),
           "cache": cache_shardings(model, m, SLOTS, SEQ),
           "paged": paged_cache_shardings(
               model, m, SLOTS, SLOTS * pages_per_slot(SEQ, PAGE) + 1,
               PAGE)}
    for tree, place in got.items():
        (ax, ab), _ = trees[tree]
        rules = SERVE_PARAM_RULES if tree == "params" else SERVE_CACHE_RULES
        specs = dict(tree_items(specs_for(ax, ab, m, rules)))
        for path, pl in tree_items(place):
            assert len(pl) == 2
            assert all(isinstance(p, (Shard, Replicate)) for p in pl)
            assert spec_of(pl, m) == tuple(
                specs[path][:len(spec_of(pl, m))])


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", ["qwen1.5-0.5b", "mamba2-370m"])
def test_serve_shardings_bundles_the_trees(name, mesh):
    """serve_shardings is the three placement trees and the token,
    logits and control placements, each as resolved on its own; the
    tokens and logits take the reference's specs."""
    import torch
    from torch.distributed.tensor import Replicate
    model = build_model(get_arch(name))
    m, jm = _meshes(mesh)
    pages = SLOTS * pages_per_slot(SEQ, PAGE) + 1
    got = serve_shardings(model, m, slots=SLOTS, max_total=SEQ,
                          page_size=PAGE, cache_pages=pages)
    assert got.params == param_shardings(model, m)
    assert got.cache == cache_shardings(model, m, SLOTS, SEQ,
                                        dtype=torch.float32)
    assert got.paged_cache == paged_cache_shardings(
        model, m, SLOTS, pages, PAGE, dtype=torch.float32)
    assert (got.token, got.logits) == token_placements(model, m, SLOTS)
    repl = (Replicate(),) * len(sh.mesh_axis_names(m))
    assert got.pos == got.page_map == got.live == got.replicated == repl
    V = model.cfg.padded_vocab
    for place, axes, shape in ((got.token, ("cache_batch", None), (SLOTS, 1)),
                               (got.logits, ("cache_batch", None, None),
                                (SLOTS, 1, V))):
        want = J_CACHE_RULES.spec_for_shape(axes, shape, jm)
        assert spec_of(place, m) == tuple(want)[:len(spec_of(place, m))]
        assert spec_of(place, m)            # the slots are sharded


def test_gqa_seq_fallback_on_production_mesh():
    """tests/test_serving_sharded.py's fallback: maverick's 8 KV heads do
    not divide model=16, so the sequence takes 'model'; 16 heads keep
    it."""
    m, jm = _meshes("multipod")
    cfg = get_arch("llama4-maverick-400b-a17b")
    assert cfg.num_kv_heads % 16 != 0
    axes = ("cache_batch", "cache_seq", "cache_kv_heads", "head_dim")
    spec = SERVE_CACHE_RULES.spec_for_shape(
        axes, (16, 2048, cfg.num_kv_heads, cfg.head_dim), m)
    assert spec == ("pod", "model", None, None)     # 16 slots: pod only
    _same(spec, J_CACHE_RULES.spec_for_shape(
        axes, (16, 2048, cfg.num_kv_heads, cfg.head_dim), jm))
    spec2 = SERVE_CACHE_RULES.spec_for_shape(axes, (16, 2048, 16, 64), m)
    assert spec2[2] == "model" and spec2[1] is None
    _same(spec2, J_CACHE_RULES.spec_for_shape(axes, (16, 2048, 16, 64), jm))


# ---------------------------------------------------------------------------
# the rule table
# ---------------------------------------------------------------------------

TABLE = (("batch", ("pod", "data")), ("embed", None), ("heads", "model"),
         ("seq", "model"), ("experts", ("model", "data")))
AXES = [("batch", None, "heads"), ("batch", "seq", "heads", None),
        ("experts", "batch", "embed"), ("seq", "heads"), (None, None),
        ("heads", "experts", "batch")]
SHAPES = [(32, 8, 16), (16, 2048, 8, 128), (128, 32, 64), (2048, 16),
          (4, 4), (16, 128, 6)]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("i", range(len(AXES)))
def test_spec_and_spec_for_shape_match(i, mesh):
    m, jm = _meshes(mesh)
    rules, jrules = sh.ShardingRules(TABLE), jsh.ShardingRules(TABLE)
    _same(rules.spec(AXES[i], m), jrules.spec(AXES[i], jm))
    _same(rules.spec_for_shape(AXES[i], SHAPES[i], m),
          jrules.spec_for_shape(AXES[i], SHAPES[i], jm))


def test_with_overrides_and_errors_match():
    rules, jrules = sh.ShardingRules(TABLE), jsh.ShardingRules(TABLE)
    over = dict(heads=None, seq=("data",), extra="model")
    assert rules.with_overrides(**over).rules == \
        jrules.with_overrides(**over).rules
    assert rules.logical_axes() == jrules.logical_axes()
    for lib in (sh, jsh):
        with pytest.raises(ValueError, match="duplicate rule"):
            lib.ShardingRules((("a", None), ("a", "model")))
        with pytest.raises(KeyError, match="no sharding rule"):
            lib.ShardingRules(TABLE).mesh_axes("nope")
        with pytest.raises(ValueError, match="axis entries"):
            lib.ShardingRules(TABLE).spec_for_shape(("batch",), (4, 4),
                                                    _meshes("host8")[0])


HINTS = [((("pod", "data"), None, "model", None), (16, 8, 16, 64)),
         ((("pod", "data"), None, "model", None), (1, 8, 6, 64)),
         (("data", "model"), (3, 8)),
         ((None, ("model", "data")), (8, 64)),
         ((("pod", "data"), None, None), (64, 1, 1024))]


@pytest.mark.parametrize("drop", [(), ("pod",), ("pod", "data")])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("i", range(len(HINTS)))
def test_resolve_hint_spec_matches_under_drop(i, mesh, drop):
    """With and without shapes, under nested drop_hint_axes (the inner
    context adds to the outer)."""
    dims, shape = HINTS[i]
    m, jm = _meshes(mesh)
    outer, inner = drop[:1], drop[1:]
    with sh.drop_hint_axes(outer), jsh.drop_hint_axes(outer):
        with sh.drop_hint_axes(inner), jsh.drop_hint_axes(inner):
            for shp in (None, shape):
                got = sh.resolve_hint_spec(dims, m, shp)
                want = jsh.resolve_hint_spec(dims, jm, shp)
                assert (got is None) == (want is None), (got, want)
                if got is not None:
                    _same(got, want)
    assert sh._dropped_axes() == frozenset()


# ---------------------------------------------------------------------------
# placements and meshes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [
    (("pod", "data"), None, "model"), (None, "data", None, "model"),
    ("model",), (None, None), (("data", "model"),)])
def test_placements_round_trip(spec):
    from torch.distributed.tensor import Shard
    m, _ = _meshes("multipod")
    pl = sh.placements(spec, m)
    assert len(pl) == 3
    assert spec_of(pl, m) == tuple(spec[:len(spec_of(pl, m))])
    assert all(e is None for e in spec[len(spec_of(pl, m)):])
    for name, p in zip(("pod", "data", "model"), pl):
        owner = [d for d, e in enumerate(spec)
                 if e == name or (isinstance(e, tuple) and name in e)]
        assert (p == Shard(owner[0])) if owner else not isinstance(p, Shard)


def test_placements_refuse_out_of_mesh_order_and_size_one_replicates():
    from torch.distributed.tensor import Replicate, Shard
    m, _ = _meshes("multipod")
    with pytest.raises(AssertionError, match="out of mesh order"):
        sh.placements((("data", "pod"),), m)
    one = sh.AbstractMesh((1, 4), ("data", "model"))
    assert sh.placements(("data", "model"), one) == (Replicate(), Shard(1))


@pytest.mark.parametrize("spec,n,shape", [
    ("host", 4, (1, 4)), ("data", 4, (4, 1)), ("2x2", 4, (2, 2)),
    ("host", 1, (1, 1)), ("1x8", 8, (1, 8))])
def test_serve_mesh_shapes(spec, n, shape):
    assert serve_mesh_shape(spec, n) == shape


@pytest.mark.parametrize("spec,match", [
    ("bad", "expected 'host', 'data', or 'AxB'"),
    ("2x3", "wants 6 devices, have 4")])
def test_serve_mesh_errors(spec, match):
    with pytest.raises(ValueError, match=match):
        serve_mesh_shape(spec, 4)


def test_production_meshes_are_sizes_only():
    pod, multi = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert sh.mesh_axis_sizes(pod) == {"data": 16, "model": 16}
    assert sh.mesh_axis_sizes(multi) == {"pod": 2, "data": 16, "model": 16}
    assert chips_in(pod) == 256 and chips_in(multi) == 512
    assert chips_in(make_production_mesh(multi_pod=True, pods=40)) == 10240


def test_hint_is_a_no_op_off_a_mesh_and_checks_arity():
    import torch
    x = torch.zeros(2, 3)
    assert sh.hint(x, "data", None) is x
    with pytest.raises(ValueError, match="axis entries"):
        sh.hint(x, "data")
    with sh.use_mesh(_meshes("host8")[0]):
        assert sh.hint(x, "data", "model") is x      # a plain tensor
    assert sh.ambient_mesh() is None
    np.testing.assert_array_equal(x.numpy(), 0)
