"""Sharded serving in the port (``--mesh``, ``--host-devices``): a run on
a mesh gives what the unsharded port gives, which the other serving
tests hold to the reference — bitwise tokens for data parallelism,
logits within 1e-4 of max |logit| for tensor parallelism (the
reference's own claims, tests/test_serving_sharded.py).

* In this process, a (1, 1) gloo mesh of one rank: the wave,
  continuous and paged schedulers on reduced qwen and mamba2 give the
  unsharded run's tokens, bitwise.
* One spawned group of 4 gloo ranks (``launch.serve.run_on_host_devices``,
  what ``--host-devices 4`` runs; this file's ``__main__``), under a hard
  timeout: ``--mesh data`` with the continuous and paged schedulers on
  reduced qwen, llama4-scout and mamba2 (tokens bitwise); gemma-2b's
  one KV head on ``2x2``, whose ring cache falls back to the sequence
  over ``model`` (the unsharded tokens); ``--mesh
  host`` (1 x 4) and ``2x2`` direct, teacher-forced (logits within 1e-4
  of the one-rank run, and for 2x2 of the reference's unsharded logits
  with the reference's weights carried over); a ``CommDebugMode`` count
  of one tensor-parallel decode step, in which no collective moves a
  parameter or a whole cache leaf.
* The serve CLI with ``--host-devices 4`` prints the one-rank CLI's
  counts; ``--host-devices`` without ``--device cpu`` raises.
"""
import _torch_threads  # noqa: F401  (torch threads per xdist worker)
import argparse
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.launch import serve as serve_cli
from repro_torch.models import build_model

ROOT = Path(__file__).resolve().parents[1]
QWEN, SCOUT, MAMBA = "qwen1.5-0.5b", "llama4-scout-17b-a16e", "mamba2-370m"
GEMMA = "gemma-2b"
TOL = 1e-4
RANKS = 4


def _args(arch, scheduler, **kw):
    base = serve_cli.parse_args(
        ["--arch", arch, "--reduced", "--scheduler", scheduler,
         "--device", "cpu", "--temperature", "0", "--batch", "4",
         "--prompt-len", "16", "--gen", "6", "--requests", "6",
         "--page-size", "8"])
    return argparse.Namespace(**{**vars(base), **kw})


def _tokens(args, mesh=None, sched=None):
    """Every request's generated tokens from the scheduler trace (and the
    scheduler into ``sched``, a list, when given)."""
    cfg = get_arch(args.arch).reduced()
    s, _, arrivals, _ = serve_cli.run_scheduler_trace(
        args, cfg, build_model(cfg), torch.device("cpu"), mesh=mesh)
    if sched is not None:
        sched.append(s)
    return [np.asarray(r.out_tokens) for _, r in arrivals]


def _forced(cfg, args):
    return np.random.default_rng(7).integers(
        1, cfg.vocab_size, size=(args.batch, args.gen)).astype(np.int32)


def _direct_args():
    return _args(QWEN, "direct", gen=3)


def _direct_logits(args, mesh=None, params=None):
    """The direct path's kept logits (B, gen + 1, V), teacher-forced."""
    cfg = get_arch(args.arch).reduced()
    model = build_model(cfg)
    if params is not None and mesh is not None:
        from repro_torch.serving import shard_params
        params = shard_params(params, model, mesh)
    run = serve_cli.run_direct(args, cfg, model, torch.device("cpu"),
                               params, mesh=mesh, keep_logits=True,
                               forced=_forced(cfg, args))
    return run["logits"].numpy()


# scheduler cases of the spawned group: (name, mesh, arch, scheduler)
DP_CASES = [(f"{arch}-{sched}", "data", arch, sched)
            for arch in (QWEN, SCOUT, MAMBA)
            for sched in ("continuous", "paged")]
DIRECT_CASES = [("host", "host"), ("2x2", "2x2")]


# ---------------------------------------------------------------------------
# the spawned group (runs in each of the 4 ranks)
# ---------------------------------------------------------------------------

def _comm_sizes(mesh, args):
    """The collectives of one tensor-parallel decode step of reduced
    qwen on ``mesh``: (the elements of each collective's largest tensor,
    CommDebugMode's count, the elements of the smallest weight matrix
    and cache leaf of one layer on a rank)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.distributed.tensor.debug._comm_mode import (
        c10d_collective_ops)
    from torch.utils import _pytree

    from repro_torch.dist.sharding import local, use_mesh
    from repro_torch.models.common import tree_items
    from repro_torch.serving import shard_params

    class Sizes(CommDebugMode):
        def __init__(self):
            super().__init__()
            self.sizes = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if (not isinstance(func, torch._ops.HigherOrderOperator)
                    and DTensor not in types
                    and (func._overloadpacket in self.comm_registry
                         or func._overloadpacket in c10d_collective_ops)):
                self.sizes.append(max(
                    t.numel() for t in _pytree.tree_leaves((args, kwargs))
                    if isinstance(t, torch.Tensor)))
            return super().__torch_dispatch__(func, types, args, kwargs)

    cfg = get_arch(QWEN).reduced()
    model = build_model(cfg)
    params = shard_params(serve_cli.init_params(model, args, "cpu"), model,
                          mesh)
    toks = torch.ones((args.batch, args.prompt_len), dtype=torch.int64)
    with use_mesh(mesh):
        _, cache, pos = model.prefill(params, {"tokens": toks},
                                      dtype=torch.float32,
                                      cache_dtype=torch.float32,
                                      cache_len=args.prompt_len + 4)
        tok = torch.ones((args.batch, 1), dtype=torch.int64)
        comm = Sizes()
        with comm:
            model.decode_step(params, tok, cache, pos, dtype=torch.float32)
    per_layer = []
    for path, x in tree_items(params) + tree_items(cache):
        x = local(x)
        if path[0] == "layers" and x.ndim >= 3:      # one layer's matrix
            per_layer.append(x[0].numel())
        elif path[0] != "layers" and x.ndim >= 2:    # the embedding
            per_layer.append(x.numel())
    return comm.sizes, comm.get_total_counts(), min(per_layer)


def _group(out: str, carried: str) -> None:
    """Every sharded case, in one process group of RANKS gloo ranks;
    rank 0 saves the results to ``out``."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_serve_mesh

    res = {}
    meshes = {m: make_serve_mesh(m, "cpu") for m in ("data", "host", "2x2")}
    for name, m, arch, sched in DP_CASES:
        for i, t in enumerate(_tokens(_args(arch, sched), meshes[m])):
            res[f"tok/{name}/{i}"] = t
    # gemma's one KV head does not divide model=2: the ring cache's
    # sequence takes the model axis, and the decode combines the
    # softmax over it
    sched = []
    for i, t in enumerate(_tokens(_args(GEMMA, "continuous"),
                                  meshes["2x2"], sched)):
        res[f"tok/seq/{i}"] = t
    k = sched[0]._cache["layers"]["k"]
    res["seq/placements"] = np.asarray([str(p) for p in k.placements])
    # the caches' placements under the serve table and under overrides
    from repro_torch.serving import SERVE_CACHE_RULES
    model = build_model(get_arch(QWEN).reduced())
    for key, over in (("default", {}), ("override", {
            "cache_batch": None, "cache_kv_heads": None})):
        rules = SERVE_CACHE_RULES.with_overrides(**over)
        ring = model.init_cache(4, 16, torch.float32, mesh=meshes["2x2"],
                                cache_rules=rules)
        paged = model.init_paged_cache(4, 9, 8, torch.float32,
                                       mesh=meshes["2x2"], cache_rules=rules)
        for tree, c in (("ring", ring), ("paged", paged)):
            res[f"rules/{tree}/{key}"] = np.asarray(
                [str(p) for p in c["layers"]["k"].placements])
    for name, m in DIRECT_CASES:
        res[f"logits/{name}"] = _direct_logits(_direct_args(),
                                               meshes[m])
    from repro_torch.models import params_from_jax
    flat = dict(np.load(carried))
    tree: dict = {}
    for key, v in flat.items():
        node = tree
        *head, last = key.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    res["logits/carried"] = _direct_logits(
        _direct_args(), meshes["2x2"], params_from_jax(tree, "cpu"))
    sizes, counts, smallest = _comm_sizes(meshes["host"],
                                          _direct_args())
    res["comm/sizes"] = np.asarray(sizes, np.int64)
    res["comm/total"] = np.asarray(counts)
    res["comm/smallest"] = np.asarray(smallest)
    if dist.get_rank() == 0:
        np.savez(out, **res)


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """Run the 4-rank group once (hard timeout) and load its results;
    also the reference's weights it carries and its unsharded logits."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_arch as j_get_arch
    from repro.models import build_model as j_build_model

    d = tmp_path_factory.mktemp("group")
    args = _direct_args()
    jcfg = j_get_arch(QWEN).reduced()
    jmodel = j_build_model(jcfg)
    jp = jmodel.init(jax.random.PRNGKey(3))
    np.savez(d / "carried.npz", **_flatten(jax.tree.map(np.asarray, jp)))
    # the reference's unsharded direct path, teacher-forced
    batch = serve_cli.direct_batch(get_arch(QWEN).reduced(), args.batch,
                                   args.prompt_len, args.seed)
    forced = _forced(jcfg, args)
    total = args.prompt_len + args.gen
    lg, cache, pos = jmodel.prefill(
        jp, {"tokens": jnp.asarray(batch["tokens"])}, dtype=jnp.float32,
        cache_dtype=jnp.float32, cache_len=total)
    ref = [np.asarray(lg)]
    for i in range(args.gen):
        lg, cache = jmodel.decode_step(jp, jnp.asarray(forced[:, i:i + 1]),
                                       cache, pos, dtype=jnp.float32)
        ref.append(np.asarray(lg))
        pos = pos + 1
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join(
               [str(ROOT / "src"), str(ROOT / "tests"),
                os.environ.get("PYTHONPATH", "")])}
    proc = subprocess.run(
        [sys.executable, str(Path(__file__)), str(d / "out.npz"),
         str(d / "carried.npz")], env=env, capture_output=True, text=True,
        timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = dict(np.load(d / "out.npz"))
    out["ref/carried"] = np.concatenate(ref, axis=1)
    return out


@pytest.mark.parametrize("name,mesh,arch,sched", DP_CASES,
                         ids=[c[0] for c in DP_CASES])
def test_data_parallel_tokens_are_bitwise(group, name, mesh, arch, sched):
    want = _tokens(_args(arch, sched))
    got = [group[f"tok/{name}/{i}"] for i in range(len(want))]
    assert all(len(w) > 0 for w in want)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


def test_seq_fallback_ring_decode_tokens(group):
    """gemma-2b on 2 x 2: its ring cache shards the sequence over
    ``model`` (the fallback), and the tokens are the unsharded run's."""
    # (layers, slots, seq, heads, hd): slots over data, seq over model
    assert list(group["seq/placements"]) == ["S(1)", "S(2)"]
    want = _tokens(_args(GEMMA, "continuous"))
    for i, w in enumerate(want):
        np.testing.assert_array_equal(group[f"tok/seq/{i}"], w)


@pytest.mark.parametrize("tree,key,want", [
    ("ring", "default", ["S(1)", "S(3)"]),
    ("ring", "override", ["R", "S(2)"]),
    ("paged", "default", ["R", "S(3)"]),
    ("paged", "override", ["R", "R"])])
def test_cache_rules_place_the_caches(group, tree, key, want):
    """init_cache / init_paged_cache on 2 x 2 place each leaf by the
    cache rules they are given: by default the slots over ``data`` and
    the KV heads over ``model``; without those two rules the ring's
    sequence takes ``model`` (its fallback) and the page pools
    replicate."""
    assert list(group[f"rules/{tree}/{key}"]) == want


@pytest.mark.parametrize("name,mesh", DIRECT_CASES,
                         ids=[c[0] for c in DIRECT_CASES])
def test_tensor_parallel_direct_logits(group, name, mesh):
    want = _direct_logits(_direct_args())
    got = group[f"logits/{name}"]
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


def test_sharded_logits_match_the_reference_unsharded(group):
    """2x2 (data x model) over the reference's weights, teacher-forced,
    against the reference's unsharded prefill and decode steps."""
    got, want = group["logits/carried"], group["ref/carried"]
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


def test_tensor_parallel_decode_moves_no_parameter_or_cache_leaf(group):
    """Every collective of the step is smaller than one layer's smallest
    weight matrix or cache leaf on a rank: only activations move (the
    (B, 1, d) partial sums and the logits)."""
    sizes, smallest = group["comm/sizes"], int(group["comm/smallest"])
    assert int(group["comm/total"]) == len(sizes) > 0
    assert sizes.max() < smallest, (sizes.tolist(), smallest)


# ---------------------------------------------------------------------------
# in this process: a (1, 1) mesh of one rank
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def one_rank_mesh():
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_serve_mesh
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield make_serve_mesh("host", "cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch,sched", [
    (QWEN, "wave"), (QWEN, "continuous"), (QWEN, "paged"),
    (MAMBA, "continuous")])
def test_one_rank_mesh_tokens_are_bitwise(one_rank_mesh, arch, sched):
    args = _args(arch, sched)
    want = _tokens(args)
    got = _tokens(args, one_rank_mesh)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# the serve CLI
# ---------------------------------------------------------------------------

def _cli(*argv):
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join(
               [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")])}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *CLI, *argv],
        env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc.stdout.splitlines()


CLI = ["--reduced", "--device", "cpu", "--temperature", "0", "--requests",
       "5", "--gen", "6", "--prompt-len", "32"]


@pytest.mark.parametrize("sched,mesh", [("continuous", "data"),
                                        ("paged", "2x2")])
def test_cli_host_devices_prints_the_one_rank_counts(sched, mesh, capsys):
    lines = _cli("--scheduler", sched, "--host-devices", str(RANKS),
                 "--mesh", mesh)
    assert serve_cli.main([*CLI, "--scheduler", sched]) == 0
    one = capsys.readouterr().out.splitlines()
    assert lines[0] == one[0].replace("devices=1", f"devices={RANKS}")
    counts = [ln.split(" (")[0] for ln in (lines[1], one[1])]
    assert counts[0] == counts[1]
    assert lines[2:] == one[2:]


def test_cli_host_devices_needs_the_cpu():
    with pytest.raises(ValueError, match="--device cpu"):
        serve_cli.main(["--reduced", "--host-devices", "2", "--mesh",
                        "data"])


if __name__ == "__main__":
    serve_cli.run_on_host_devices(RANKS, _group, sys.argv[1], sys.argv[2])
