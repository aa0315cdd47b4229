"""The port's dry run (``repro_torch.launch.cost``, ``analysis`` and
``dryrun``) against the reference's (``repro.launch.hlo_cost``,
``analysis`` and ``dryrun``).

* The cost counter on the known workloads of ``tests/test_hlo_cost.py``:
  one matmul, a loop of 12, a nested loop, gradients counted, bytes
  nonzero and bounded; the memory fields of an in-place update.
* A reduced qwen's forward and forward-and-backward FLOPs equal the
  reference's ``analyze_hlo`` dot FLOPs of its jitted unsharded loss and
  value-and-grad (``remat=False``).
* On a (16, 16) fake mesh (a ``"fake"`` process group of 256 ranks, one
  per module, destroyed after it) a ``(64, 896) @ (896, 4864)`` product
  with rows over ``data`` and columns over ``model`` counts the rank's
  2,179,072 FLOPs, not the global 557,842,432, and a gather of its
  result counts its all-gathers; a reduced train step and the paged
  serving pair trace to "ok" records.
* Each kernel wrapper on fake tensors charges its formula, launches
  nothing and returns the right shape.
* ``SKIPS`` and ``MESH_PODS`` equal the reference's; the H100 roofline's
  terms; the CLI in a subprocess prints one record with the reference's
  keys as its last line, and refuses ``--donation-check``.
"""
import _torch_threads  # noqa: F401  (torch threads per xdist worker)

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.launch import analysis as janalysis
from repro.launch.hlo_cost import analyze_hlo
from repro.models import build_model as j_build_model
from repro_torch.configs import InputShape, get_arch
from repro_torch.launch import analysis, dryrun
from repro_torch.launch.cost import COLLECTIVES, CostMode, measure
from repro_torch.models import build_model
from repro_torch.models.common import params_from_jax, tree_leaves

ROOT = Path(__file__).resolve().parents[1]


def _flops(fn, *args) -> float:
    return measure(fn, *args)[1].flops


# ---------------------------------------------------------------------------
# the counter on known workloads
# ---------------------------------------------------------------------------

def test_single_matmul_flops():
    x, w = torch.ones((64, 128)), torch.ones((128, 32))
    assert _flops(lambda a, b: a @ b, x, w) == 2 * 64 * 128 * 32


def test_loop_of_twelve():
    def f(x, ws):
        for w in ws:
            x = torch.tanh(x @ w)
        return x
    x, ws = torch.ones((128, 128)), torch.ones((12, 128, 128))
    assert _flops(f, x, ws) == 12 * 2 * 128 ** 3


def test_nested_loop():
    def f(x, ws):
        for w in ws:
            for _ in range(5):
                x = torch.tanh(x @ w)
        return x
    x, ws = torch.ones((64, 64)), torch.ones((4, 64, 64))
    assert _flops(f, x, ws) == 20 * 2 * 64 ** 3


def test_gradients_are_counted():
    def f(x, ws):
        for w in ws:
            x = torch.tanh(x @ w)
        return x.sum()

    def grad(x, ws):
        ws = ws.clone().requires_grad_(True)
        return torch.autograd.grad(f(x, ws), ws)[0]
    x, ws = torch.full((64, 64), 0.01), torch.full((6, 64, 64), 0.01)
    # forward 6, backward 6 dW and 5 dx (the input takes no gradient);
    # the reference's XLA program does 18 (its test allows 5 %)
    assert _flops(grad, x, ws) == 17 * 2 * 64 ** 3


def test_bytes_nonzero_and_bounded():
    x, w = torch.ones((256, 256)), torch.ones((256, 256))
    _, rec = measure(lambda a, b: torch.tanh(a @ b), x, w)
    lo = 3 * 256 * 256 * 4            # read x, w; write out
    assert lo <= rec.bytes <= 12 * lo
    assert rec.arg_bytes == 2 * 256 * 256 * 4
    assert rec.out_bytes == 256 * 256 * 4 and rec.alias_bytes == 0
    assert rec.peak_bytes >= rec.arg_bytes + rec.out_bytes


def test_in_place_update_is_an_alias():
    p = torch.zeros((1000,))
    _, rec = measure(lambda t: t.add_(1.0), p)
    assert rec.alias_bytes == rec.out_bytes == rec.arg_bytes == 4000
    assert rec.temp_bytes == 0
    _, rec = measure(lambda t: t + 1.0, p)
    assert rec.alias_bytes == 0 and rec.out_bytes == 4000


# ---------------------------------------------------------------------------
# the reduced qwen against the reference's HLO walker
# ---------------------------------------------------------------------------

def _reduced_qwen(get):
    """2 layers, d 128, 4 heads of qwen's 64 over 2 KV heads, d_ff 256,
    vocabulary 512."""
    cfg = get("qwen1.5-0.5b").reduced(num_layers=2, d_model=128, d_ff=256,
                                      vocab_size=512)
    return dataclasses.replace(cfg, num_kv_heads=2, head_dim=64)


def test_reduced_qwen_flops_equal_the_reference_hlo_walk():
    jcfg, cfg = _reduced_qwen(j_get_arch), _reduced_qwen(get_arch)
    jmodel, model = j_build_model(jcfg), build_model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0), jnp.float32)
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(0, cfg.vocab_size, size=(2, 64)).astype(
        np.int32) for k in ("tokens", "labels")}

    def hlo_flops(fn):
        return analyze_hlo(jax.jit(fn).lower(jparams, batch).compile()
                           .as_text()).flops

    def jloss(p, b):
        return jmodel.loss(p, b, dtype=jnp.float32, remat=False)
    want_f = hlo_flops(jloss)
    want_fb = hlo_flops(jax.value_and_grad(jloss))

    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}

    def loss(p):
        return model.loss(p, tb, dtype=torch.float32)

    def loss_and_backward(p):
        for v in tree_leaves(p):
            v.requires_grad_(True)
        out = loss(p)
        out.backward()
        return out

    assert _flops(loss, params) == want_f == 134_217_728
    assert _flops(loss_and_backward, params) == want_fb == 402_653_184


# ---------------------------------------------------------------------------
# DTensors on a fake 256-rank process group
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pod_mesh():
    import torch.distributed as dist
    try:
        yield dryrun.production_mesh("pod")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_sharded_product_counts_the_rank_share(pod_mesh):
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.launch.steps import Program
    a = torch.empty((64, 896), device="meta")
    b = torch.empty((896, 4864), device="meta")
    rows = (Shard(0), Replicate())
    cols = (Replicate(), Shard(1))
    fn = Program(lambda x, y: x @ y, pod_mesh, (rows, cols))
    rec, _, _ = dryrun.trace(fn, (a, b))
    assert rec.flops == 2 * 4 * 896 * 304 == 2_179_072
    assert rec.flops * 256 == 2 * 64 * 896 * 4864 == 557_842_432
    assert rec.coll_total == 0
    gather = Program(lambda x, y: (x @ y).full_tensor(), pod_mesh,
                     (rows, cols))
    rec, _, _ = dryrun.trace(gather, (a, b))
    assert rec.flops == 2_179_072
    assert rec.coll_counts["all-gather"] == 2
    assert rec.coll_bytes["all-gather"] > 0
    assert sum(rec.coll_counts[k] for k in COLLECTIVES
               if k != "all-gather") == 0


def test_reduced_train_step_and_paged_serving_trace(pod_mesh):
    from repro_torch.launch.steps import build_paged_serve_program
    cfg = get_arch("qwen1.5-0.5b").reduced(d_model=256, vocab_size=512)
    model = build_model(cfg)
    import repro_torch.launch.steps as steps
    fn, args = steps.build_program(model, InputShape("train_4k", 64, 256,
                                                     "train"), pod_mesh)
    rec, _, _ = dryrun.trace(fn, args)
    assert rec.flops > 0 and rec.bytes > 0 and rec.ops > 0
    # FSDP weights over data and the vocab-parallel loss move data
    assert rec.coll_counts["all-gather"] > 0
    assert rec.coll_counts["all-reduce"] > 0
    # the params are updated in place: every param's shard is an alias
    local = sum(t.to_local().numel() * 4 for t in tree_leaves(
        dryrun.fake_args(args[0], fn.in_placements[0], pod_mesh,
                         torch._subclasses.fake_tensor.FakeTensorMode())))
    assert rec.alias_bytes >= local
    pair = build_paged_serve_program(model, pod_mesh, slots=16,
                                     max_prompt=64, max_total=128,
                                     page_size=16)
    rec, _, _ = dryrun.trace(*pair["decode"])
    assert rec.kernels["paged_decode"]["calls"] == cfg.num_layers
    rec, _, _ = dryrun.trace(*pair["admission_chunk"])
    assert rec.flops > 0 and "paged_decode" not in rec.kernels


def test_pod_train_step_counts_a_rank_share_of_the_model_flops(pod_mesh):
    # qwen at full width, cut to 2 layers: every projection is tensor
    # parallel, so a rank's FLOPs are 6 N D over the chips plus the
    # rectangular flash sweep (2 products forward, 5 backward, of
    # 2 T^2 H hd each), whatever strategy DTensor would pick
    import repro_torch.launch.steps as steps
    from repro_torch.configs import get_shape
    cfg = dataclasses.replace(get_arch("qwen1.5-0.5b"), num_layers=2)
    shape = get_shape("train_4k")
    fn, args = steps.build_program(build_model(cfg), shape, pod_mesh)
    rec, _, _ = dryrun.trace(fn, args)
    T, hd = shape.seq_len, cfg.num_heads * cfg.head_dim
    attn = 7 * 2 * T * T * hd * cfg.num_layers * shape.global_batch
    want = (analysis.model_flops_for(cfg, shape) + attn) / 256
    assert 0.99 < rec.flops / want < 1.01, rec.flops / want


def test_run_one_and_serve_records(pod_mesh):
    rec = dryrun.run_one("qwen1.5-0.5b", "decode_32k", "pod",
                         verbose=False, mesh=pod_mesh)
    assert rec["status"] == "ok" and rec["chips"] == 256
    assert rec["dominant"] in ("compute", "memory", "collective")
    assert rec["flops_dev"] > 0
    assert set(_reference_record_keys()) - {"sync", "tau"} <= set(rec)
    with pytest.raises(ValueError, match="donation"):
        dryrun.run_one("qwen1.5-0.5b", "train_4k", "pod", sync="tthf-fused",
                       donation_check=True, mesh=pod_mesh)
    skipped = dryrun.run_one("whisper-small", "long_500k", "pod",
                             mesh=pod_mesh)
    assert skipped["status"] == "skipped"


# ---------------------------------------------------------------------------
# the kernels on fake tensors
# ---------------------------------------------------------------------------

def test_kernel_wrappers_on_fake_tensors_charge_their_formulas():
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels.fused_consensus_sgd import fused_consensus_sgd
    from repro_torch.kernels.paged_decode import paged_decode
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_heads, ssd_work
    fm = FakeTensorMode()
    with fm:
        w = torch.empty((2, 4, 1000))
        g = torch.empty((2, 4, 1000))
        W = torch.empty((2, 4, 4))
        q = torch.empty((8, 2, 3, 64))
        pool = torch.empty((33, 16, 2, 64), dtype=torch.bfloat16)
        page_map = torch.empty((8, 4), dtype=torch.int32)
        pos = torch.empty((8,), dtype=torch.int32)
        x = torch.empty((2, 300, 4, 32))
        dt = torch.empty((2, 300, 4))
        BC = torch.empty((2, 300, 16))
    launches = (fused_consensus_sgd.launches, paged_decode.launches,
                ssd_scan.launches)
    with fm, CostMode(fm) as mode:
        out = fused_consensus_sgd(w, g, W, 0.1)
        att = paged_decode(q, pool, pool, page_map, pos, window=16)
        y, h = ssd_scan_heads(x, dt, dt, BC, BC, chunk=128)
        y2, h2 = ssd_scan(x.permute(0, 2, 1, 3).reshape(8, 300, 32),
                          dt.permute(0, 2, 1).reshape(8, 300),
                          dt.permute(0, 2, 1).reshape(8, 300), BC, BC,
                          heads_per_group=4, chunk=128)
    assert (fused_consensus_sgd.launches, paged_decode.launches,
            ssd_scan.launches) == launches
    assert tuple(out.shape) == (2, 4, 1000) and out.dtype == w.dtype
    assert tuple(att.shape) == (8, 2, 3, 64) and att.dtype == torch.float32
    assert tuple(y.shape) == (2, 300, 4, 32) and tuple(h.shape) == (
        2, 4, 16, 32)
    assert tuple(y2.shape) == (8, 300, 32) and tuple(h2.shape) == (8, 16, 32)
    k = mode.record.kernels
    assert k["fused_consensus_sgd"] == {
        "calls": 1, "flops": 2 * 2 * 4 * 4 * 1000,
        "bytes": 3 * 2 * 4 * 1000 * 4 + 2 * 4 * 4 * 4}
    span = 4 * 16
    assert k["paged_decode"] == {
        "calls": 1, "flops": 4 * 8 * 2 * 3 * span * 64,
        "bytes": 2 * 8 * span * 2 * 64 * 2
        + 4 * (2 * 8 * 2 * 3 * 64 + 8 * 4 + 8)}
    work = ssd_work(2, 4, 300, 32, 16, 128)
    io = 4 * (2 * 2 * 300 * 4 * 32 + 2 * 2 * 300 * 4 + 2 * 2 * 300 * 16
              + 2 * 4 * 16 * 32)
    assert k["ssd_scan"] == {"calls": 2, "flops": 2 * work, "bytes": 2 * io}
    # a chunk of a few hundred positions: G's causal half, M X, carries
    nc = 3
    assert work == (2 * nc * 128 * 129 * 16
                    + 8 * (nc * (128 * 129 * 32 + 2 * 128 * 16 * 32)
                           + (nc - 1) * 2 * 128 * 16 * 32))


# ---------------------------------------------------------------------------
# tables, roofline, CLI
# ---------------------------------------------------------------------------

def test_tables_equal_the_reference():
    import repro.launch.dryrun as jdryrun
    assert dryrun.SKIPS == jdryrun.SKIPS
    assert dryrun.MESH_PODS == jdryrun.MESH_PODS
    assert analysis.COLLECTIVE_OPS == janalysis.COLLECTIVE_OPS == COLLECTIVES


def _reference_record_keys() -> list:
    f = {fld.name: 1.0 for fld in dataclasses.fields(janalysis.Roofline)}
    f.update(arch="a", shape="s", mesh="m", chips=1, coll_breakdown={})
    keys = list(janalysis.Roofline(**f).to_dict())
    return keys + ["status", "lower_s", "compile_s", "arg_bytes",
                   "out_bytes", "temp_bytes", "alias_bytes", "sync", "tau"]


def test_roofline_terms_on_h100_constants():
    from repro_torch.launch.cost import CostRecord
    rec = CostRecord(flops=989e12, bytes=3.35e12 * 2)
    rec.coll_bytes["all-reduce"] = 50e9 * 0.5
    rec.coll_counts["all-reduce"] = 3
    roof = analysis.analyze(rec, arch="a", shape=InputShape("s", 1, 1,
                                                            "train"),
                            mesh_name="pod", chips=256,
                            model_flops_total=256 * 1e12)
    assert roof.compute_s == 1.0 and roof.memory_s == 2.0
    assert roof.collective_s == 0.5 and roof.dominant == "memory"
    d = roof.to_dict()
    assert d["roofline_fraction"] == 0.5 and d["model_flops"] == 1e12
    assert d["coll_breakdown"]["counts"] == {"all-reduce": 3}
    coll = analysis.collective_bytes(rec)
    assert coll["all-reduce"] == 25e9 and coll["_counts"]["all-reduce"] == 3
    assert set(d) == set(_reference_record_keys()[:-9])


_CLI = """
import sys
import repro_torch.configs as c
c.ARCHS["qwen1.5-0.5b"] = c.ARCHS["qwen1.5-0.5b"].reduced(
    d_model=128, vocab_size=512)
from repro_torch.launch.dryrun import main
sys.exit(main(sys.argv[1:]))
"""


def _cli(*argv):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("JAX_PLATFORMS", None)
    return subprocess.run([sys.executable, "-c", _CLI, *argv], env=env,
                          capture_output=True, text=True, timeout=300)


def test_cli_prints_one_record_with_the_reference_keys():
    out = _cli("--arch", "qwen1.5-0.5b", "--shape", "decode_32k", "--mesh",
               "multipod", "--out", "-")
    assert out.returncode == 0, out.stderr[-3000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["status"] == "ok" and rec["chips"] == 512
    assert set(_reference_record_keys()) <= set(rec)
    out = _cli("--serve", "--paged", "--arch", "qwen1.5-0.5b", "--slots",
               "16", "--max-prompt", "64", "--max-total", "128",
               "--page-size", "16", "--out", "-")
    assert out.returncode == 0, out.stderr[-3000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["status"] == "ok" and rec["chips"] == 256 and rec["paged"]
    assert sorted(rec["programs"]) == ["admission_chunk", "decode"]
    assert rec["flops_dev"] > 0
    assert rec["dominant"] in ("compute", "memory", "collective")
    out = _cli("--arch", "qwen1.5-0.5b", "--shape", "train_4k", "--sync",
               "tthf-fused-interval", "--tau", "4", "--consensus-every",
               "2", "--out", "-")
    assert out.returncode == 0, out.stderr[-3000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["status"] == "ok" and rec["sync"] == "tthf-fused-interval"
    assert rec["tau"] == 4
    # the interval was traced: one fused block end every 2 of 4 steps,
    # rows moved to columns and back over the replica axes
    calls = rec["coll_breakdown"]["kernels"]["fused_consensus_sgd"]["calls"]
    assert calls == 4 // 2
    assert rec["coll_breakdown"]["counts"]["all-to-all"] > 0
    out = _cli("--arch", "qwen1.5-0.5b", "--shape", "train_4k", "--sync",
               "tthf-fused", "--donation-check")
    assert out.returncode == 2 and "donation" in out.stderr
