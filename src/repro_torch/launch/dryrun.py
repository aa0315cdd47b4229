"""Sizes-only dry run on the production meshes — the port of
``repro/launch/dryrun.py``: trace one (arch x input shape) program as one
rank of a 256-, 512- or 10,240-rank mesh, and print its per-rank cost,
memory and roofline terms.

Usage:
  python -m repro_torch.launch.dryrun --arch gemma-2b --shape train_4k --mesh pod
  python -m repro_torch.launch.dryrun --all --mesh pod --out runs/dryrun
  python -m repro_torch.launch.dryrun --all --mesh multipod   # 2x16x16
  python -m repro_torch.launch.dryrun --serve --paged \\
      --arch qwen1.5-0.5b --mesh pod --out -   # the paged serving pair

What takes the place of XLA's lower + compile: ``main`` starts a
``"fake"`` process group of 256, 512 or 10,240 ranks (no communication,
in one process) and builds the production mesh on it
(``launch/mesh.py::make_production_mesh``'s geometry). Parameters,
caches and batches are DTensors whose local shards are fake tensors
(shapes and dtypes, no data): nothing is placed on a card and no
arithmetic runs. The program (``launch/steps.py``) then runs once as
rank 0 under :class:`repro_torch.launch.cost.CostMode`, which counts the
local ops that rank runs — matmul FLOPs, bytes, the collectives DTensor
issues, and the storages live at the peak — and
:mod:`repro_torch.launch.analysis` turns the count into H100 roofline
terms. The numbers are per-rank estimates of what one rank would run;
no time of such a mesh is measured. The kernels on a program's path
(``paged_decode`` in the paged decode, ``ssd_scan`` in the ssm kind's
prefill) charge their bound formulas on fake tensors. ``lower_s`` is the
time to build the program and its fake inputs, ``compile_s`` the traced
run's: the reference's keys, with no compile behind them.

The train step and the TT-HF interval run with ``remat`` on, as the
reference's programs do: the count holds each layer's recompute in the
backward, and the peak the storages live without the activations the
recompute rebuilds.

``--sync`` traces one TT-HF interval instead of the train step
(:func:`build_tthf_program`). The interval program is donated: its
result lands in the parameter input's buffers (the record's
``alias_bytes``), the counterpart of XLA's buffer donation.
``--donation-check`` traces it a second time undonated (a copy of the
parameter input takes the in-place microsteps, the result comes back in
new buffers) and reports the live argument-plus-output bytes of both
(``rec["donation"]``, the reference's keys, and its ``donation:``
line).

Each combo can run in a fresh interpreter (``--subprocess``). Importing
this module starts nothing; ``main`` owns the process group.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import traceback

# (arch, shape) combos that are intentionally skipped, with reasons
SKIPS: dict[tuple[str, str], str] = {
    ("whisper-small", "long_500k"):
        "encoder-decoder ASR: 524k-token decode is not meaningful for a "
        "1500-frame/448-token enc-dec model (DESIGN.md §6).",
}

# pods per multi-pod mesh variant (absent key = single pod)
MESH_PODS = {"multipod": 2, "multipod10k": 40}

def start_fake_world(ranks: int) -> None:
    """A ``"fake"`` process group of ``ranks`` ranks, this process rank
    0: collectives return at once and move nothing."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() != ranks:
            raise RuntimeError(
                f"a process group of {dist.get_world_size()} ranks is "
                f"running; the dry run needs {ranks}")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=ranks)


def production_mesh(mesh_name: str):
    """The production geometry as a ``DeviceMesh`` on the fake group."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.launch.mesh import make_production_mesh
    geo = make_production_mesh(multi_pod=mesh_name in MESH_PODS,
                               pods=MESH_PODS.get(mesh_name, 2))
    start_fake_world(geo.size)
    return init_device_mesh("cpu", geo.axis_sizes,
                            mesh_dim_names=geo.axis_names)


def fake_args(args, in_placements, mesh, fake_mode):
    """The abstract (``meta``) arguments as DTensors on ``mesh`` whose
    local shards are fake tensors of this rank's shape; host values and
    arguments without placements pass through."""
    import torch
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    from repro_torch.launch.steps import _is_placements

    def one(x, where):
        if where is None or not isinstance(x, torch.Tensor):
            return x
        shape = tuple(x.shape)
        local, _ = compute_local_shape_and_global_offset(
            shape, mesh, list(where))
        with fake_mode:
            t = torch.empty(local, dtype=x.dtype, device=mesh.device_type)
        stride = torch.empty(shape, device="meta").stride()
        return DTensor.from_local(t, mesh, list(where), run_check=False,
                                  shape=shape, stride=stride)

    def walk(x, where):
        if isinstance(x, dict):
            return {k: walk(v, where[k] if where is not None else None)
                    for k, v in x.items()}
        if isinstance(x, (tuple, list)) and not _is_placements(where):
            ws = where if where is not None else (None,) * len(x)
            return type(x)(walk(v, w) for v, w in zip(x, ws))
        return one(x, where)

    return walk(args, in_placements)


def trace(fn, args):
    """Run the program ``fn`` once on fake ``args`` (meta) placed by its
    ``in_placements``; returns ``(record, seconds to place, seconds to
    run)``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch.cost import measure
    t0 = time.time()
    fm = FakeTensorMode(allow_non_fake_inputs=True)
    fargs = fake_args(args, fn.in_placements, fn.mesh, fm)
    t1 = time.time()
    with fm:
        _, rec = measure(fn, *fargs, fake_mode=fm)
    return rec, t1 - t0, time.time() - t1


def build_tthf_program(model, shape, mesh, sync: str, consensus_mode: str,
                       tau: int = 8, consensus_every: int = 4,
                       gamma: int = 2, fused_interval: bool = False,
                       replicas: int = 0, donate: bool = True,
                       remat: bool = True):
    """One TT-HF interval (Algorithm 1 lines 4-15) on ``mesh``:
    replicas = the (pod, data) slices, clusters = data blocks (multi-pod:
    a cluster is a pod); a giant model (over 5e10 params) takes a pod a
    replica and FSDP inside it, with a quarter of the microbatch.
    ``fused_interval``: the flat (R, P) carrier step, rows over the
    replica axes and columns over ``model``. ``replicas``: R in one
    cluster, a multiple of the replica axes' ranks, in place of one
    replica a rank (a one-card mesh holds several). Returns ``(fn,
    abstract_args)`` for ``fn(params, batch, picks, step_idx)``.
    ``donate``: the interval's result is written into ``params``'
    buffers and returned in them (XLA's donated arguments); False: the
    microsteps run on a copy, ``params`` are left as they were and the
    result comes back in new buffers. ``remat``: every replica's layers
    rematerialized in the backward.

    Each rank runs its own replicas' microsteps on its rows, whole over
    ``model`` (no tensor parallelism inside a replica yet: the ``model``
    ranks of a replica compute alike); the D2D mixes, the aggregation
    and the fused block end run on columns, all-to-alls over the replica
    axes bringing every replica's slice of them to each rank
    (:class:`~repro_torch.core.distributed.MeshRows`)."""
    import torch
    from repro_torch.core.distributed import (
        MeshRows, TTHFScaleConfig, make_tthf_train_step, tthf_shardings)
    from repro_torch.dist.sharding import (
        is_dtensor, local, mesh_axis_names, mesh_axis_sizes, on_shards,
        placements)
    from repro_torch.launch.steps import (
        Program, param_dtype_for, place, replicated)
    from repro_torch.models.common import tree_from_items, tree_items

    sizes = mesh_axis_sizes(mesh)
    pod_granular = model.cfg.param_count() > 5e10 and "pod" in sizes
    if pod_granular:
        R = cluster = sizes["pod"]
    else:
        R = sizes.get("pod", 1) * sizes.get("data", 1)
        cluster = sizes.get("data", R)      # multipod: cluster == pod
    if replicas:
        if replicas % R:
            raise ValueError(f"{replicas} replicas do not split over the "
                             f"replica axes' {R} ranks")
        R = cluster = replicas
    scale = TTHFScaleConfig(
        replicas=R, cluster_size=cluster, tau=tau,
        consensus_every=consensus_every, gamma_d2d=gamma,
        consensus_mode=consensus_mode, lr=1e-2, graph="ring",
        granularity="pod" if pod_granular else "dp")
    pdt = param_dtype_for(model.cfg)
    axes = tuple(a for a in (("pod",) if pod_granular else ("pod", "data"))
                 if a in mesh_axis_names(mesh))
    step, net = make_tthf_train_step(
        model, scale, dtype=torch.bfloat16, remat=remat, sync=sync,
        fused_interval=fused_interval, param_dtype=pdt,
        device=mesh.device_type, rows=MeshRows(mesh, axes))
    p_abs, p_sh, b_sh = tthf_shardings(model, scale, mesh, param_dtype=pdt)
    if fused_interval:
        p_abs = torch.empty((R, step.spec.padded), dtype=pdt, device="meta")
        cols = "model" if "model" in mesh_axis_names(mesh) else None
        p_sh = placements((axes, cols), mesh)
    b = max(1, shape.global_batch // R)
    if pod_granular:
        b = max(1, b // 4)
    tb = torch.empty((tau, R, b, shape.seq_len), dtype=torch.int32,
                     device="meta")
    repl = replicated(mesh)
    rows = placements((axes,), mesh)              # the rank's replicas,
    batch_rows = placements((None, axes), mesh)   # whole over the rest
    paths = [p for p, _ in tree_items(p_abs)] if isinstance(p_abs, dict) \
        else None

    def run(params, batch, picks, step_idx):
        leaves = ([v for _, v in tree_items(params)] if paths is not None
                  else [params])
        n = len(leaves)

        def interval(*a):
            mine = a[:n] if donate else [t.clone() for t in a[:n]]
            p = tree_from_items(zip(paths, mine)) if paths else mine[0]
            out, loss = step(p, {"tokens": a[n], "labels": a[n + 1]},
                             a[n + 2], step_idx)
            outs = ([v for _, v in tree_items(out)] if paths is not None
                    else [out])
            return (*outs, loss)

        res = on_shards(interval, (*leaves, batch["tokens"],
                                   batch["labels"], picks),
                        lambda _: ((rows,) * n + (batch_rows, batch_rows,
                                                  repl),
                                   (rows,) * n + (repl,)))
        outs = list(res[:n])
        if donate:
            # the result into the parameter input's own buffers
            for src, dst in zip(outs, leaves):
                if is_dtensor(dst):
                    src = place(src, tuple(dst.placements), mesh)
                local(dst).copy_(local(src))
            outs = leaves
        new = tree_from_items(zip(paths, outs)) if paths else outs[0]
        return new, res[n]

    fn = Program(run, mesh, (p_sh, {"tokens": b_sh, "labels": b_sh}, repl,
                             repl), (p_sh, repl))
    picks = torch.empty((net.num_clusters,), dtype=torch.int32,
                        device="meta")
    return fn, (p_abs, {"tokens": tb, "labels": tb}, picks,
                torch.empty((), dtype=torch.int32, device="meta"))


def donation_record(donated, undonated) -> dict:
    """The reference's ``rec["donation"]`` from the counts of a donated
    and an undonated program: the live argument-plus-output bytes of
    each (an output that aliases an argument counted once) and their
    ratio."""
    def live(r):
        return r.arg_bytes + r.out_bytes - r.alias_bytes
    live_d, live_u = live(donated), live(undonated)
    return {"alias_bytes": donated.alias_bytes,
            "live_arg_out_donated": live_d,
            "live_arg_out_undonated": live_u,
            "param_hbm_ratio": live_u / max(live_d, 1.0)}


def donation_line(don: dict) -> str:
    """The reference's ``donation:`` line of a :func:`donation_record`."""
    return (f"  donation: alias {don['alias_bytes']:.3e}B  live arg+out "
            f"{don['live_arg_out_undonated']:.3e}B -> "
            f"{don['live_arg_out_donated']:.3e}B "
            f"({don['param_hbm_ratio']:.2f}x)")


def run_one(arch: str, shape_name: str, mesh_name: str,
            verbose: bool = True, sync: str = "baseline",
            tau: int = 8, consensus_every: int = 4,
            donation_check: bool = False, moe_ep: bool = False,
            mesh=None, shape=None) -> dict:
    """Trace one (arch, shape) step on the production mesh (or on
    ``mesh``, a ``DeviceMesh`` whose axes are the production axes;
    ``shape``: an ``InputShape`` in place of the registered one)."""
    from repro_torch.configs import get_arch, get_shape
    from repro_torch.launch.analysis import analyze, model_flops_for
    from repro_torch.launch.mesh import chips_in
    from repro_torch.launch.steps import TRAIN_RULES, build_program
    from repro_torch.models import build_model

    cfg = get_arch(arch)
    shape = shape or get_shape(shape_name)
    if (arch, shape_name) in SKIPS:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped", "reason": SKIPS[(arch, shape_name)]}
    if mesh is None:
        mesh = production_mesh(mesh_name)
    model = build_model(cfg)
    rules_override = None
    if moe_ep:
        rules_override = TRAIN_RULES.with_overrides(
            embed_fsdp=None, expert_ffn=("pod", "data"))
    t0 = time.time()

    def interval(donate: bool):
        return build_tthf_program(
            model, shape, mesh, "tthf" if sync.startswith("tthf") else sync,
            "fused" if "fused" in sync else "rounds", tau=tau,
            consensus_every=consensus_every,
            fused_interval=sync == "tthf-fused-interval", donate=donate)

    if sync == "baseline":
        fn, args = build_program(model, shape, mesh,
                                 rules_override=rules_override)
    else:
        fn, args = interval(donate=True)
    rec, t_place, t_run = trace(fn, args)
    t_lower = time.time() - t0 - t_run
    if verbose:
        print(f"[{arch} x {shape.name} x {mesh_name}] "
              f"build {t_lower:.1f}s trace {t_run:.1f}s "
              f"({rec.ops} local ops)")
        print(f"  memory: arg {rec.arg_bytes:.3e}B out {rec.out_bytes:.3e}B "
              f"temp {rec.temp_bytes:.3e}B alias {rec.alias_bytes:.3e}B")
        print(f"  cost: flops={rec.flops:.3e} bytes={rec.bytes:.3e} "
              f"collective={rec.coll_total:.3e}B")
    roof = analyze(rec, arch=arch, shape=shape, mesh_name=mesh_name,
                   chips=chips_in(mesh),
                   model_flops_total=model_flops_for(cfg, shape))
    out = roof.to_dict()
    out.update(status="ok", lower_s=t_lower, compile_s=t_run,
               arg_bytes=rec.arg_bytes, out_bytes=rec.out_bytes,
               temp_bytes=rec.temp_bytes, alias_bytes=rec.alias_bytes)
    if donation_check and sync != "baseline":
        # the donation contract's memory claim, counted: the same
        # interval undonated beside the donated one
        undonated, _, _ = trace(*interval(donate=False))
        out["donation"] = donation_record(rec, undonated)
        if verbose:
            print(donation_line(out["donation"]))
    if verbose:
        print(f"  roofline: compute {roof.compute_s * 1e3:.2f}ms "
              f"memory {roof.memory_s * 1e3:.2f}ms "
              f"collective {roof.collective_s * 1e3:.2f}ms "
              f"-> dominant: {roof.dominant} "
              f"(fraction {out['roofline_fraction']:.3f})")
    return out


def run_serve_one(arch: str, mesh_name: str, *, slots: int = 8,
                  max_prompt: int = 1024, max_total: int = 2048,
                  paged: bool = False, page_size: int = 64,
                  verbose: bool = True, mesh=None) -> dict:
    """Trace the sharded serving pair (admission and per-slot decode,
    what ``ContinuousScheduler`` runs; with ``paged``, the chunked
    prefill and page-map decode of ``PagedContinuousScheduler``) on a
    production mesh. Besides the reference's per-program fields, each
    program carries its roofline terms, and the record the pair's
    summed ``flops_dev``, ``bytes_dev``, ``coll_bytes_dev``, terms and
    ``dominant``."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.analysis import analyze
    from repro_torch.launch.mesh import chips_in
    from repro_torch.launch.steps import (
        build_paged_serve_program, build_serve_program)
    from repro_torch.models import build_model

    cfg = get_arch(arch)
    if mesh is None:
        mesh = production_mesh(mesh_name)
    model = build_model(cfg)
    if paged:
        programs = build_paged_serve_program(
            model, mesh, slots=slots, max_prompt=max_prompt,
            max_total=max_total, page_size=page_size)
    else:
        programs = build_serve_program(model, mesh, slots=slots,
                                       max_prompt=max_prompt,
                                       max_total=max_total)
    chips = chips_in(mesh)
    rec = {"arch": arch, "shape": "serve", "mesh": mesh_name,
           "status": "ok", "chips": chips, "slots": slots,
           "max_prompt": max_prompt, "max_total": max_total,
           "paged": paged, "programs": {}}
    if paged:
        rec["page_size"] = page_size
    total = None
    for name, (fn, args) in programs.items():
        cost, t_place, t_run = trace(fn, args)
        total = cost if total is None else total.add(cost)
        roof = analyze(cost, arch=arch, shape="serve", mesh_name=mesh_name,
                       chips=chips, model_flops_total=0.0)
        prec = {
            "lower_s": t_place, "compile_s": t_run,
            "flops": float(cost.flops), "bytes_accessed": float(cost.bytes),
            "arg_bytes": cost.arg_bytes, "out_bytes": cost.out_bytes,
            "temp_bytes": cost.temp_bytes, "alias_bytes": cost.alias_bytes,
            "coll_bytes": cost.coll_total,
            "coll_breakdown": roof.coll_breakdown,
            "compute_s": roof.compute_s, "memory_s": roof.memory_s,
            "collective_s": roof.collective_s, "dominant": roof.dominant,
        }
        rec["programs"][name] = prec
        if verbose:
            print(f"[serve {arch} x {mesh_name}] {name}: "
                  f"build {t_place:.1f}s trace {t_run:.1f}s")
            print(f"  flops={prec['flops']:.3e} "
                  f"bytes={prec['bytes_accessed']:.3e} "
                  f"temp={prec['temp_bytes']:.3e}B "
                  f"alias={prec['alias_bytes']:.3e}B")
    roof = analyze(total, arch=arch, shape="serve", mesh_name=mesh_name,
                   chips=chips, model_flops_total=0.0)
    rec.update(flops_dev=roof.flops_dev, bytes_dev=roof.bytes_dev,
               coll_bytes_dev=roof.coll_bytes_dev, compute_s=roof.compute_s,
               memory_s=roof.memory_s, collective_s=roof.collective_s,
               dominant=roof.dominant)
    return rec


def _error(arch, shape, mesh_name, e) -> dict:
    return {"arch": arch, "shape": shape, "mesh": mesh_name,
            "status": "error",
            "error": f"{type(e).__name__}: {e}\n"
                     + traceback.format_exc()[-1500:]}


def _write(out: str, payload, default_name: str) -> None:
    import pathlib
    p = pathlib.Path(out)
    if p.is_dir() or not p.suffix:
        p.mkdir(parents=True, exist_ok=True)
        p = p / default_name
    p.write_text(json.dumps(payload, indent=1))
    print(f"wrote {p}", file=sys.stderr)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="pod",
                    choices=["pod", "multipod", "multipod10k"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None, help="JSON output path or dir")
    ap.add_argument("--subprocess", action="store_true",
                    help="run each combo in a fresh interpreter")
    ap.add_argument("--sync", default="baseline",
                    choices=["baseline", "star", "local",
                             "tthf-fused", "tthf-rounds",
                             "tthf-fused-interval"],
                    help="trace the TT-HF interval step instead of the "
                         "standard train step (train_4k only); "
                         "tthf-fused-interval = the flat (R, P) carrier "
                         "step")
    ap.add_argument("--tau", type=int, default=8)
    ap.add_argument("--consensus-every", type=int, default=4)
    ap.add_argument("--donation-check", action="store_true",
                    help="also trace the interval step WITHOUT donation "
                         "(--sync) and record the live-param bytes of "
                         "both")
    ap.add_argument("--pair-schedule", action="store_true",
                    help="the pair-scheduled flash attention (skips "
                         "fully-masked blocks)")
    ap.add_argument("--moe-ep", action="store_true",
                    help="expert weights stay put (expert_ffn sharded "
                         "over data, no FSDP gathers); tokens move")
    ap.add_argument("--serve", action="store_true",
                    help="trace the sharded serving pair (admission "
                         "prefill-splice + per-slot decode) instead of a "
                         "train/serve step shape")
    ap.add_argument("--slots", type=int, default=8,
                    help="serve mode: continuous-batching slot count")
    ap.add_argument("--max-prompt", type=int, default=1024,
                    help="serve mode: admission prompt length")
    ap.add_argument("--max-total", type=int, default=2048,
                    help="serve mode: per-slot cache length")
    ap.add_argument("--paged", action="store_true",
                    help="serve mode: the PAGED admission/decode pair "
                         "(chunked prefill + page-map decode)")
    ap.add_argument("--page-size", type=int, default=64,
                    help="serve mode: tokens per cache page (--paged)")
    args = ap.parse_args(argv)

    from repro_torch.models import attention
    attention.PAIR_SCHEDULE = args.pair_schedule
    verbose = args.out != "-"
    try:
        if args.serve:
            if not args.arch:
                ap.error("--serve requires --arch")
            try:
                rec = run_serve_one(args.arch, args.mesh, slots=args.slots,
                                    max_prompt=args.max_prompt,
                                    max_total=args.max_total,
                                    paged=args.paged,
                                    page_size=args.page_size,
                                    verbose=verbose)
            except Exception as e:  # noqa: BLE001 — report, don't crash
                rec = _error(args.arch, "serve", args.mesh, e)
            print(f"== serve {args.arch} x {args.mesh}: {rec['status']}",
                  file=sys.stderr)
            if args.out == "-":
                print(json.dumps(rec))
            elif args.out:
                tag = "_paged" if args.paged else ""
                _write(args.out, rec, f"dryrun_serve{tag}_{args.mesh}.json")
            return 1 if rec["status"] == "error" else 0

        from repro_torch.configs import ARCHS, INPUT_SHAPES
        combos = ([(a, s) for a in ARCHS for s in INPUT_SHAPES]
                  if args.all else [(args.arch, args.shape)])
        records = []
        for arch, shape in combos:
            if args.subprocess:
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape, "--mesh",
                       args.mesh, "--out", "-", "--sync", args.sync,
                       "--tau", str(args.tau), "--consensus-every",
                       str(args.consensus_every)]
                cmd += ["--pair-schedule"] if args.pair_schedule else []
                cmd += ["--moe-ep"] if args.moe_ep else []
                cmd += ["--donation-check"] if args.donation_check else []
                out = subprocess.run(cmd, capture_output=True, text=True,
                                     timeout=3600)
                try:
                    rec = json.loads(out.stdout.splitlines()[-1])
                except Exception:  # noqa: BLE001 — the record says why
                    rec = {"arch": arch, "shape": shape, "mesh": args.mesh,
                           "status": "error",
                           "error": (out.stderr or out.stdout)[-2000:]}
            else:
                try:
                    rec = run_one(arch, shape, args.mesh, verbose=verbose,
                                  sync=args.sync, tau=args.tau,
                                  consensus_every=args.consensus_every,
                                  donation_check=args.donation_check,
                                  moe_ep=args.moe_ep)
                    rec["sync"] = args.sync
                    rec["tau"] = args.tau
                except Exception as e:  # noqa: BLE001 — sweep continues
                    rec = _error(arch, shape, args.mesh, e)
            records.append(rec)
            print(f"== {arch} x {shape} x {args.mesh}: {rec['status']}",
                  file=sys.stderr)
        if args.out == "-":
            print(json.dumps(records[0] if len(records) == 1 else records))
        elif args.out:
            _write(args.out, records, f"dryrun_{args.mesh}.json")
        return 1 if any(r["status"] == "error" for r in records) else 0
    finally:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
