"""Serving entry point of the port, with the flags of
``repro/launch/serve.py`` plus ``--device``, printing the same summary
lines. Four modes:

  direct      — one fixed batch, joint prefill, lockstep decode
  wave        — BatchScheduler: admit a wave, drain, admit the next
  continuous  — ContinuousScheduler: per-slot admission/retirement
  paged       — PagedContinuousScheduler: paged KV cache with prefix
                sharing + chunked prefill, decode attention through the
                ``paged_decode`` kernel on the card; tune with
                --page-size/--cache-pages/--prefill-chunk, exercise
                prefix sharing with --prefix-template

The dense kind (qwen1.5-0.5b, the default ``--arch``, and the other
attention archs), the ssm kind (``--arch mamba2-370m``, served from
its per-slot state; on the card every prefill scan from a zero state
runs the ``ssd_scan`` kernel) and the hybrid kind (``--arch
recurrentgemma-9b``: RG-LRU state per slot and local attention over a
2,048-token window — a ring of 2,048 slots, or pages masked to the
window band by ``paged_decode``; a one-shot prefill past 2,048 tokens
attends through ``flash_attention``) and the moe kind (``--arch
llama4-scout-17b-a16e``, an MoE FFN in every layer, or
``llama4-maverick-400b-a17b``, in every other layer: top-1 routing at
the config's capacity factor 1.25; a prefill routes each request on its
own, a decode step all slots as one group, as the reference does) in
all four modes.

Examples:
  python -m repro_torch.launch.serve --scheduler paged --requests 32 \
      --batch 8 --prompt-len 512 --gen 128 --prefill-chunk 256 \
      --prefix-template 128 --temperature 0     # full size, on the card
  python -m repro_torch.launch.serve --arch mamba2-370m \
      --scheduler continuous --batch 8 --prompt-len 512 --gen 128 \
      --requests 32 --prefix-template 128 --temperature 0   # on the card
  python -m repro_torch.launch.serve --reduced --scheduler paged \
      --temperature 0 --device cpu
  python -m repro_torch.launch.serve --arch mamba2-370m --reduced \
      --batch 4 --prompt-len 64 --gen 16 --device cpu
  python -m repro_torch.launch.serve --arch recurrentgemma-9b --reduced \
      --scheduler paged --temperature 0 --device cpu
  python -m repro_torch.launch.serve --arch recurrentgemma-9b \
      --scheduler paged --batch 8 --prompt-len 3072 --gen 64 \
      --requests 8 --prefill-chunk 256 --temperature 0   # on the card
  python -m repro_torch.launch.serve --arch llama4-scout-17b-a16e \
      --reduced --scheduler paged --temperature 0 --device cpu
  python -m repro_torch.launch.serve --arch paligemma-3b --batch 8 \
      --prompt-len 1920 --gen 64 --temperature 0       # on the card
  python -m repro_torch.launch.serve --arch whisper-small --reduced \
      --temperature 0 --device cpu

In the scheduler modes ``--trace-dir D`` writes the Chrome trace of the
scheduler's spans (``D/trace.json``), one ``request`` record per retired
request in ``D/metrics.jsonl`` and ``D/manifest.json``; ``--profile``
adds a ``torch.profiler`` trace in ``D/torch_profile/trace.json``.

The vlm kind (``--arch paligemma-3b``: 256 stub patch embeddings before
the prompt under a prefix-LM mask) and the audio kind (``--arch
whisper-small``: an encoder over 1,500 stub frames, cross-attention in
every decoder layer) run in direct mode only, their frontend's
embeddings drawn as standard normal x 0.1 from ``--seed``; the request
schedulers serve tokens only and refuse them, as the reference's do.

Sharded serving: ``--mesh host|data|AxB`` serves over a
``torch.distributed`` ``DeviceMesh`` with dims ``("data", "model")``
(params tensor-parallel over ``model``, cache leaves along heads, slots
over ``data``; see :mod:`repro_torch.serving.sharding`). Under
``torchrun`` the mesh spans the environment's world (NCCL, one card a
rank; untried: no run on more than one card has been made); without
it, a world of one rank on the resolved device (NCCL on the card, gloo
with ``--device cpu``). ``--host-devices N`` (with
``--device cpu`` only: a card has no simulated devices) runs N gloo
ranks on the CPU, each with the same arguments, meeting in a
``FileStore`` of a temporary directory; rank 0 prints the summary:
  python -m repro_torch.launch.serve --reduced --scheduler continuous \
      --device cpu --host-devices 4 --mesh data
  python -m repro_torch.launch.serve --reduced --scheduler paged \
      --device cpu --host-devices 4 --mesh 2x2
  torchrun --nproc-per-node 4 -m repro_torch.launch.serve \
      --mesh host                       # untried
  python -m repro_torch.launch.serve --scheduler paged --mesh host   # card
"""
from __future__ import annotations

import argparse
import copy
import os
import tempfile
import time

import numpy as np


def make_arrivals(cfg, *, requests: int, prompt_len: int, gen: int,
                  seed: int, prefix_template: int = 0,
                  arrival_gap: float = 2.0) -> list:
    """The scheduler modes' arrival trace, ``[(arrive_step, Request)]``,
    drawn from ``numpy.random.default_rng(seed)`` in the reference's
    order: the shared template (when ``prefix_template``), then each
    request's prompt length, prompt and gap to the next arrival."""
    from repro_torch.serving import Request

    rng = np.random.default_rng(seed)
    tmpl = None
    if prefix_template:
        # shared template prefix across every prompt — the prefix-
        # sharing trace: after the first admission the trie serves the
        # template's full pages to everyone else
        tmpl = rng.integers(1, cfg.vocab_size,
                            size=prefix_template).astype(np.int32)
    arrivals = []
    step = 0
    for rid in range(requests):
        plen = int(rng.integers(max(1, prompt_len // 4), prompt_len + 1))
        prompt = rng.integers(1, cfg.vocab_size, size=plen).astype(np.int32)
        if tmpl is not None:
            prompt = np.concatenate(
                [tmpl, prompt])[:prompt_len].astype(np.int32)
        arrivals.append((step, Request(rid=rid, prompt=prompt,
                                       max_new=gen)))
        step += int(rng.poisson(arrival_gap))
    return arrivals


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def _say(*a) -> None:
    """Print on rank 0 only: every rank of a sharded run computes the same
    summary."""
    if _rank() == 0:
        print(*a)


def init_params(model, args, device, mesh=None):
    """The model's random weights from ``--seed`` (every rank draws the
    same), placed on ``mesh`` by the serve rules when one is given."""
    import torch
    params = model.init(
        torch.Generator(device=device).manual_seed(args.seed), device)
    if mesh is None:
        return params
    from repro_torch.serving import shard_params
    return shard_params(params, model, mesh)


def mesh_devices(mesh) -> int:
    """The number of ranks serving (1 without a mesh)."""
    from repro_torch.launch.mesh import chips_in
    return 1 if mesh is None else chips_in(mesh)


def setup_mesh(args, device):
    """The serving mesh ``--mesh`` names, or None without it: over the
    initialized process group (the ``--host-devices`` ranks), the
    environment's world under ``torchrun``, or else a world of one rank
    on ``device`` (NCCL on the card, gloo on the CPU; an in-process
    store, no port)."""
    if not args.mesh:
        return None
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_serve_mesh
    if not dist.is_initialized():
        backend = "nccl" if device.type == "cuda" else "gloo"
        if "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend)
        else:
            dist.init_process_group(backend, store=dist.HashStore(),
                                    rank=0, world_size=1)
    return make_serve_mesh(args.mesh, device.type)


def run_on_host_devices(n: int, fn, *args) -> None:
    """``fn(*args)`` on ``n`` gloo ranks on the CPU (the counterpart of
    ``n`` simulated host devices): spawned processes meeting in a
    ``FileStore`` of a temporary directory — no TCP port, so concurrent
    runs cannot collide — each with ``1/n`` of torch's threads."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as d:
        mp.spawn(_host_rank, args=(n, os.path.join(d, "store"), fn, args),
                 nprocs=n)


def _host_rank(rank: int, n: int, store: str, fn, args) -> None:
    import torch
    import torch.distributed as dist
    torch.set_num_threads(max(1, torch.get_num_threads() // n))
    dist.init_process_group("gloo", store=dist.FileStore(store, n),
                            rank=rank, world_size=n)
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()


def run_scheduler_trace(args, cfg, model, device, params=None, mesh=None,
                        **over):
    """Build the scheduler the flags name (``over`` adds or replaces its
    keyword arguments, e.g. ``ssd_kernel=False``) and drive the arrival
    trace through it, instrumented when ``--trace-dir`` is given (one
    ``request`` record per retired request; the sink is closed before
    returning; under a mesh rank 0 writes it). With ``mesh`` the
    scheduler serves sharded (``params``, when given, already placed on
    it). Returns (scheduler, stats, arrivals, seconds of the trace,
    ending in a device sync)."""
    import torch
    from repro_torch.obs.sink import make_obs
    from repro_torch.serving import make_scheduler, run_trace

    kw = dict(slots=args.batch, max_prompt=args.prompt_len,
              max_total=args.prompt_len + args.gen,
              temperature=args.temperature, seed=args.seed,
              cache_dtype={"f32": torch.float32,
                           "bf16": torch.bfloat16}[args.cache_dtype],
              device=device, mesh=mesh)
    rank0 = _rank() == 0
    obs = make_obs(args.trace_dir if rank0 else None,
                   profile=args.profile and rank0, run_name="serve",
                   config={"args": vars(args)},
                   extra={"arch": cfg.name, "scheduler": args.scheduler,
                          "mesh": args.mesh or "single",
                          "devices": mesh_devices(mesh)})
    kw["obs"] = obs
    if args.scheduler == "paged":
        kw["page_size"] = args.page_size
        if args.cache_pages:
            kw["cache_pages"] = args.cache_pages
        if args.prefill_chunk:
            kw["prefill_chunk"] = args.prefill_chunk
    sched = make_scheduler(args.scheduler, model, **{**kw, **over})
    if params is None:
        params = init_params(model, args, device, mesh)
    arrivals = make_arrivals(cfg, requests=args.requests,
                             prompt_len=args.prompt_len, gen=args.gen,
                             seed=args.seed,
                             prefix_template=args.prefix_template,
                             arrival_gap=args.arrival_gap)
    try:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.time()
        stats = run_trace(sched, params, arrivals)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wall = time.time() - t0
        # one JSONL record per retired request — queue latency and TTFT
        # in step-clock ticks, same stream as everything else
        for r in stats.records:
            obs.emit("request", r.retire, rid=r.rid, submit=r.submit,
                     admit=r.admit, first_token=r.first_token,
                     queue_latency=r.queue_latency, ttft=r.ttft,
                     decode=r.decode, budget=r.budget,
                     prefill_chunks=r.prefill_chunks,
                     prefix_pages_reused=r.prefix_pages_reused)
    finally:
        obs.close()
    return sched, stats, arrivals, wall


def _run_scheduler(args, cfg, model, device, mesh):
    sched, stats, _, dt = run_scheduler_trace(args, cfg, model, device,
                                              mesh=mesh)
    _say(f"arch={cfg.name} scheduler={args.scheduler} slots={args.batch} "
          f"requests={args.requests} devices={mesh_devices(mesh)}")
    _say(f"done={stats.requests_done} prefills={stats.prefills} "
          f"decode_steps={stats.decode_steps} "
          f"tokens={stats.tokens_generated} "
          f"util={stats.utilization:.2f} "
          f"({stats.tokens_generated / max(dt, 1e-9):.1f} tok/s)")
    if stats.records:
        ql = np.array([r.queue_latency for r in stats.records])
        tt = np.array([r.ttft for r in stats.records if r.ttft >= 0])
        if len(tt):
            _say(f"queue latency (steps): p50={np.percentile(ql, 50):.0f} "
                  f"p95={np.percentile(ql, 95):.0f}  "
                  f"ttft: p50={np.percentile(tt, 50):.0f} "
                  f"p95={np.percentile(tt, 95):.0f}")
    if args.scheduler == "paged":
        reused = sum(r.prefix_pages_reused for r in stats.records)
        _say(f"pages: size={sched.page_size} pool={sched.cache_pages} "
              f"free={sched.table.num_free} "
              f"prefix_hit_rate={sched.prefix_hit_rate:.2f} "
              f"pages_reused={reused} "
              f"deferrals={sched.page_deferrals}")
    return 0


def direct_batch(cfg, batch: int, prompt_len: int, seed: int) -> dict:
    """Direct mode's inputs as numpy arrays, drawn from
    ``numpy.random.default_rng(seed + 1)``: the prompt tokens (batch,
    prompt_len), then the stub frontend's embeddings the kind needs,
    standard normal x 0.1 in float32 — ``patches`` (vlm) or ``frames``
    (encdec, audio), (batch, enc_seq_len, d_model)."""
    from repro_torch.models.transformer import ENCODER_KINDS

    rng = np.random.default_rng(seed + 1)
    out = {"tokens": rng.integers(0, cfg.vocab_size,
                                  size=(batch, prompt_len))}
    name = ("patches" if cfg.kind == "vlm" else
            "frames" if cfg.kind in ENCODER_KINDS else None)
    if name:
        out[name] = rng.standard_normal(
            (batch, cfg.enc_seq_len, cfg.d_model),
            dtype=np.float32) * np.float32(0.1)
    return out


def run_direct(args, cfg, model, device, params=None, *, mesh=None,
               keep_logits: bool = False, forced=None) -> dict:
    """Direct mode: one fixed batch (:func:`direct_batch`), a joint
    prefill (the cache sized for the prompt, the new tokens and the vlm
    kind's patches) and ``--gen`` lockstep decode steps, in float32.
    Returns the batch, the sampled tokens (B, gen), the seconds of the
    prefill and of the decode (each ending in a device sync) and, with
    ``keep_logits``, the prefill's last-token logits and each decode
    step's, (B, gen + 1, V) on the device (the last row follows the
    last sampled token). ``forced`` (B, gen): the decode steps take
    these tokens in place of the sampled ones (teacher forcing). With
    ``mesh`` the run is sharded (``params``, when given, already placed
    on it) and the kept logits are gathered whole."""
    import torch
    from repro_torch.dist.sharding import is_dtensor, use_mesh
    from repro_torch.serving import sample_tokens

    if params is None:
        params = init_params(model, args, device, mesh)
    B, T = args.batch, args.prompt_len
    batch = direct_batch(cfg, B, T, args.seed)
    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    total = T + args.gen + (cfg.enc_seq_len if cfg.kind == "vlm" else 0)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def whole(x):
        return x.full_tensor() if is_dtensor(x) else x

    sync()
    t0 = time.time()
    with use_mesh(mesh):
        logits, cache, pos = model.prefill(
            params, {k: torch.as_tensor(v, device=device)
                     for k, v in batch.items()},
            dtype=torch.float32, cache_dtype=torch.float32, cache_len=total,
            use_kernel=device.type == "cuda")
    logits = whole(logits)
    sync()
    t_prefill = time.time() - t0
    out_tokens, kept = [], [logits]
    t0 = time.time()
    for i in range(args.gen):
        tok = sample_tokens(logits, temperature=args.temperature,
                            generator=gen)
        out_tokens.append(tok[:, 0].cpu().numpy())
        if forced is not None:
            tok = torch.as_tensor(forced[:, i:i + 1], dtype=torch.int32,
                                  device=device)
        with use_mesh(mesh):
            logits, cache = model.decode_step(params, tok, cache, pos,
                                              dtype=torch.float32)
        logits = whole(logits)
        if keep_logits:
            kept.append(logits)
        pos = pos + 1
    sync()
    t_decode = time.time() - t0
    out = {"batch": batch, "sampled": np.stack(out_tokens, axis=1),
           "prefill_s": t_prefill, "decode_s": t_decode}
    if keep_logits:
        out["logits"] = torch.cat(kept, dim=1)
    return out


def _run_direct(args, cfg, model, device, mesh):
    run = run_direct(args, cfg, model, device, mesh=mesh)
    B, t_decode = args.batch, run["decode_s"]
    _say(f"arch={cfg.name} B={B} prompt={args.prompt_len} gen={args.gen} "
          f"devices={mesh_devices(mesh)}")
    _say(f"prefill: {run['prefill_s']:.2f}s  decode: {t_decode:.2f}s "
          f"({args.gen * B / max(t_decode, 1e-9):.1f} tok/s)")
    _say("sampled token ids (first row):", run["sampled"][0].tolist())
    return 0


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--scheduler", default="direct",
                    choices=["direct", "wave", "continuous", "paged"],
                    help="direct: one fixed batch; wave/continuous/"
                         "paged: request schedulers over --requests "
                         "arrivals")
    ap.add_argument("--requests", type=int, default=8,
                    help="number of requests for scheduler modes")
    ap.add_argument("--cache-dtype", default="f32",
                    choices=["f32", "bf16"],
                    help="KV cache storage dtype (compute stays f32)")
    ap.add_argument("--page-size", type=int, default=16,
                    help="paged scheduler: tokens per cache page")
    ap.add_argument("--cache-pages", type=int, default=0,
                    help="paged scheduler: total page-pool size incl. "
                         "the dummy page (0 = ring-equivalent capacity); "
                         "smaller pools trade capacity for deferrals")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="paged scheduler: prefill chunk length in "
                         "tokens, page-size multiple (0 = one-shot)")
    ap.add_argument("--prefix-template", type=int, default=0,
                    help="share a random N-token template prefix across "
                         "all prompts (prefix-sharing trace)")
    ap.add_argument("--arrival-gap", type=float, default=2.0,
                    help="mean Poisson inter-arrival gap (decode steps)")
    ap.add_argument("--mesh", default=None,
                    help="serve sharded over the torch.distributed world: "
                         "'host' (all tensor-parallel), 'data' (all "
                         "data-parallel), or 'AxB' (data x model)")
    ap.add_argument("--host-devices", type=int, default=0,
                    help="run N gloo ranks on the CPU (the counterpart "
                         "of N simulated host devices; --device cpu only)")
    ap.add_argument("--trace-dir", default=None,
                    help="observability dir: Chrome trace, metrics.jsonl "
                         "telemetry, run manifest")
    ap.add_argument("--profile", action="store_true",
                    help="also run torch.profiler over the run (written "
                         "under <trace-dir>/torch_profile)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; the run "
                         "fails without one unless 'cpu' is given)")
    return ap.parse_args(argv)


def serve(args) -> int:
    """Serve as the flags say, in this process (a rank of the world when
    ``torch.distributed`` is initialized)."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_arch
    from repro_torch.kernels.runtime import resolve_device
    from repro_torch.models import build_model

    if (args.device is None and "LOCAL_RANK" in os.environ
            and torch.cuda.is_available()):
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))   # torchrun
    device = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    owned = args.mesh and not dist.is_initialized()
    mesh = setup_mesh(args, device)
    try:
        if args.scheduler != "direct":
            return _run_scheduler(args, cfg, model, device, mesh)
        return _run_direct(args, cfg, model, device, mesh)
    finally:
        if owned:
            dist.destroy_process_group()


def main(argv=None):
    args = parse_args(argv)
    if args.host_devices:
        if args.device != "cpu":
            raise ValueError(
                "--host-devices N runs N gloo ranks on the CPU and needs "
                "--device cpu; a card has no simulated devices (serve on "
                "cards with torchrun, or --mesh host on one)")
        one = copy.copy(args)
        one.host_devices = 0
        run_on_host_devices(args.host_devices, serve, one)
        return 0
    return serve(args)


if __name__ == "__main__":
    import sys
    sys.exit(main())
