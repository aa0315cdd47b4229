#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It drives the port's main paths — the paper's Algorithm 1 in
simulation mode at the paper's Sec. IV size (125 devices in 25 clusters,
the 784-7840-10 NN), the same under the four dynamic netsim scenarios,
under the four fog presets and under the two control policies, TT-HF as
the scale-mode sync strategy on the full-size qwen1.5-0.5b (24 layers, d
1024, vocabulary 151,936), the same at 8 replicas under a fog tree and
under the control plane (4 layers), on mamba2-370m (12 of its 48 Mamba-2
layers, d 1024, 32 SSD heads of 64, state 128), on recurrentgemma-9b
at full width (5 of its 38 layers) and on llama4-maverick's MoE layout
at full width (one {dense, moe} group, 8 experts), paged
continuous-batching serving of qwen1.5-0.5b, of the full
recurrentgemma-9b (RG-LRU and local attention over a 2,048-token
window) and of llama4-scout at full width (4 of its 48 layers, 16
experts, top-1 routing), continuous-batching serving of
mamba2-370m, training and prefill past 2,048 tokens through the
chunked ``flash_attention``, and direct serving of the full paligemma-3b
and whisper-small — and holds every kernel of those paths
against its plain PyTorch version; then the sim, scale and serve paths
again with the observability sink and a full-width checkpoint, held to
their bare runs.
Phases (any failure ends the run with a non-zero exit; nothing is
caught):

1. build   — compile every CUDA source of the port with nvcc (sm_90a),
             one nvcc per source, all started together; print ptxas's
             registers, shared memory and spills of every instance of
             ``fused_sgd_kernel``, ``paged_decode_kernel``,
             ``ssd_prep_kernel`` and ``ssd_scan_kernel``.
2. kernels — each kernel against its plain version on the card:
             ``consensus_mix`` at the shapes of tests/test_kernels.py and
             of the sim path, f32 (atol 1e-5) and bf16 (atol 2e-2);
             ``fused_consensus_sgd`` and ``fused_sgd`` at the shapes of
             tests/test_kernels.py with wd in {0, 0.1} (atol 1e-6 in f32,
             1e-2 in bf16; ``fused_sgd`` bitwise equal in f32, also at
             every size 1..33 at offsets 0 and 1 and with w and g at
             other offsets mod 16) and at the scale paths' flat replica
             buffers (qwen1.5-0.5b's and mamba2-370m's), f32. At the main
             paths' shapes it times each kernel,
             its plain version and a library yardstick the port never
             calls (``torch.bmm`` with the precomputed ``V^Γ``;
             ``torch.add`` with ``alpha=-η``, in turns with the kernel;
             and the two calls ``torch.bmm(W, torch.add(w, g,
             alpha=-η))``). ``paged_decode`` at the shapes of
             tests/test_torch_kernels.py (the reference's test shape,
             all-dummy rows with pos past their pages, the serve path's
             shape, a gemma-2b-like MQA, a starcoder2-3b-like GQA past
             its 4096 window in 160 splits, and the split's boundaries),
             the hybrid's serve shape (8 slots, K 1, G 16, hd 256,
             window 2,048, slots before, at and past the window) and the
             moe kind's (llama4-scout: 8 slots, K 8, G 5, hd 128, 36
             pages of 16), f32 and bf16 pools, atol 1e-5, a second launch
             bitwise equal to the first; timed at the serve path's shape,
             at the hybrid's, at scout's and with all 8 slots at position
             639, its inputs rotated
             over copies larger than the L2, beside the page gather plus
             ``scaled_dot_product_attention`` (two calls). ``ssd_scan``
             at the shapes of tests/test_kernels.py (ragged T = 130
             included; f32 max |Δy| / max |y| < 1e-4 and the final state
             to 1e-4; bf16 y within 1e-2 of max |y|), one row of B and C
             per head, chunk 64 against chunk 256, and at the serve
             path's admission (32 heads x 512 tokens) and the forward's
             (256 x 1024) rows; the main paths' grouped calls (B and C
             ``(1, 512, 128)`` and ``(8, 1024, 128)`` shared by 32 heads)
             through ``ssd_scan_heads`` (x in the model's layout) and
             through rows with ``heads_per_group=32``, f32 and bf16, a
             second launch bitwise equal; timed at both grouped shapes
             (the median of three readings) in turns with the same kernel
             behind transposed copies of x, dt and loga, and behind those
             and per-head copies of B and C, and
             the plain version (no single PyTorch call computes the
             scan), inputs rotated past the L2; its share of two bounds:
             the operations as three TF32 products on the tensor cores
             (the kernel's, in the kernels line) and in f32 on the CUDA
             cores.
3. slice   — ``TTHFTrainer`` on the card, kernel on: 40 steps, with the
             launch counter reset just before; then the same run through
             the ``masked_loop`` backend (same loss history, same
             ledger), the SVM, and Remark-1 adaptive Γ (kernel and
             ``masked_loop``, held against each other); and a small run
             on the card against the same run on the CPU.
3b. slice-netsim — the same NN under each dynamic netsim scenario
             (``markov_links``, ``device_churn``, ``stragglers``,
             ``flash_crowd``) for 60 steps, each consensus event through
             ``consensus_mix`` with the event's V (48 launches a run, the
             counter reset just before each), held to the same run
             through ``masked_loop`` (loss rtol 1e-4; gamma_used,
             active_devices and the ledger exactly); and the ``static``
             scenario equal to phase 3's run without one, exactly.
3c. slice-fog — the same NN under each fog preset (``flat``, ``fog3``,
             ``fog4``, ``fog3_sampled``), on the static topology and
             under ``device_churn``, 80 steps (fog4's root fires at 80):
             each consensus event through ``consensus_mix`` (64 launches
             a run), each aggregation one composed (125, 125) device
             matrix on every leaf (its share of the wall printed), held
             to ``masked_loop`` (loss rtol 1e-4; gamma_used,
             active_devices, the ledger and its uplinks by level
             exactly); ``flat`` for 40 steps equal to phase 3's run.
3d. slice-control — the same NN under the ``remark1`` (80 steps) and
             ``connectivity`` (25 steps: its gradient probe takes some 18 s
             an aggregation at this width) policies, static and under
             ``device_churn``: Γ from the controller at each event through
             ``consensus_mix``, held to ``masked_loop`` (as 3c, and the
             aggregation calendar and every decision's Γ, τ, safe and
             fallback exactly); the probe's time and card peak and τ's
             trajectory printed; the ``static`` policy for 40 steps equal
             to phase 3's run.
4. scale   — ``ScaleTrainer`` on qwen1.5-0.5b at full size with the
             scale CLI's defaults (4 replicas in clusters of 2, batch 16
             per replica, seq 128, τ 20, consensus every 5, Γ 2, f32)
             and ``fused_interval=True``: 2 intervals after a warm-up,
             with the launch counters reset just before (8
             ``fused_consensus_sgd`` launches, no other kernel); the
             same run with the per-leaf step (loss rtol 1e-4, same
             ledger, the whole global model within atol 1e-5); and a
             reduced qwen run on the card against the same run on the
             CPU (loss rtol 1e-4).
4b. scale-ssm — the same on mamba2-370m at full width and 12 of its
             48 layers (cut to pay for phases 4d, 5b and 5c; the gradient
             through the plain chunked scan: ``ssd_scan`` is forward
             only, and its counter must stay 0): 2 fused intervals after
             a warm-up (8 ``fused_consensus_sgd`` launches), the per-leaf
             step held to it, and a reduced mamba2 on the card against
             the CPU.
4c. scale-forms — the same qwen1.5-0.5b at full width and 4 of its 24
             layers (cut to pay for phases 4d, 5b and 5c) at 8 replicas
             in clusters of 2 (N 4; τ 20, consensus every 5, Γ 2, batch
             16 x 128), (a)
             under ``fog3`` and ``device_churn`` (the matrix form, each
             interval's refreshed W, a root event at interval 2) and (b)
             under ``connectivity`` and ``device_churn`` (the weights form
             and a Γ retuned each interval): 2 fused intervals each (8
             ``fused_consensus_sgd`` launches with the interval's W), the
             per-leaf step held to it (loss rtol 1e-4, the same ledger,
             the served global model within atol 1e-5).
4d. scale-hybrid — ``ScaleTrainer`` on recurrentgemma-9b at full width
             and depth 5 (one (rec, rec, attn) group and the two-layer
             tail; 2,174,906,368 parameters a replica): 2 replicas in one
             cluster of 2, τ 20, consensus every 5, Γ 2, batch 4 x 128, 2
             fused intervals (8 ``fused_consensus_sgd`` launches on the
             hybrid's flat (2, P) buffer), the per-leaf step held to it
             (loss rtol 1e-4, the same ledger, the global model within
             atol 1e-5). Four replicas, or the full depth at one, do not
             fit the card's 80 GB with the gradient and a copy.
4e. scale-moe — ``ScaleTrainer`` on llama4-maverick's layout (one
             {dense_0, moe} group, depth 2) at full d_model, d_ff and
             heads, its experts cut to 8 and its vocabulary to 32,768
             (1,593,902,080 parameters a replica; a full-width replica
             is 4.15 B at least, and two do not fit with the carrier's
             copies): 2 replicas in one cluster of 2, τ 20, consensus
             every 5, Γ 2, batch 4 x 128, the loss with the routers'
             aux terms; after a warm-up, 2 fused intervals (8
             ``fused_consensus_sgd`` launches), the per-leaf step held
             to them bitwise (losses, ledger, the global model), and the
             trained model's aux terms printed.
5. serve   — ``PagedContinuousScheduler`` on qwen1.5-0.5b at full size
             (random weights from seed 0, f32 weights and cache) through
             the serve CLI's trace (``launch/serve.py::make_arrivals``:
             32 requests, 8 slots, prompts up to 512 tokens with a
             128-token shared template, 128 new tokens, page size 16,
             chunks of 256, temperature 0), with the launch counter
             reset just before (``paged_decode`` once per layer per
             decode step) and no page leaked; the same trace through the
             plain gather (every stat equal), through a one-shot paged
             prefill and the ring ``ContinuousScheduler`` (every stat
             equal; chunking moves first tokens by a tick, so the
             chunked run is held to the ring on requests, prefills and
             tokens); teacher-forced logits of 16 decode steps of 8
             prefilled slots, kernel against plain gather (atol 1e-4);
             and a reduced-qwen trace on the card against the same trace
             on the CPU (the same tokens).
6. serve-ssm — the serve CLI's continuous scheduler on mamba2-370m at
             full size (``launch/serve.py --arch mamba2-370m --scheduler
             continuous --batch 8 --prompt-len 512 --gen 128 --requests
             32 --prefix-template 128 --temperature 0``, random f32
             weights from seed 0), with the launch counter reset just
             before: ``ssd_scan`` once per layer and admission, held to
             48 x the prefills of the same trace run on the CPU at
             reduced width; the same trace with ``ssd_kernel=False``
             (every stat equal) and through the paged scheduler with
             chunks of 256 (first chunks through the kernel, later ones
             through the plain scan from the carried state; the same
             requests, prefills and tokens). Greedy tokens must equal the
             plain run's, except at a request's first step where the
             plain run's top two logits are within 1e-4 of its max
             |logit| (the phase prints the margins).
5b. serve-hybrid — the serve CLI's paged scheduler on the full
             recurrentgemma-9b (``--arch recurrentgemma-9b --scheduler
             paged --batch 8 --prompt-len 3072 --gen 64 --requests 8
             --prefill-chunk 256 --temperature 0``, random f32 weights
             from seed 0; prompts of 768-3,072 tokens), with the launch
             counter reset just before (``paged_decode`` with its 2,048
             window band once per attention layer per decode step, 12 x
             decode steps; at least one slot decodes past the window),
             every stat held to the same trace on the CPU at reduced
             width; the plain gather (every stat equal) and the ring
             ``ContinuousScheduler`` (one-shot prefills of 3,072 tokens
             through ``flash_attention``, a ring of 2,048; the same
             requests, prefills and tokens) held to it, greedy tokens by
             the margin rule of phase 6; teacher-forced logits of 8
             decode steps of the longest and the shortest prompt, kernel
             against plain gather, within 1e-4 of max |logit|.
5c. flash  — qwen1.5-0.5b at full width and depth on one 4,096-token
             sequence: the loss, logits and every gradient through
             ``flash_attention`` against the materialized attention
             (loss rtol 1e-4, logits 1e-4 of max |logit|, gradient
             relative L2 1e-4); a one-shot ring prefill of 3,000 tokens
             (through flash) against 256-token paged chunks (last logits
             within 1e-4 of max |logit|).
5d. serve-moe — the serve CLI's paged scheduler on llama4-scout at full
             width and depth 4 (``--arch llama4-scout-17b-a16e
             --scheduler paged --batch 8 --prompt-len 512 --gen 64
             --requests 16 --prefill-chunk 256 --prefix-template 128
             --temperature 0``, random f32 weights from seed 0; 16
             experts, top-1, the config's capacity factor 1.25), with the
             launch counter reset just before (``paged_decode`` once per
             layer per decode step at the ``scout-serve`` shape), every
             stat held to the same trace on the CPU at reduced width, the
             template's prefix pages shared; the plain gather through the
             same scheduler, chunks and slots (the same routing; every
             stat equal, greedy tokens by the margin rule of phase 6);
             teacher-forced logits of 8 decode steps of the longest and
             the shortest prompt, kernel against plain gather, within
             1e-4 of max |logit|; the routers' drop share in a prefill
             chunk and in a decode step printed. Tokens are not compared
             across schedulers: a decode step routes all its slots as one
             group at capacity 1, so another batching drops other tokens,
             as the reference does.
7. forward-ssm — ``ModelApi.forward`` of the full-size mamba2-370m at
             batch 8 x 1024 tokens, f32, through the kernel against the
             plain ``ssd_chunked`` (logits within 1e-4 of max |logit|
             over 48 layers); and a reduced mamba2's serve trace on the
             card against the same trace on the CPU (the same tokens).
7a. serve-mesh — sharded serving through ``--mesh host`` on the one
             card: a (1, 1) ``DeviceMesh`` of an NCCL world of one rank,
             params and caches DTensors placed by the serve rules, the
             models' hints redistributing. The paged trace of phase 6
             (qwen1.5-0.5b) and the continuous trace of phase 7
             (mamba2-370m), each cut to 8 requests of 32 new tokens, run
             bare and on the mesh: every stat equal, tokens by the margin
             rule of phase 6, ``paged_decode`` (layers x decode steps)
             and ``ssd_scan`` (layers x prefills) launched on the rank's
             shard and counted as ``serve-mesh``; qwen's direct path
             (8 x 512 + 16) teacher-forced, logits within 1e-4 of max
             |logit| of its bare run. It prints each run's tokens/s and
             wall and the mesh's overhead.
7b'. dryrun — the port's dry run: ``python -m repro_torch.launch.dryrun``
             for qwen1.5-0.5b's train_4k step and its paged serving pair
             on the 256-rank pod mesh (a fake process group, sizes only,
             subprocesses on the host started first and read last: status
             ok, 256 chips, a dominant term, FLOPs counted) and a
             (64, 896) @ (896, 4864) product sharded over that mesh,
             counted as the rank's 2,179,072 FLOPs; ``build_program``'s
             train step on a (1, 1) NCCL mesh at qwen's full width,
             train_4k cut to 2 x 4,096 tokens: 3 SGD steps and 1 AdamW
             step at ``accum_steps_for``'s accumulation and at 2 (loss
             rtol 1e-5, params 1e-5; AdamW's params where its step is
             well conditioned, see ``adamw_close``), the SGD program
             against ``loss.backward()`` and ``w -= lr g`` (1e-6), the
             dry run's FLOPs of the same program equal to the executed
             step's; the ``--sync tthf-fused-interval`` program
             (``build_tthf_program``) at 2 of qwen's layers on the same
             mesh: ``fused_consensus_sgd`` launched once a block
             (counted as ``dryrun``), held to the unsharded interval
             (1e-6); ``flash_attention_pairs`` against
             ``flash_attention`` at 4,096 tokens with qwen's heads,
             causal and sliding (outputs 2e-5 of max |out|, gradients
             5e-5 relative L2), its blocks and both times.
7b. vlm   — the serve CLI's direct mode (``launch/serve.py --arch
             paligemma-3b --batch 8 --prompt-len 1920 --gen 64
             --temperature 0``, ``main(argv)`` on the card, random f32
             weights from seed 0) on the full paligemma-3b (18 layers,
             2,508,793,856 parameters): 256 stub patches before each
             prompt, 2,176 positions, so the prefill's prefix mask runs
             through ``flash_attention`` (18 calls, counted); the same
             run through ``run_direct`` with its logits kept (the same
             tokens): the prefill's last logits against a materialized
             prefill, the prefill and 64 decode steps teacher-forced
             against one forward over patches, prompt and greedy tokens
             (each within 1e-4 of max |logit|); one 2,176-position
             sequence's loss, logits and every gradient through flash
             against the materialized path (as [flash]); a reduced
             paligemma's direct run on the card against the CPU (logits
             1e-4 of max |logit|, the same tokens). No kernel lies on
             this path. It prints prefill s, decode tokens/s and peaks.
7c. audio  — the same for the full whisper-small (12 + 12 layers,
             1,500 stub frames, 238,279,680 parameters; ``--batch 8
             --prompt-len 64 --gen 64``), no flash on the main path; the
             encoder timed alone (CUDA events); one 4,096-token decoder
             prompt through a one-shot prefill and through the loss and
             gradient, each self-attention causal and each cross block
             (1,500 keys padded to 2,048, ``k_len`` 1,500) through
             ``flash_attention`` (24 calls), against the materialized
             path; a reduced whisper on the card against the CPU.
8. obs     — the observability sink and checkpoints, each run held to
             its bare run (bitwise where two bare runs on the card are
             bitwise equal, which the phase checks and prints first;
             else the [slice] and [scale] tolerances): phase 3's NN
             with a trace dir (32 ``consensus_mix`` launches; one
             ``round`` record per boundary with the reference's fields,
             the gauges equal to ``core/theory.py``, ``trace.json``
             valid) and with ``profile=True`` (the profiler's trace in
             ``torch_profile/`` holds the 32 ``consensus_mix`` kernel
             events); phase 4's fused qwen run with a trace dir (8
             ``fused_consensus_sgd`` launches, a finite ``grad_norm``),
             checkpointed after interval 1 (7.4 GB, the free disk
             checked first; deleted after) and resumed in a fresh
             trainer for interval 2; phase 5's trace through the serve
             CLI with ``--trace-dir`` (the same tokens and stats, one
             ``request`` record per request). It prints each run's
             rate beside its bare run's, the divergence probe's ms a
             round and the checkpoint's size and seconds.

It prints the card's name and power limit first, one JSON line with the
kernels' numbers before the last line, and as the last line
``{"ok": true, "device": {...}}``. Float32 products run in full float32
(TF32 off for matmul and cuDNN). Without a CUDA device, or without the
rest of the repository beside it, it exits non-zero and prints no result.

``--profile`` adds one profiled 20-step run of the sim path (static and
under ``device_churn``), one profiled interval of each scale path and one
profiled trace of each serve path (with the RG-LRU scan timed alone at
a prefill chunk's shape), and prints the device time by kernel and the
device's idle share. ``--phases slice-fog,slice-control,scale-forms,obs``
(any of ``PARTIAL_PHASES``) builds the kernels and runs only those
phases (the sim ones and ``obs`` after phase 3's run, ``obs`` also after
phases 4 and 5), and prints no result line.
"""
from __future__ import annotations

import dataclasses
import inspect
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet, at the 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12          # float32 outside the tensor cores
TF32_FLOPS_PER_S = 495e12        # TF32 on the tensor cores (3xTF32: 3 each)

MAIN_SHAPE = (25, 5, 784 * 7840)   # the NN's w1 leaf over the fleet
TEST_SHAPES = [(1, 2, 8), (3, 5, 100), (4, 8, 700), (2, 5, 513), (25, 5, 64)]
NN_LEAF_SHAPES = [(25, 5, 7840), (25, 5, 10), (25, 5, 7840 * 10)]
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# fused SGD kernels: tests/test_kernels.py's shapes and tolerances
SGD_TEST_SHAPES = [(8,), (127,), (129,), (1000, 37), (3, 5, 7, 11)]
FCS_TEST_SHAPES = [(2, 4, 64), (4, 2, 937), (1, 8, 128)]
SGD_TOL = {"float32": 1e-6, "bfloat16": 1e-2}
# the scale path: qwen1.5-0.5b's flat (R, P) buffer, R = 4 in clusters of 2
QWEN_P = 464_118_784
# mamba2-370m's flat (R, P) buffer: 368,285,184 parameters, already a
# multiple of 128 (no pad)
MAMBA2_P = 368_285_184
# [scale-forms] and [scale-ssm] run at a cut depth (full width, every
# replica, program and W kept), to pay for the hybrid and flash phases
# inside the time limit: qwen at 4 of its 24 layers, mamba2 at 12 of 48
SCALE_FORMS_LAYERS = 4
SCALE_FORMS_P = 207_115_264
SCALE_SSM_LAYERS = 12
SCALE_SSM_P = 130_803_840
# the hybrid kind: the full recurrentgemma-9b (38 layers, 9,396,301,824
# parameters) through the serve CLI's paged trace, prompts of 768-3,072
# tokens across the 2,048-token window
HYBRID_P = 9_396_301_824
SERVE_HYBRID_ARGV = ["--arch", "recurrentgemma-9b", "--scheduler", "paged",
                     "--batch", "8", "--prompt-len", "3072", "--gen", "64",
                     "--requests", "8", "--prefill-chunk", "256",
                     "--temperature", "0"]
# [scale-hybrid]: full width, depth 5 (one (rec, rec, attn) group and the
# two-layer tail): 2,174,906,368 parameters a replica
SCALE_HYBRID_LAYERS = 5
SCALE_HYBRID_P = 2_174_906_368
# [serve-moe]: llama4-scout at full width and depth 4 of its 48 layers
# (10,376,033,280 parameters, 41.5 GB in f32; the 48 layers are 407 GB)
# through the serve CLI's paged trace at the config's capacity factor
SERVE_MOE_LAYERS = 4
SERVE_MOE_P = 10_376_033_280
SERVE_MOE_ARGV = ["--arch", "llama4-scout-17b-a16e", "--scheduler", "paged",
                  "--batch", "8", "--prompt-len", "512", "--gen", "64",
                  "--requests", "16", "--prefill-chunk", "256",
                  "--prefix-template", "128", "--temperature", "0"]
# [scale-moe]: llama4-maverick's layout (one {dense_0, moe} group, depth
# 2) at full d_model, d_ff and heads, its experts cut from 128 to 8 and
# its vocabulary from 202,048 to 32,768: 1,593,902,080 parameters a
# replica (a full-width replica is 4.15 B at least; two of them and
# some 4.5 copies of the (2, P) carrier exceed the 80 GB)
SCALE_MOE_EXPERTS = 8
SCALE_MOE_VOCAB = 32_768
SCALE_MOE_P = 1_593_902_080
# [flash]: qwen1.5-0.5b at full width and depth on one 4,096-token
# sequence; a one-shot prefill of 3,000 tokens
FLASH_T = 4096
FLASH_PREFILL_T = 3000
# [vlm]: the full paligemma-3b (18 layers, d 2,048, MQA of 8 heads of
# 256, vocabulary 257,216) through the serve CLI's direct mode: 1,920
# text tokens behind the 256 patches, 2,176 positions, past the 2,048
# flash threshold under the prefix mask
VLM_ARGV = ["--arch", "paligemma-3b", "--batch", "8", "--prompt-len", "1920",
            "--gen", "64", "--temperature", "0"]
VLM_P = 2_508_793_856
# [audio]: the full whisper-small (12 encoder and 12 decoder layers, d
# 768, 1,500 frames) through the serve CLI's direct mode, and one
# 4,096-token decoder sequence through flash (the cross block's 1,500
# keys padded to 2,048)
AUDIO_ARGV = ["--arch", "whisper-small", "--batch", "8", "--prompt-len",
              "64", "--gen", "64", "--temperature", "0"]
AUDIO_P = 238_279_680
AUDIO_LONG_T = 4096
SCALE_LR = 2e-3                    # the scale CLI's --lr
SCALE_BATCH = 16                   # the scale CLI's --batch (per replica)
# paged_decode: name -> (B, K, G, hd, page_size, P, num_pages, window,
# pos), the cases of tests/test_torch_kernels.py; a pos of None is a
# retired slot: an all-dummy page-map row and a pos past its pages
PAGED_CASES = {
    "reference": (2, 2, 2, 8, 4, 3, 4, 0, [5, 9]),
    "reference-window": (2, 2, 2, 8, 4, 3, 4, 4, [5, 9]),
    "dummy-row": (3, 2, 2, 8, 4, 3, 7, 0, [5, None, 11]),
    "dummy-row-window": (3, 2, 2, 8, 4, 3, 7, 4, [5, None, 11]),
    "qwen-serve": (8, 16, 1, 64, 16, 40, 321, 0,
                   [80 * (b + 1) - 1 for b in range(8)]),
    "gemma-mqa": (4, 1, 8, 256, 16, 8, 33, 0, [3, 60, None, 127]),
    "starcoder-window": (2, 2, 12, 128, 16, 320, 641, 4096, [4500, 5119]),
    # the kernel's split at its boundaries (a chunk of 64 positions here):
    # live ranges of 1, 63, 64 and 65, windows from mid-chunk, a retired
    # slot, all-masked windowed rows, rows of no whole 16-byte pieces
    "split-edges": (4, 2, 2, 64, 16, 12, 49, 0, [0, 62, 63, 64]),
    "split-window": (4, 2, 2, 64, 16, 12, 49, 35, [69, 138, 191, 40]),
    "split-retired": (4, 2, 2, 64, 16, 12, 49, 0, [67, None, 128, 5]),
    "split-all-masked": (4, 2, 2, 64, 16, 12, 49, 16, [211, None, 100, 232]),
    "odd-head": (3, 2, 3, 6, 4, 5, 16, 0, [0, 11, 19]),
    # the hybrid's serve shape: MQA (K 1, G 16, hd 256), the 2,048 window
    # band, 196 pages of 16 a slot; slots before, at and past the window
    "hybrid-serve": (8, 1, 16, 256, 16, 196, 1569, 2048,
                     [700, 1500, 2047, 2048, 2300, 2600, 3000, 3135]),
    # the moe kind's serve shape ([serve-moe]'s trace): llama4-scout's GQA
    # (K 8, G 5, hd 128), 8 slots of 36 pages (512-token prompts and 64
    # new tokens), 289 pages
    "scout-serve": (8, 8, 5, 128, 16, 36, 289, 0,
                    [250, 296, 342, 388, 434, 480, 526, 575]),
}
SPLIT_CHUNK = 64
# timed only: the serve shape with every slot at its last position, so no
# slot waits on a longer one
PAGED_BALANCED = (8, 16, 1, 64, 16, 40, 321, 0, [639] * 8)
PAGED_TOL = 1e-5
# the serve path: the serve CLI's paged trace at full width and depth
SERVE_TRACE = dict(requests=32, prompt_len=512, gen=128, seed=0,
                   prefix_template=128, arrival_gap=2.0)
SERVE_SCHED = dict(slots=8, max_prompt=512, max_total=512 + 128,
                   temperature=0.0, seed=0)
SERVE_PAGED = dict(page_size=16, prefill_chunk=256)
# ssd_scan: (BH, T, P, S, chunk), tests/test_kernels.py's shapes, and the
# main paths' shapes: one admission of the serve-ssm trace (32 heads, the
# prompt padded to 512) and the forward-ssm phase (8 x 32 heads, 1024)
SSD_TEST_SHAPES = [(1, 64, 16, 16, 16), (2, 256, 64, 128, 128),
                   (3, 512, 64, 128, 256), (2, 130, 32, 64, 64)]
SSD_MAIN_SHAPES = {"serve": (32, 512, 64, 128, 256),
                   "forward": (256, 1024, 64, 128, 256)}
SSD_TOL = {"float32": 1e-4, "bfloat16": 1e-2}     # of max |y|
# the main paths' grouped calls, (b, H, T, P, S, chunk): B and C (b, T, S)
# shared by the H heads, x (b, T, H, P) read through strides
SSD_GROUP_SHAPES = {"serve": (1, 32, 512, 64, 128, 256),
                    "forward": (8, 32, 1024, 64, 128, 256)}
# the serve-ssm path: the serve CLI's flags
SERVE_SSM_ARGV = ["--arch", "mamba2-370m", "--scheduler", "continuous",
                  "--batch", "8", "--prompt-len", "512", "--gen", "128",
                  "--requests", "32", "--prefix-template", "128",
                  "--temperature", "0"]
LOGIT_TOL = 1e-4                   # of max |logit|


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``iters`` calls (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def mixing_inputs(shape, dtype, seed, gamma=None):
    """z, V (metropolis weights of random geometric graphs), gamma on
    the card, from one numpy seed; gamma heterogeneous with a 0."""
    import torch
    from repro_torch.core.topology import (
        geometric_adjacency, metropolis_weights)
    N, s, M = shape
    rng = np.random.default_rng(seed)
    V = np.stack([metropolis_weights(geometric_adjacency(s, 0.9, rng))
                  for _ in range(N)]).astype(np.float32)
    if gamma is None:
        gamma = rng.integers(0, 6, size=(N,)).astype(np.int32)
        gamma[0] = 0
    gen = torch.Generator(device="cuda").manual_seed(seed)
    z = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    return (z, torch.from_numpy(V).cuda(),
            torch.as_tensor(gamma, dtype=torch.int32, device="cuda"))


def ptxas_entries(report: str, match: str) -> list:
    """(kernel, registers, static shared memory B, spill stores B) of each
    entry function of nvcc's ``-Xptxas -v`` report whose mangled name
    holds ``match``, demangled when ``c++filt`` is there."""
    import re
    import shutil
    rows = []
    for block in report.split("Compiling entry function '")[1:]:
        name = block.split("'", 1)[0]
        if match not in name:
            continue
        nums = [re.search(pat, block) for pat in (
            r"Used (\d+) registers", r"(\d+) bytes smem",
            r"(\d+) bytes spill stores")]
        rows.append([name] + [int(m.group(1)) if m else 0 for m in nums])
    if rows and shutil.which("c++filt"):
        out = subprocess.run(["c++filt"], input="\n".join(r[0] for r in rows),
                             capture_output=True, text=True, timeout=60)
        for r, name in zip(rows, out.stdout.splitlines()):
            r[0] = name
    return [tuple(r) for r in rows]


def phase_build() -> None:
    import re

    from repro_torch.kernels import build
    t0 = time.time()
    reports = build.build()
    log(f"[build] {build.sources()} built with nvcc "
        f"{' '.join(build.NVCC_FLAGS)} in {time.time() - t0:.2f} s")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    for name, report in reports.items():
        (out_dir / f"nvcc_{name}.txt").write_text(report)
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", report)]
        spills = [int(r) for r in
                  re.findall(r"(\d+) bytes spill stores", report)]
        log(f"[build] {name}: {len(regs)} kernel instances, registers "
            f"{min(regs, default=0)}..{max(regs, default=0)}, spill stores "
            f"up to {max(spills, default=0)} B (ptxas report in "
            f"chiprun_out/nvcc_{name}.txt)")
    # the kernels redesigned for the card: each instance on its own
    for name, match in (("fused_consensus_sgd", "fused_sgd_kernel"),
                        ("paged_decode", "paged_decode_kernel"),
                        ("ssd_scan", "ssd_prep_kernel"),
                        ("ssd_scan", "ssd_scan_kernel")):
        for kernel, regs, smem, spill in ptxas_entries(
                reports.get(name, ""), match):
            log(f"[build] ptxas {kernel}: {regs} registers, {smem} B static "
                f"shared memory, {spill} B spill stores")


def phase_kernels() -> dict:
    import torch
    from repro_torch.core.mixing import matrix_powers
    from repro_torch.kernels.consensus_mix import (
        consensus_mix, consensus_mix_plain)

    worst = {}
    cases = [(shape, dt, None) for shape in TEST_SHAPES
             for dt in ("float32", "bfloat16")]
    cases += [(shape, "float32", None) for shape in NN_LEAF_SHAPES]
    # the Γ the Remark-1 rule gives the main path: up to its cap of 64
    cases += [(shape, "float32", np.resize(np.array([0, 2, 64], np.int32),
                                           shape[0]))
              for shape in NN_LEAF_SHAPES]
    for i, (shape, dt, g) in enumerate(cases):
        z, V, gamma = mixing_inputs(shape, getattr(torch, dt), seed=i,
                                    gamma=g)
        out = consensus_mix(z, V, gamma)
        torch.cuda.synchronize()
        plain = consensus_mix_plain(z, V, gamma)
        err = float((out.float() - plain.float()).abs().max())
        assert out.dtype == z.dtype and out.shape == z.shape
        assert err <= TOL[dt], (shape, dt, err)
        same = consensus_mix(z, V, torch.zeros_like(gamma))
        assert torch.equal(same, z), (shape, dt, "gamma=0 must copy z")
        worst[dt] = max(worst.get(dt, 0.0), err)
        log(f"[kernels] {shape} {dt} gamma={sorted(set(gamma.tolist()))} "
            f"max_abs_err={err:.3e} (tol {TOL[dt]})")

    # the main path's largest leaf: f32, Γ = 2 in every cluster
    N, s, M = MAIN_SHAPE
    z, V, gamma = mixing_inputs(MAIN_SHAPE, torch.float32, seed=100,
                                gamma=np.full((N,), 2, np.int32))
    out = consensus_mix(z, V, gamma)
    torch.cuda.synchronize()
    plain = consensus_mix_plain(z, V, gamma)
    err = float((out - plain).abs().max())
    assert err <= TOL["float32"], err
    del out, plain
    log(f"[kernels] {MAIN_SHAPE} float32 gamma=2 max_abs_err={err:.3e}")
    W = matrix_powers(V, gamma)
    kernel_ms = cuda_ms(lambda: consensus_mix(z, V, gamma), iters=20, warmup=2)
    plain_ms = cuda_ms(lambda: consensus_mix_plain(z, V, gamma), iters=3)
    library_ms = cuda_ms(lambda: torch.bmm(W, z), iters=20, warmup=2)
    bytes_moved = 2 * z.numel() * z.element_size()
    flops = sum(int(g) * 2 * s * s * M for g in gamma.tolist())
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    log(f"[kernels] {MAIN_SHAPE} f32 Γ=2: kernel {kernel_ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, torch.bmm(V^Γ, z) {library_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bytes_moved} B at 3.35 TB/s; {flops} FLOP at "
        f"67 TFLOP/s = {ops_ms:.4f} ms), kernel at "
        f"{bytes_moved / kernel_ms / 1e6:.1f} GB/s")
    del z, W
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "max_abs_err_all_shapes": {"float32": max(worst["float32"], err),
                                       "bfloat16": worst["bfloat16"]}}


def bound(bytes_moved: int, flops: int) -> tuple[float, str]:
    """The least time for the work (ms) and what decides it: bytes over
    the HBM rate or float32 operations over the f32 peak."""
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def scale_W():
    """The scale path's W = V^Γ (4 replicas in ring clusters of 2, Γ = 2)
    on the card."""
    from repro_torch.core.distributed import TTHFScaleConfig
    from repro_torch.core.mixing import build_mixing_plan
    net = TTHFScaleConfig(replicas=4, cluster_size=2).network()
    return build_mixing_plan(net, 2, backend="fused_power",
                             device="cuda").W


def sgd_inputs(shape, dtype, seed):
    import torch
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    return w.to("cuda", dtype), g.to("cuda", dtype)


def compare(out, plain, dt: str, what) -> float:
    """max |out - plain|; fails unless allclose at the dtype's tolerance
    (atol and rtol, as tests/test_kernels.py)."""
    import torch
    tol = SGD_TOL[dt]
    assert out.dtype == plain.dtype and out.shape == plain.shape, what
    err = float((out.float() - plain.float()).abs().max())
    assert torch.allclose(out.float(), plain.float(), atol=tol, rtol=tol), \
        (what, dt, err)
    return err


def phase_fused_kernels() -> dict:
    """``fused_consensus_sgd`` and ``fused_sgd`` against their plain
    versions, then timed at the scale path's flat replica buffer."""
    import torch
    from repro_torch.core.mixing import matrix_powers
    from repro_torch.kernels.fused_consensus_sgd import (
        fused_consensus_sgd, fused_consensus_sgd_plain)
    from repro_torch.kernels.fused_sgd import fused_sgd, fused_sgd_plain

    worst = {"fused_consensus_sgd": {}, "fused_sgd": {}}
    for dt in ("float32", "bfloat16"):
        for wd in (0.0, 0.1):
            for i, shape in enumerate(FCS_TEST_SHAPES):
                w, g = sgd_inputs(shape, getattr(torch, dt), seed=i)
                _, V, _ = mixing_inputs(shape, torch.float32, seed=i)
                W = matrix_powers(V, 2)
                out = fused_consensus_sgd(w, g, W, 0.01, weight_decay=wd)
                torch.cuda.synchronize()
                err = compare(out, fused_consensus_sgd_plain(
                    w, g, W, 0.01, weight_decay=wd), dt, shape)
                d = worst["fused_consensus_sgd"]
                d[dt] = max(d.get(dt, 0.0), err)
                log(f"[kernels] fused_consensus_sgd {shape} {dt} wd={wd} "
                    f"max_abs_err={err:.3e} (tol {SGD_TOL[dt]})")
            for i, shape in enumerate(SGD_TEST_SHAPES):
                w, g = sgd_inputs(shape, getattr(torch, dt), seed=i)
                out = fused_sgd(w, g, 0.01, weight_decay=wd)
                torch.cuda.synchronize()
                plain = fused_sgd_plain(w, g, 0.01, weight_decay=wd)
                err = compare(out, plain, dt, shape)
                if dt == "float32":
                    assert torch.equal(out, plain), shape
                d = worst["fused_sgd"]
                d[dt] = max(d.get(dt, 0.0), err)
                log(f"[kernels] fused_sgd {shape} {dt} wd={wd} "
                    f"max_abs_err={err:.3e} (tol {SGD_TOL[dt]}"
                    f"{'; bitwise equal' if dt == 'float32' else ''})")
            # sizes 1..33 around the vector width at offsets 0 and 1
            # (big[1:]: a scalar head), and w, g at other offsets mod 16
            # (the scalar loop)
            for n in range(1, 34):
                big, gbig = sgd_inputs((n + 2,), getattr(torch, dt), seed=n)
                for w, g in ((big[:n], gbig[:n]),
                             (big[1:n + 1], gbig[1:n + 1]),
                             (big[1:n + 1], gbig[2:n + 2])):
                    out = fused_sgd(w, g, 0.01, weight_decay=wd)
                    torch.cuda.synchronize()
                    plain = fused_sgd_plain(w, g, 0.01, weight_decay=wd)
                    err = compare(out, plain, dt, (n, w.data_ptr() % 16))
                    if dt == "float32":
                        assert torch.equal(out, plain), n
                    d = worst["fused_sgd"]
                    d[dt] = max(d.get(dt, 0.0), err)
            log(f"[kernels] fused_sgd sizes 1..33 at offsets 0 and 1 and "
                f"unequal offsets {dt} wd={wd}: max_abs_err "
                f"{worst['fused_sgd'][dt]:.3e}"
                f"{' (bitwise equal)' if dt == 'float32' else ''}")

    # the scale path: the flat (4, P) f32 buffer of qwen1.5-0.5b, seen as
    # (N, s, P) = (2, 2, P) at the block end
    gen = torch.Generator(device="cuda").manual_seed(7)
    w = torch.randn((2, 2, QWEN_P), generator=gen, device="cuda")
    g = torch.randn((2, 2, QWEN_P), generator=gen, device="cuda")
    W = scale_W()
    eta = torch.tensor(SCALE_LR, dtype=torch.float32, device="cuda")
    numbers = {}

    out = fused_consensus_sgd(w, g, W, eta)
    torch.cuda.synchronize()
    err = compare(out, fused_consensus_sgd_plain(w, g, W, eta), "float32",
                  "fused_consensus_sgd main")
    del out
    torch.cuda.empty_cache()
    ms = cuda_ms(lambda: fused_consensus_sgd(w, g, W, eta), iters=10,
                 warmup=2)
    plain_ms = cuda_ms(lambda: fused_consensus_sgd_plain(w, g, W, eta),
                       iters=3)
    library_ms = cuda_ms(
        lambda: torch.bmm(W, torch.add(w, g, alpha=-SCALE_LR)), iters=5,
        warmup=1)
    n = w.numel()
    bytes_moved = 3 * n * w.element_size()
    b_ms, b_by = bound(bytes_moved, n * (2 + 2 * 2))
    log(f"[kernels] fused_consensus_sgd (2, 2, {QWEN_P}) f32: kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, torch.bmm(W, torch.add(w, "
        f"g, alpha=-η)) (two calls) {library_ms:.4f} ms, bound {b_ms:.4f} "
        f"ms ({b_by}: {bytes_moved} B at 3.35 TB/s), kernel at "
        f"{bytes_moved / ms / 1e6:.1f} GB/s, max_abs_err {err:.3e}")
    numbers["fused_consensus_sgd"] = {
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by,
        "max_abs_err_all_shapes": {
            "float32": max(worst["fused_consensus_sgd"]["float32"], err),
            "bfloat16": worst["fused_consensus_sgd"]["bfloat16"]}}

    w2, g2 = w.view(4, QWEN_P), g.view(4, QWEN_P)
    out = fused_sgd(w2, g2, eta)
    torch.cuda.synchronize()
    plain = fused_sgd_plain(w2, g2, eta)
    err = compare(out, plain, "float32", "fused_sgd main")
    assert torch.equal(out, plain), "fused_sgd main: not bitwise equal"
    del out, plain
    torch.cuda.empty_cache()
    # kernel and torch.add in turns (kernel, add, add, kernel, kernel,
    # add), after an untimed turn of each: the first launches after
    # empty_cache map a fresh 7.4 GB output
    calls = {"kernel": lambda: fused_sgd(w2, g2, eta),
             "add": lambda: torch.add(w2, g2, alpha=-SCALE_LR)}
    for fn in calls.values():
        cuda_ms(fn, iters=5)
    order = ("kernel", "add", "add", "kernel", "kernel", "add")
    turns = [cuda_ms(calls[name], iters=20, warmup=2) for name in order]
    ms = sum(t for t, name in zip(turns, order) if name == "kernel") / 3
    library_ms = sum(t for t, name in zip(turns, order) if name == "add") / 3
    plain_ms = cuda_ms(lambda: fused_sgd_plain(w2, g2, eta), iters=3)
    b_ms, b_by = bound(bytes_moved, n * 2)
    log(f"[kernels] fused_sgd (4, {QWEN_P}) f32: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, torch.add(w, g, alpha=-η) {library_ms:.4f} ms "
        f"(in turns: {', '.join(f'{n} {t:.4f}' for n, t in zip(order, turns))}"
        f" ms), bound {b_ms:.4f} ms "
        f"({b_by}: {bytes_moved} B at 3.35 TB/s), kernel at "
        f"{bytes_moved / ms / 1e6:.1f} GB/s, max_abs_err {err:.3e} (bitwise "
        f"equal)")
    numbers["fused_sgd"] = {
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by,
        "max_abs_err_all_shapes": {
            "float32": max(worst["fused_sgd"]["float32"], err),
            "bfloat16": worst["fused_sgd"]["bfloat16"]}}
    del w, g, w2, g2
    torch.cuda.empty_cache()

    # the scale-ssm path's block end: mamba2-370m's flat (4, P) buffer
    w = torch.randn((2, 2, MAMBA2_P), generator=gen, device="cuda")
    g = torch.randn((2, 2, MAMBA2_P), generator=gen, device="cuda")
    out = fused_consensus_sgd(w, g, W, eta)
    torch.cuda.synchronize()
    err = compare(out, fused_consensus_sgd_plain(w, g, W, eta), "float32",
                  "fused_consensus_sgd mamba2")
    del out
    torch.cuda.empty_cache()
    # kernel and the two library calls in turns (kernel, library,
    # library, kernel), after an untimed turn of each
    calls = {"kernel": lambda: fused_consensus_sgd(w, g, W, eta),
             "library": lambda: torch.bmm(W, torch.add(w, g,
                                                       alpha=-SCALE_LR))}
    for fn in calls.values():
        cuda_ms(fn, iters=2)
    order = ("kernel", "library", "library", "kernel")
    turns = [cuda_ms(calls[name], iters=5, warmup=1) for name in order]
    ms = sum(t for t, name in zip(turns, order) if name == "kernel") / 2
    library_ms = sum(t for t, name in zip(turns, order)
                     if name == "library") / 2
    plain_ms = cuda_ms(lambda: fused_consensus_sgd_plain(w, g, W, eta),
                       iters=3)
    n = w.numel()
    bytes_moved = 3 * n * w.element_size()
    b_ms, b_by = bound(bytes_moved, n * (2 + 2 * 2))
    log(f"[kernels] fused_consensus_sgd (2, 2, {MAMBA2_P}) f32 (mamba2-370m"
        f"): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, torch.bmm(W, "
        f"torch.add(w, g, alpha=-η)) (two calls) {library_ms:.4f} ms (in "
        f"turns: {', '.join(f'{n} {t:.4f}' for n, t in zip(order, turns))} "
        f"ms), bound {b_ms:.4f} ms ({b_by}: {bytes_moved} B at 3.35 TB/s), "
        f"kernel at {bytes_moved / ms / 1e6:.1f} GB/s, max_abs_err "
        f"{err:.3e}")
    numbers["fused_consensus_sgd"]["at_mamba2_shape"] = {
        "shape": [2, 2, MAMBA2_P], "max_abs_err": err, "ms": ms,
        "ms_turns": turns, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": b_ms, "bound_by": b_by}
    del w, g
    torch.cuda.empty_cache()
    return numbers


class NumpyDraws:
    """A draw source from one numpy generator: the same indices on any
    device, so a run on the card can be held against a CPU run."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)

    def minibatch(self, num_devices, batch, points):
        import torch
        return torch.from_numpy(
            self.rng.integers(0, points, size=(num_devices, batch)))

    def picks(self, num_clusters, cluster_size, k):
        import torch
        if k == 1:
            return torch.from_numpy(
                self.rng.integers(0, cluster_size, size=(num_clusters,)))
        return torch.from_numpy(np.stack(
            [self.rng.permutation(cluster_size)[:k]
             for _ in range(num_clusters)]))

    def host_seed(self):
        return int(self.rng.integers(0, 2**31 - 1))

    def probe_minibatch(self, num_devices, draws, batch, points, seed):
        import torch
        if not hasattr(self, "probe_rng"):
            self.probe_rng = np.random.default_rng(seed)
        return torch.from_numpy(self.probe_rng.integers(
            0, points, size=(num_devices, draws, batch)))

    def state_dict(self):
        """The generator's state as the bytes of its JSON (a checkpoint
        holds arrays; PCG64's state has 128-bit integers)."""
        blob = json.dumps(self.rng.bit_generator.state).encode()
        return {"rng": np.frombuffer(blob, dtype=np.uint8)}

    def load_state_dict(self, state):
        self.rng.bit_generator.state = json.loads(
            np.asarray(state["rng"], np.uint8).tobytes().decode())


def sim_setup():
    """The paper's Sec. IV setup: 125 devices in 25 geometric clusters,
    ``fashion_synth(12_500)``, 3 labels per device; the NN at hidden
    width 7840 and the SVM."""
    from repro_torch.configs import TopologyConfig
    from repro_torch.data import fashion_synth, partition_noniid_labels
    from repro_torch.models import make_sim_model
    x, y = fashion_synth(num_points=12_500, seed=0)
    data = partition_noniid_labels(x, y, num_devices=125,
                                   labels_per_device=3, seed=0)
    topo = TopologyConfig(num_devices=125, num_clusters=25,
                          graph="geometric", seed=0)
    nn = make_sim_model("nn", data.feature_dim, data.num_classes, 7840)
    svm = make_sim_model("svm", data.feature_dim, data.num_classes)
    return data, topo, nn, svm


def sim_algo(gamma_d2d=2):
    """τ 20, consensus every 5, Γ (-1: Remark-1 adaptive), lr 2e-3."""
    from repro_torch.configs import TTHFConfig
    return TTHFConfig(tau=20, consensus_every=5, gamma_d2d=gamma_d2d,
                      constant_lr=2e-3)


def sim_ledger(tr) -> tuple:
    led = tr.ledger
    return (led.uplinks, led.d2d_msgs, led.d2d_rounds, led.local_steps)


def phase_slice(profile: bool = False) -> dict:
    """The sim path at the paper's size through ``consensus_mix``, held to
    ``masked_loop``, the SVM, adaptive Γ and the CPU. Returns the main
    run's launches and its history and ledger."""
    import torch
    from repro_torch.configs import TopologyConfig
    from repro_torch.core import TTHFTrainer
    from repro_torch.data import fashion_synth, partition_noniid_labels
    from repro_torch.kernels.consensus_mix import consensus_mix
    from repro_torch.models import make_sim_model

    steps, eval_every = 40, 10
    data, topo, nn, svm = sim_setup()
    algo = sim_algo

    def run(model, cfg, run_steps=steps, **kw):
        tr = TTHFTrainer(model, data, topo, cfg, batch_size=16, **kw)
        torch.cuda.synchronize()
        t0 = time.time()
        _, hist = tr.run(steps=run_steps, seed=0, eval_every=eval_every)
        torch.cuda.synchronize()
        return tr, hist, time.time() - t0

    ledger = sim_ledger

    # warm-up (allocator, cuBLAS handles, the kernel's first load) so
    # that the timed runs below compare like with like
    for kw in (dict(use_kernel=True), dict(backend="masked_loop")):
        _, _, wall0 = run(nn, algo(), run_steps=5, **kw)
        log(f"[slice] warm-up nn-7840 {kw}: 5 steps in {wall0:.3f} s")

    # the main path: NN at full width, consensus through the kernel
    torch.cuda.reset_peak_memory_stats()
    consensus_mix.launches = 0
    tr, hist, wall = run(nn, algo(), use_kernel=True)
    launches = consensus_mix.launches
    peak = torch.cuda.max_memory_allocated()
    events = steps // tr.algo.consensus_every
    assert tr.backend == "pallas" and tr.device.type == "cuda"
    assert tr.model_dim == 6_232_810, tr.model_dim
    assert np.isfinite(hist.global_loss).all(), hist.global_loss
    # one launch per parameter leaf (b1, b2, w1, w2) per consensus event
    assert launches == events * 4 == 32, launches
    log(f"[slice] nn-7840 kernel: {steps} steps in {wall:.3f} s = "
        f"{steps / wall:.3f} steps/s, loss {hist.global_loss}, acc "
        f"{hist.global_acc}, ledger {ledger(tr)}, launches {launches}, "
        f"max_memory_allocated {peak} B")

    # the same run through the masked_loop backend, timed in turns
    # (kernel, masked_loop, masked_loop, kernel)
    consensus_mix.launches = 0
    tr2, hist2, wall2 = run(nn, algo(), backend="masked_loop")
    _, _, wall2b = run(nn, algo(), backend="masked_loop")
    assert consensus_mix.launches == 0
    np.testing.assert_allclose(hist2.global_loss, hist.global_loss, rtol=1e-4)
    assert ledger(tr2) == ledger(tr)
    assert [g.tolist() for g in hist2.gamma_used] == \
        [g.tolist() for g in hist.gamma_used]
    _, _, wallb = run(nn, algo(), use_kernel=True)
    log(f"[slice] nn-7840 masked_loop: loss {hist2.global_loss} (rtol 1e-4 "
        f"vs the kernel run), same ledger and gamma_used")
    log(f"[slice] nn-7840 steps/s in turns: kernel {steps / wall:.3f}, "
        f"masked_loop {steps / wall2:.3f}, masked_loop {steps / wall2b:.3f}, "
        f"kernel {steps / wallb:.3f}")

    consensus_mix.launches = 0
    tr3, hist3, wall3 = run(svm, algo(), use_kernel=True)
    assert np.isfinite(hist3.global_loss).all()
    assert consensus_mix.launches == events * 2, consensus_mix.launches
    log(f"[slice] svm kernel: {steps / wall3:.3f} steps/s, loss "
        f"{hist3.global_loss}, ledger {ledger(tr3)}")

    consensus_mix.launches = 0
    tr4, hist4, wall4 = run(nn, algo(gamma_d2d=-1), use_kernel=True)
    assert np.isfinite(hist4.global_loss).all()
    assert consensus_mix.launches == 32, consensus_mix.launches
    log(f"[slice] nn-7840 adaptive Γ kernel: {steps / wall4:.3f} steps/s, "
        f"loss {hist4.global_loss}, gamma_used "
        f"{[g.tolist() for g in hist4.gamma_used]}, ledger {ledger(tr4)}")
    # the kernel at the Γ this rule gives it, against the plain rounds
    tr5, hist5, wall5 = run(nn, algo(gamma_d2d=-1), backend="masked_loop")
    np.testing.assert_allclose(hist5.global_loss, hist4.global_loss,
                               rtol=1e-4)
    assert ledger(tr5) == ledger(tr4)
    assert [g.tolist() for g in hist5.gamma_used] == \
        [g.tolist() for g in hist4.gamma_used]
    log(f"[slice] nn-7840 adaptive Γ masked_loop: {steps / wall5:.3f} "
        f"steps/s, loss {hist5.global_loss} (rtol 1e-4 vs the kernel run), "
        f"same ledger and gamma_used")

    # the card against the CPU on a small input: same data, weights
    # and draws; the CPU run takes the plain versions of the kernels
    xs, ys = fashion_synth(num_points=2000, seed=1)
    small = partition_noniid_labels(xs, ys, num_devices=25, seed=1)
    stopo = TopologyConfig(num_devices=25, num_clusters=5, seed=1)
    snn = make_sim_model("nn", 784, 10, 64)
    w0 = snn.init(torch.Generator().manual_seed(1), "cpu")
    hists = []
    for dev in ("cuda", "cpu"):
        t = TTHFTrainer(snn, small, stopo, algo(), batch_size=8,
                        use_kernel=True, device=dev)
        st = t.init(1, w0=w0, draws=NumpyDraws(1))
        hists.append(t.run(steps=40, eval_every=10, state=st)[1])
    np.testing.assert_allclose(hists[0].global_loss, hists[1].global_loss,
                               rtol=1e-4)
    assert [g.tolist() for g in hists[0].gamma_used] == \
        [g.tolist() for g in hists[1].gamma_used]
    log(f"[slice] small nn on cuda vs cpu: loss {hists[0].global_loss} vs "
        f"{hists[1].global_loss} (rtol 1e-4), same gamma_used")
    if profile:
        profile_main_path(lambda: run(nn, algo(), use_kernel=True,
                                      run_steps=20)[2], "20 sim steps")
    return {"launches": launches, "global_loss": hist.global_loss,
            "global_acc": hist.global_acc, "ledger": ledger(tr),
            "gamma_used": [g.tolist() for g in hist.gamma_used]}


NETSIM_SCENARIOS = ("markov_links", "device_churn", "stragglers",
                    "flash_crowd")


def phase_slice_netsim(plain_run: dict, profile: bool = False) -> int:
    """The sim path at the paper's size under the four dynamic netsim
    scenarios, 60 steps each (flash_crowd's half of the fleet leaves at
    30 and returns at 50): each consensus event through ``consensus_mix``
    with the event's V, held to ``masked_loop`` on the card (loss rtol
    1e-4; gamma_used, active_devices and the ledger exactly); and the
    ``static`` scenario equal to ``phase_slice``'s run without one.
    Returns the kernel runs' launches."""
    import torch
    from repro_torch.core import TTHFTrainer
    from repro_torch.kernels.consensus_mix import consensus_mix
    from repro_torch.netsim import scenarios

    steps, eval_every = 60, 10
    data, topo, nn, _ = sim_setup()

    def run(name, run_steps=steps, **kw):
        tr = TTHFTrainer(nn, data, topo, sim_algo(), batch_size=16,
                         dynamics=scenarios.get(name, seed=0), **kw)
        torch.cuda.synchronize()
        t0 = time.time()
        _, hist = tr.run(steps=run_steps, seed=0, eval_every=eval_every)
        torch.cuda.synchronize()
        return tr, hist, time.time() - t0

    # static: the run of phase_slice, exactly (40 steps, the same eval
    # calendar)
    consensus_mix.launches = 0
    tr, hist, wall = run("static", run_steps=40, use_kernel=True)
    assert tr.tvnet is None and consensus_mix.launches == 32
    assert hist.global_loss == plain_run["global_loss"], \
        (hist.global_loss, plain_run["global_loss"])
    assert hist.global_acc == plain_run["global_acc"]
    assert sim_ledger(tr) == plain_run["ledger"]
    log(f"[slice-netsim] static: 40 steps in {wall:.3f} s, loss "
        f"{hist.global_loss}: equal to the [slice] run without a scenario")
    # warm-up of the dynamic path (its masked step, the weighted
    # aggregation) on both backends
    for kw in (dict(use_kernel=True), dict(backend="masked_loop")):
        _, _, wall0 = run("device_churn", run_steps=5, **kw)
        log(f"[slice-netsim] warm-up device_churn {kw}: 5 steps in "
            f"{wall0:.3f} s")

    total = 0
    events = steps // sim_algo().consensus_every
    for name in NETSIM_SCENARIOS:
        torch.cuda.reset_peak_memory_stats()
        consensus_mix.launches = 0
        tr, hist, wall = run(name, use_kernel=True)
        launches = consensus_mix.launches
        peak = torch.cuda.max_memory_allocated()
        assert tr.backend == "pallas" and tr.tvnet is not None
        assert np.isfinite(hist.global_loss).all(), (name, hist.global_loss)
        # one launch per parameter leaf per consensus event, whatever V
        assert launches == events * 4, (name, launches)
        total += launches
        torch.cuda.reset_peak_memory_stats()
        tr2, hist2, wall2 = run(name, backend="masked_loop")
        peak2 = torch.cuda.max_memory_allocated()
        assert consensus_mix.launches == launches
        np.testing.assert_allclose(hist2.global_loss, hist.global_loss,
                                   rtol=1e-4)
        assert [g.tolist() for g in hist2.gamma_used] == \
            [g.tolist() for g in hist.gamma_used], name
        assert hist2.active_devices == hist.active_devices, name
        assert sim_ledger(tr2) == sim_ledger(tr), name
        assert tr2.ledger.delay(0.1) == tr.ledger.delay(0.1), name
        if name == "flash_crowd":
            fleet = data.num_devices
            assert min(hist.active_devices) < fleet, hist.active_devices
            assert hist.active_devices[-1] == fleet, hist.active_devices
        log(f"[slice-netsim] {name}: kernel {steps} steps in {wall:.3f} s = "
            f"{steps / wall:.3f} steps/s, consensus_mix launches {launches},"
            f" max_memory_allocated {peak} B; masked_loop {steps / wall2:.3f}"
            f" steps/s, max_memory_allocated {peak2} B; loss "
            f"{hist.global_loss} (masked_loop within rtol 1e-4), "
            f"active_devices {hist.active_devices}, gamma_used (last) "
            f"{hist.gamma_used[-1].tolist()}, ledger {sim_ledger(tr)}, "
            f"delay@0.1 {tr.ledger.delay(0.1):.3f} s (the same on both)")
        if profile and name == "device_churn":
            profile_main_path(lambda: run(name, use_kernel=True,
                                          run_steps=20)[2],
                              "20 sim steps under device_churn")
    return total


FOG_PRESETS = ("flat", "fog3", "fog4", "fog3_sampled")
SIM_SCENARIOS = (None, "device_churn")
# the sim steps of each policy's runs in [slice-control]: connectivity's
# gradient probe takes some 18 s an aggregation at the paper's width (15.6
# GB of gradients to the host and the estimators in numpy), and its τ law
# moves the calendar to an aggregation every 5 or 10 steps, so its runs
# are cut to 25 steps (one aggregation, at 20, and its retuned τ)
CONTROL_POLICIES = {"remark1": 80, "connectivity": 25}


def sim_program_run(setup, program, run_steps, eval_every=10, **kw):
    """One NN ``TTHFTrainer`` run of ``sim_setup()``'s ``setup`` under a
    round ``program``, recording the iterations that aggregate and every
    decision the controller opens. Returns the trainer, its state and
    history, the wall time, the aggregation iterations and the
    decisions."""
    import torch
    from repro_torch.core import TTHFTrainer
    data, topo, nn, _ = setup
    tr = TTHFTrainer(nn, data, topo, sim_algo(), batch_size=16,
                     program=program, **kw)
    res, aggs, decs = tr._resolver, [], []
    resolve = res.resolve

    def record(t, *args):
        ev = resolve(t, *args)
        if ev.aggregation is not None:
            aggs.append(t)
        if ev.control is not None and (not decs or decs[-1] is not
                                       ev.control):
            decs.append(ev.control)
        return ev
    res.resolve = record
    torch.cuda.synchronize()
    t0 = time.time()
    st, hist = tr.run(steps=run_steps, seed=0, eval_every=eval_every)
    torch.cuda.synchronize()
    return tr, st, hist, time.time() - t0, aggs, decs


def sim_hold(name, tr, hist, tr2, hist2) -> None:
    """A kernel run held to the same run through ``masked_loop``: loss
    rtol 1e-4; gamma_used, active_devices and the ledger exactly."""
    np.testing.assert_allclose(hist2.global_loss, hist.global_loss,
                               rtol=1e-4)
    assert [g.tolist() for g in hist2.gamma_used] == \
        [g.tolist() for g in hist.gamma_used], name
    assert hist2.active_devices == hist.active_devices, name
    assert sim_ledger(tr2) == sim_ledger(tr), name
    assert tr2.ledger.uplinks_by_level == tr.ledger.uplinks_by_level, name
    assert tr2.ledger.delay(0.1) == tr.ledger.delay(0.1), name


def sim_equals_plain(tag, hist, tr, plain_run) -> None:
    """A 40-step run equal to ``phase_slice``'s run, exactly."""
    assert hist.global_loss == plain_run["global_loss"], \
        (tag, hist.global_loss, plain_run["global_loss"])
    assert hist.global_acc == plain_run["global_acc"], tag
    assert sim_ledger(tr) == plain_run["ledger"], tag


def phase_slice_fog(plain_run: dict) -> int:
    """The sim path at the paper's size under the four fog presets, each
    on the static topology and under ``device_churn``, 80 steps (fog4's
    root fires at 80): each consensus event through ``consensus_mix``,
    each aggregation one composed (I, I) device matrix on every leaf,
    held to ``masked_loop``; ``flat`` for 40 steps equal to
    ``phase_slice``'s run. Returns the kernel runs' launches."""
    import torch
    from repro_torch.hierarchy import aggregate, presets
    from repro_torch.kernels.consensus_mix import consensus_mix
    from repro_torch.netsim import scenarios
    from repro_torch.rounds import RoundProgram

    steps = 80
    tau = sim_algo().tau
    events = steps // sim_algo().consensus_every
    setup = sim_setup()

    def program(name, scenario):
        return RoundProgram(
            dynamics=scenarios.get(scenario, seed=0) if scenario else None,
            hierarchy=presets.get(name, tau=tau))

    consensus_mix.launches = 0
    tr, _, hist, wall, _, _ = sim_program_run(setup, program("flat", None),
                                              40, use_kernel=True)
    assert tr.tree is None and consensus_mix.launches == 32
    sim_equals_plain("[slice-fog] flat", hist, tr, plain_run)
    log(f"[slice-fog] flat: 40 steps in {wall:.3f} s, loss "
        f"{hist.global_loss}: equal to the [slice] run without a hierarchy")
    # warm-up of the matrix form (cuBLAS at (125, 125) x (125, M)) on
    # both backends
    for kw in (dict(use_kernel=True), dict(backend="masked_loop")):
        wall0 = sim_program_run(setup, program("fog3", "device_churn"), 20,
                                **kw)[3]
        log(f"[slice-fog] warm-up fog3 under device_churn {kw}: 20 steps "
            f"in {wall0:.3f} s")

    total = 0
    for name in FOG_PRESETS:
        for scenario in SIM_SCENARIOS:
            tag = f"{name}/{scenario or 'static'}"
            prog = program(name, scenario)
            torch.cuda.reset_peak_memory_stats()
            consensus_mix.launches = 0
            tr, st, hist, wall, aggs, _ = sim_program_run(
                setup, prog, steps, use_kernel=True)
            launches = consensus_mix.launches
            peak = torch.cuda.max_memory_allocated()
            assert tr.backend == "pallas", tag
            assert np.isfinite(hist.global_loss).all(), (tag,
                                                         hist.global_loss)
            # one launch per parameter leaf per consensus event
            assert launches == events * 4, (tag, launches)
            total += launches
            levels = tr.ledger.uplinks_by_level
            if name != "flat":
                assert tr.tree is not None and 2 in levels, (tag, levels)
            if name == "fog4":
                assert 3 in levels, (tag, levels)
            # the (I, I) product's share: its device time at this run's
            # fleet times the run's matrix events, over the wall time
            share = ""
            if tr.tree is not None:
                ev = aggregate.build_event(
                    np.random.default_rng(0), tr.tree, tr.hierarchy, steps,
                    np.ones((tr.net.num_clusters, tr.net.cluster_size),
                            bool))
                M = torch.as_tensor(ev.device_matrix, device=tr.device)
                ms = cuda_ms(lambda: aggregate.apply_device_matrix_pytree(
                    st.params, M), 3)
                share = (f", (I, I) product {ms:.3f} ms x {len(aggs)} = "
                         f"{ms * len(aggs) / 1e3 / wall:.4f} of the wall")
            del st
            torch.cuda.reset_peak_memory_stats()
            tr2, st2, hist2, wall2, aggs2, _ = sim_program_run(
                setup, prog, steps, backend="masked_loop")
            peak2 = torch.cuda.max_memory_allocated()
            del st2
            assert consensus_mix.launches == launches
            assert aggs2 == aggs, (tag, aggs, aggs2)
            sim_hold(tag, tr, hist, tr2, hist2)
            log(f"[slice-fog] {tag}: kernel {steps} steps in {wall:.3f} s = "
                f"{steps / wall:.3f} steps/s, consensus_mix launches "
                f"{launches}, max_memory_allocated {peak} B; masked_loop "
                f"{steps / wall2:.3f} steps/s, max_memory_allocated {peak2} "
                f"B; loss {hist.global_loss} (masked_loop within rtol "
                f"1e-4), aggregations at {aggs}, uplinks_by_level "
                f"{dict(levels)}, active_devices {hist.active_devices}, "
                f"ledger {sim_ledger(tr)}{share}")
            torch.cuda.empty_cache()
    return total


def phase_slice_control(plain_run: dict) -> int:
    """The sim path at the paper's size under the ``remark1`` and
    ``connectivity`` policies, each on the static topology and under
    ``device_churn``: Γ from the controller at each consensus event
    through ``consensus_mix``, τ retuned at each aggregation
    (``connectivity``) after the gradient probe, held to ``masked_loop``
    (loss rtol 1e-4; gamma_used, active_devices, the ledger, the
    aggregation calendar and every decision's Γ, τ, safe and fallback
    exactly); the ``static`` policy for 40 steps equal to
    ``phase_slice``'s run. The runs take ``CONTROL_POLICIES``' steps.
    Returns the kernel runs' launches."""
    import torch
    from repro_torch.configs.base import ControlConfig
    from repro_torch.control import get_policy
    from repro_torch.kernels.consensus_mix import consensus_mix
    from repro_torch.netsim import scenarios
    from repro_torch.rounds import RoundProgram

    setup = sim_setup()

    def program(policy, scenario):
        return RoundProgram(
            dynamics=scenarios.get(scenario, seed=0) if scenario else None,
            control=get_policy(policy) if policy else ControlConfig())

    consensus_mix.launches = 0
    tr, _, hist, wall, _, _ = sim_program_run(setup, program(None, None),
                                              40, use_kernel=True)
    assert tr._resolver.controller is None and consensus_mix.launches == 32
    sim_equals_plain("[slice-control] static", hist, tr, plain_run)
    log(f"[slice-control] static policy: 40 steps in {wall:.3f} s, loss "
        f"{hist.global_loss}: equal to the [slice] run without one")

    def probed():
        """A list the probe's times and card peaks go to, the trainer's
        ``_observe_control_grads`` and its timed stand-in (host work
        included)."""
        probes = []
        orig = TTHFTrainer._observe_control_grads

        def timed(self, st):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            t0 = time.time()
            orig(self, st)
            torch.cuda.synchronize()
            probes.append((time.time() - t0,
                           torch.cuda.max_memory_allocated() - base))
        return probes, orig, timed

    def decisions(decs):
        return [(d.t, d.safe, d.fallback, np.asarray(d.gammas).tolist()
                 if d.gammas is not None else None, d.tau_next)
                for d in decs]

    from repro_torch.core import TTHFTrainer
    total = 0
    for policy, steps in CONTROL_POLICIES.items():
        events = steps // sim_algo().consensus_every
        for scenario in SIM_SCENARIOS:
            tag = f"{policy}/{scenario or 'static'}"
            prog = program(policy, scenario)
            runs = []
            for kw in (dict(use_kernel=True), dict(backend="masked_loop")):
                probes, orig, timed = probed()
                TTHFTrainer._observe_control_grads = timed
                try:
                    torch.cuda.reset_peak_memory_stats()
                    consensus_mix.launches = 0
                    out = sim_program_run(setup, prog, steps, **kw)
                finally:
                    TTHFTrainer._observe_control_grads = orig
                runs.append(out + (consensus_mix.launches,
                                   torch.cuda.max_memory_allocated(),
                                   probes))
            (tr, st, hist, wall, aggs, decs, launches, peak, probes), \
                (tr2, st2, hist2, wall2, aggs2, decs2, launches2, peak2,
                 probes2) = runs
            del st, st2
            assert np.isfinite(hist.global_loss).all(), (tag,
                                                         hist.global_loss)
            assert launches == events * 4, (tag, launches)
            assert launches2 == 0, (tag, launches2)
            total += launches
            ctl = tr._resolver.controller
            assert ctl is not None and ctl.counters()["fallbacks"] == 0, tag
            assert aggs2 == aggs, (tag, aggs, aggs2)
            assert decisions(decs2) == decisions(decs), tag
            sim_hold(tag, tr, hist, tr2, hist2)
            if policy == "connectivity":
                assert len(probes) == len(aggs) > 0, (tag, probes, aggs)
            else:
                assert not probes, tag
            taus = [d.tau_next for d in decs if d.tau_next is not None]
            probe = ""
            if probes:
                secs = [p[0] for p in probes]
                probe = (f", probe {np.mean(secs):.3f} s per aggregation "
                         f"({[round(x, 3) for x in secs]}; masked_loop run "
                         f"{np.mean([p[0] for p in probes2]):.3f} s), its "
                         f"card peak above the fleet "
                         f"{max(p[1] for p in probes)} B")
            log(f"[slice-control] {tag}: kernel {steps} steps in {wall:.3f} "
                f"s = {steps / wall:.3f} steps/s, consensus_mix launches "
                f"{launches}, max_memory_allocated {peak} B; masked_loop "
                f"{steps / wall2:.3f} steps/s, max_memory_allocated {peak2} "
                f"B; loss {hist.global_loss} (masked_loop within rtol "
                f"1e-4), aggregations at {aggs}, tau_next {taus}, Γ per "
                f"event {[d[3] for d in decisions(decs)]}, delta_hat "
                f"{decs[-1].delta_hat}, sigma_hat {decs[-1].sigma_hat}, "
                f"active_devices {hist.active_devices}, ledger "
                f"{sim_ledger(tr)}{probe}")
            torch.cuda.empty_cache()
    return total


def scale_forms_programs() -> dict:
    """(a) fog3 under device_churn: the matrix form, refreshes, the root
    event; (b) connectivity under device_churn: the weights form and a Γ
    retuned per interval."""
    from repro_torch.control import get_policy
    from repro_torch.hierarchy import presets
    from repro_torch.netsim import scenarios
    from repro_torch.rounds import RoundProgram
    churn = scenarios.get("device_churn", seed=0)
    return {"fog3-churn": RoundProgram(
                hierarchy=presets.get("fog3", tau=20), dynamics=churn),
            "connectivity-churn": RoundProgram(
                control=get_policy("connectivity"), dynamics=churn)}


def scale_forms_config():
    """The scale CLI's τ 20, consensus every 5, Γ 2 and lr, at 8
    replicas in ring clusters of 2 (N 4)."""
    from repro_torch.core.distributed import TTHFScaleConfig
    return TTHFScaleConfig(replicas=8, cluster_size=2, tau=20,
                           consensus_every=5, gamma_d2d=2, lr=SCALE_LR)


def phase_scale_forms(intervals: int = 2, warm_up: bool = True) -> int:
    """ScaleTrainer on qwen1.5-0.5b at full width and a cut depth
    (``SCALE_FORMS_LAYERS``) at 8 replicas under the two programs of
    ``scale_forms_programs``: the fused interval through
    ``fused_consensus_sgd`` with each interval's refreshed W (4 launches
    an interval), the per-leaf step held to it (loss rtol 1e-4, the same
    ledger, the served global model within atol 1e-5). ``warm_up``: one
    interval first (not needed after ``phase_scale``, which runs the same
    per-replica shapes through the same kernel). Returns the fused runs'
    launches."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels.consensus_mix import consensus_mix
    from repro_torch.kernels.fused_consensus_sgd import fused_consensus_sgd
    from repro_torch.kernels.fused_sgd import fused_sgd
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_leaves

    cfg = dataclasses.replace(get_arch("qwen1.5-0.5b"),
                              num_layers=SCALE_FORMS_LAYERS)
    scale = scale_forms_config()
    tokens = intervals * scale.tau * scale.replicas * SCALE_BATCH * 128
    w0 = build_model(cfg).init(
        torch.Generator(device="cuda").manual_seed(0), "cuda")
    programs = scale_forms_programs()

    def run(name, fused, n, tag):
        events = []
        from repro_torch.rounds import RoundResolver
        orig = RoundResolver.resolve_interval

        def record(self, interval, draws):
            ev = orig(self, interval, draws)
            events.append(ev)
            return ev
        RoundResolver.resolve_interval = record
        try:
            out = scale_run(cfg, scale, fused, n, tag, weights=w0,
                            program=programs[name])
        finally:
            RoundResolver.resolve_interval = orig
        return out + (events,)

    if warm_up:
        tr, losses, wall, _, _ = run("fog3-churn", True, 1, "forms_warmup")
        log(f"[scale-forms] warm-up fog3 under device_churn, fused interval "
            f"at 8 replicas: 1 interval in {wall:.3f} s, loss {losses}")
        del tr
        torch.cuda.empty_cache()

    total = 0
    for name in programs:
        torch.cuda.reset_peak_memory_stats()
        fused_consensus_sgd.launches = consensus_mix.launches = 0
        fused_sgd.launches = 0
        tr, losses, wall, ledger, evs = run(name, True, intervals,
                                            f"forms_{name}_fused")
        launches = fused_consensus_sgd.launches
        peak = torch.cuda.max_memory_allocated()
        assert np.isfinite(losses).all() and len(losses) == intervals, \
            (name, losses)
        # one launch per consensus block, each with the interval's W
        assert launches == intervals * scale.tau // scale.consensus_every, \
            (name, launches)
        assert consensus_mix.launches == fused_sgd.launches == 0
        assert all(ev.refresh is not None for ev in evs), name
        total += launches
        assert tr._spec.total == SCALE_FORMS_P, tr._spec.total
        served = [l.clone() for l in tree_leaves(tr._global_params())]
        levels = dict(tr.ledger.uplinks_by_level)
        gammas = [np.asarray(ev.billing.consensus_gammas).tolist()
                  for ev in evs]
        if name == "fog3-churn":
            assert tr.tree is not None and evs[-1].root_served, name
            assert 2 in levels, levels
        else:
            assert tr._resolver.controller.decisions == intervals
        log(f"[scale-forms] {name}: fused interval, {intervals} intervals "
            f"in {wall:.3f} s = {intervals / wall:.4f} intervals/s, "
            f"{tokens / wall:.1f} tokens/s, loss {losses}, ledger {ledger}, "
            f"uplinks_by_level {levels}, Γ per interval {gammas}, root "
            f"served {[ev.root_served for ev in evs]}, fused_consensus_sgd "
            f"launches {launches}, max_memory_allocated {peak} B")
        del tr
        torch.cuda.empty_cache()

        torch.cuda.reset_peak_memory_stats()
        fused_consensus_sgd.launches = 0
        tr2, losses2, wall2, ledger2, evs2 = run(name, False, intervals,
                                                 f"forms_{name}_perleaf")
        peak2 = torch.cuda.max_memory_allocated()
        assert fused_consensus_sgd.launches == 0
        np.testing.assert_allclose(losses2, losses, rtol=1e-4)
        assert ledger2 == ledger, (name, ledger2, ledger)
        diff = max(float((a - b).abs().max()) for a, b in zip(
            tree_leaves(tr2._global_params()), served))
        assert diff <= 1e-5, (name, diff)
        log(f"[scale-forms] {name}: per-leaf step, {intervals} intervals in "
            f"{wall2:.3f} s = {tokens / wall2:.1f} tokens/s, loss {losses2} "
            f"(rtol 1e-4 vs the fused run), same ledger, "
            f"max_memory_allocated {peak2} B, served model "
            f"({SCALE_FORMS_P} parameters, {SCALE_FORMS_LAYERS} layers) max "
            f"|diff| {diff:.3e} (atol 1e-5)")
        del tr2, served
        torch.cuda.empty_cache()
    del w0
    torch.cuda.empty_cache()
    return total


def read_losses(path: Path) -> list:
    """The per-interval train losses a run's metric log wrote."""
    return [json.loads(line)["train_loss"]
            for line in path.read_text().splitlines()]


def scale_cli_config():
    """The scale CLI's defaults: 4 replicas in ring clusters of 2, τ 20,
    consensus every 5, Γ 2, lr 2e-3."""
    from repro_torch.core.distributed import TTHFScaleConfig
    return TTHFScaleConfig(replicas=4, cluster_size=2, tau=20,
                           consensus_every=5, gamma_d2d=2, lr=SCALE_LR)


def scale_run(c, sc, fused: bool, intervals: int, name: str, *,
              batch=SCALE_BATCH, seq=128, device="cuda", weights=None,
              seed=0, program=None):
    """One ``ScaleTrainer`` run from ``weights`` with numpy draws (under
    the round ``program``, if given); its metric log goes to
    chiprun_out/scale_<name>.jsonl. Returns the trainer, the per-interval
    losses, the wall time and the ledger."""
    import torch
    from repro_torch.train import ScaleTrainer, TrainerConfig
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    log_path = out_dir / f"scale_{name}.jsonl"
    log_path.unlink(missing_ok=True)
    tr = ScaleTrainer(c, sc, TrainerConfig(
        batch_per_replica=batch, seq_len=seq, intervals=intervals,
        eval_every=0, seed=0, fused_interval=fused,
        log_path=str(log_path)), program=program, device=device)
    tr.init(w0=weights, draws=NumpyDraws(seed))
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.time()
    tr.run()
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.time() - t0
    tr.close()
    led = tr.ledger
    return tr, read_losses(log_path), wall, (
        led.uplinks, led.d2d_msgs, led.d2d_rounds, led.local_steps)


def phase_scale(profile: bool = False) -> tuple:
    """ScaleTrainer on the full-size qwen1.5-0.5b: the fused interval
    (the main path, through fused_consensus_sgd), the per-leaf step held
    to it, and a reduced run on the card held to the CPU. Returns each
    kernel's launches in the main path's run, and that run's losses,
    global model (on the host), ledger and wall with the warm-up's
    losses and global model (the bare runs ``[obs]`` is held to)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core.distributed import TTHFScaleConfig
    from repro_torch.kernels.consensus_mix import consensus_mix
    from repro_torch.kernels.fused_consensus_sgd import fused_consensus_sgd
    from repro_torch.kernels.fused_sgd import fused_sgd
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_leaves

    cfg = get_arch("qwen1.5-0.5b")
    scale = scale_cli_config()
    tokens_per_interval = scale.tau * scale.replicas * SCALE_BATCH * 128
    w0 = build_model(cfg).init(
        torch.Generator(device="cuda").manual_seed(0), "cuda")

    def run(fused: bool, intervals: int, name: str, c=cfg, sc=scale,
            weights=w0, **kw):
        return scale_run(c, sc, fused, intervals, name, weights=weights,
                         **kw)

    # warm-up: allocator, cuBLAS handles, the kernel's first load
    tr, losses, wall, _ = run(True, 1, "warmup")
    log(f"[scale] warm-up qwen1.5-0.5b fused interval: 1 interval in "
        f"{wall:.3f} s, loss {losses}")
    # kept on the host for [obs]: a bare 1-interval run to hold another to
    warm = {"losses": losses, "row0": tr.params[0].cpu()}
    del tr
    torch.cuda.empty_cache()

    # the main path: the fused interval through fused_consensus_sgd
    torch.cuda.reset_peak_memory_stats()
    fused_consensus_sgd.launches = 0
    consensus_mix.launches = 0
    fused_sgd.launches = 0
    tr, losses, wall, ledger = run(True, 2, "fused")
    launches = {"fused_consensus_sgd": fused_consensus_sgd.launches,
                "fused_sgd": fused_sgd.launches}
    peak = torch.cuda.max_memory_allocated()
    assert tr._spec.total == QWEN_P, tr._spec.total
    assert np.isfinite(losses).all() and len(losses) == 2, losses
    # one launch per consensus block: 4 blocks per interval
    assert launches["fused_consensus_sgd"] == 8, launches
    # no trainer calls fused_sgd, in the reference or in the port
    assert launches["fused_sgd"] == 0, launches
    assert consensus_mix.launches == 0
    # the global model, replica 0's row of the flat (R, P) buffer
    g_fused = tr.params[0].clone()
    spec = tr._spec
    bare = {"losses": losses, "row0": g_fused.cpu(), "ledger": ledger,
            "wall": wall, "warm": warm}
    log(f"[scale] qwen1.5-0.5b fused interval: 2 intervals in {wall:.3f} s "
        f"= {2 / wall:.4f} intervals/s, {2 * tokens_per_interval / wall:.1f} "
        f"tokens/s, loss {losses}, ledger {ledger}, fused_consensus_sgd "
        f"launches {launches['fused_consensus_sgd']}, fused_sgd launches "
        f"{launches['fused_sgd']}, max_memory_allocated {peak} B")
    del tr
    torch.cuda.empty_cache()
    if profile:
        profile_main_path(lambda: run(True, 1, "profile")[2],
                          "1 scale interval (fused)")
        torch.cuda.empty_cache()

    # the same run through the per-leaf step (fused_power einsum)
    fused_consensus_sgd.launches = 0
    torch.cuda.reset_peak_memory_stats()
    tr2, losses2, wall2, ledger2 = run(False, 2, "perleaf")
    peak2 = torch.cuda.max_memory_allocated()
    assert fused_consensus_sgd.launches == 0
    np.testing.assert_allclose(losses2, losses, rtol=1e-4)
    assert ledger2 == ledger, (ledger2, ledger)
    # every parameter of the global model, leaf by leaf (params atol
    # 1e-5, as the CPU tests hold the two steps)
    diff = max(float((a - b).abs().max()) for a, b in zip(
        tree_leaves(tr2._global_params()),
        spec.leaf_views(g_fused)))
    assert diff <= 1e-5, diff
    log(f"[scale] qwen1.5-0.5b per-leaf step: 2 intervals in {wall2:.3f} s "
        f"= {2 / wall2:.4f} intervals/s, loss {losses2} (rtol 1e-4 vs the "
        f"fused run), same ledger, max_memory_allocated {peak2} B, global "
        f"model ({QWEN_P} parameters) max |diff| {diff:.3e} (atol 1e-5)")
    del tr2, g_fused
    torch.cuda.empty_cache()
    if profile:
        profile_main_path(lambda: run(False, 1, "profile_perleaf")[2],
                          "1 scale interval (per-leaf)")
    del w0
    torch.cuda.empty_cache()

    # the card against the CPU on a reduced qwen: same weights and draws;
    # the CPU run takes the kernel's plain version
    small = cfg.reduced()
    ssc = TTHFScaleConfig(replicas=4, cluster_size=2, tau=4,
                          consensus_every=2, gamma_d2d=2, lr=0.05)
    sw0 = build_model(small).init(torch.Generator().manual_seed(1), "cpu")
    fused_consensus_sgd.launches = 0
    kw = dict(c=small, sc=ssc, batch=2, seq=32, weights=sw0, seed=1)
    _, l_gpu, _, led_gpu = run(True, 2, "small_cuda", device="cuda", **kw)
    assert fused_consensus_sgd.launches == 4, fused_consensus_sgd.launches
    _, l_cpu, _, led_cpu = run(True, 2, "small_cpu", device="cpu", **kw)
    np.testing.assert_allclose(l_gpu, l_cpu, rtol=1e-4)
    assert led_gpu == led_cpu
    log(f"[scale] reduced qwen on cuda vs cpu: loss {l_gpu} vs {l_cpu} "
        f"(rtol 1e-4), same ledger {led_gpu}")
    return launches, bare


def phase_scale_ssm(profile: bool = False) -> int:
    """ScaleTrainer on mamba2-370m at full width and a cut depth
    (``SCALE_SSM_LAYERS``; the ssm kind; the training gradient runs
    through the plain chunked scan, ssd_scan being forward only): the
    fused interval (through fused_consensus_sgd), the per-leaf step held
    to it, and a reduced mamba2 on the card held to the CPU. Returns the fused run's fused_consensus_sgd launches."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core.distributed import TTHFScaleConfig
    from repro_torch.kernels.consensus_mix import consensus_mix
    from repro_torch.kernels.fused_consensus_sgd import fused_consensus_sgd
    from repro_torch.kernels.fused_sgd import fused_sgd
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_leaves

    cfg = dataclasses.replace(get_arch("mamba2-370m"),
                              num_layers=SCALE_SSM_LAYERS)
    assert (cfg.kind, cfg.d_model) == ("ssm", 1024)
    scale = scale_cli_config()
    tokens_per_interval = scale.tau * scale.replicas * SCALE_BATCH * 128
    w0 = build_model(cfg).init(
        torch.Generator(device="cuda").manual_seed(0), "cuda")

    def counters():
        return (fused_consensus_sgd.launches, consensus_mix.launches,
                fused_sgd.launches, ssd_scan.launches)

    tr, losses, wall, _ = scale_run(cfg, scale, True, 1, "ssm_warmup",
                                    weights=w0)
    log(f"[scale-ssm] warm-up mamba2-370m fused interval: 1 interval in "
        f"{wall:.3f} s, loss {losses}")
    del tr
    torch.cuda.empty_cache()

    # the path: the fused interval through fused_consensus_sgd
    torch.cuda.reset_peak_memory_stats()
    fused_consensus_sgd.launches = consensus_mix.launches = 0
    fused_sgd.launches = ssd_scan.launches = 0
    tr, losses, wall, ledger = scale_run(cfg, scale, True, 2, "ssm_fused",
                                         weights=w0)
    launches, mixes, sgds, scans = counters()
    peak = torch.cuda.max_memory_allocated()
    assert tr._spec.total == tr._spec.padded == SCALE_SSM_P, tr._spec.total
    assert np.isfinite(losses).all() and len(losses) == 2, losses
    # one launch per consensus block (4 a interval); the gradient goes
    # through the plain scan, and no other kernel runs
    assert (launches, mixes, sgds, scans) == (8, 0, 0, 0), counters()
    g_fused = tr.params[0].clone()
    spec = tr._spec
    log(f"[scale-ssm] mamba2-370m ({cfg.num_layers} layers) fused interval: "
        f"2 intervals in "
        f"{wall:.3f} s = {2 / wall:.4f} intervals/s, "
        f"{2 * tokens_per_interval / wall:.1f} tokens/s, loss {losses}, "
        f"ledger {ledger}, fused_consensus_sgd launches {launches}, "
        f"max_memory_allocated {peak} B")
    del tr
    torch.cuda.empty_cache()
    if profile:
        profile_main_path(lambda: scale_run(cfg, scale, True, 1,
                                            "ssm_profile", weights=w0)[2],
                          "1 mamba2-370m scale interval (fused)")
        torch.cuda.empty_cache()

    # the same run through the per-leaf step (fused_power einsum)
    fused_consensus_sgd.launches = 0
    torch.cuda.reset_peak_memory_stats()
    tr2, losses2, wall2, ledger2 = scale_run(cfg, scale, False, 2,
                                             "ssm_perleaf", weights=w0)
    peak2 = torch.cuda.max_memory_allocated()
    assert fused_consensus_sgd.launches == 0
    np.testing.assert_allclose(losses2, losses, rtol=1e-4)
    assert ledger2 == ledger, (ledger2, ledger)
    diff = max(float((a - b).abs().max()) for a, b in zip(
        tree_leaves(tr2._global_params()), spec.leaf_views(g_fused)))
    assert diff <= 1e-5, diff
    log(f"[scale-ssm] mamba2-370m ({cfg.num_layers} layers) per-leaf step: "
        f"2 intervals in "
        f"{wall2:.3f} s = {2 / wall2:.4f} intervals/s, "
        f"{2 * tokens_per_interval / wall2:.1f} tokens/s, loss {losses2} "
        f"(rtol 1e-4 vs the fused run), same ledger, max_memory_allocated "
        f"{peak2} B, global model ({SCALE_SSM_P} parameters) max |diff| "
        f"{diff:.3e} (atol 1e-5)")
    del tr2, g_fused, w0
    torch.cuda.empty_cache()

    # the card against the CPU on a reduced mamba2 (chunk 32, sequences of
    # 48 pad to 64): same weights and draws; the CPU takes the kernel's
    # plain version
    small = cfg.reduced()
    ssc = TTHFScaleConfig(replicas=4, cluster_size=2, tau=4,
                          consensus_every=2, gamma_d2d=2, lr=0.05)
    sw0 = build_model(small).init(torch.Generator().manual_seed(1), "cpu")
    fused_consensus_sgd.launches = 0
    kw = dict(batch=2, seq=48, weights=sw0, seed=1)
    _, l_gpu, _, led_gpu = scale_run(small, ssc, True, 2, "ssm_small_cuda",
                                     device="cuda", **kw)
    assert fused_consensus_sgd.launches == 4, fused_consensus_sgd.launches
    _, l_cpu, _, led_cpu = scale_run(small, ssc, True, 2, "ssm_small_cpu",
                                     device="cpu", **kw)
    np.testing.assert_allclose(l_gpu, l_cpu, rtol=1e-4)
    assert led_gpu == led_cpu
    log(f"[scale-ssm] reduced mamba2 on cuda vs cpu: loss {l_gpu} vs "
        f"{l_cpu} (rtol 1e-4), same ledger {led_gpu}")
    return launches


def device_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls: the
    device sleeps while the host queues them, so that the time of a
    kernel of some microseconds is not the host's launch time."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)        # ~0.1 s at the H100's clocks
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def paged_inputs(spec, dtype, seed=0, copies=1):
    """q, [(k_pages, v_pages)] * copies, page_map, pos, window on the
    card for a ``PAGED_CASES`` spec, from one numpy seed (as
    tests/test_torch_kernels.py)."""
    import torch
    B, K, G, hd, ps, P, N, window, pos = spec
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, K, G, hd)).astype(np.float32)
    kp = rng.normal(size=(N, ps, K, hd)).astype(np.float32)
    vp = rng.normal(size=(N, ps, K, hd)).astype(np.float32)
    pages = rng.permutation(np.arange(1, N))
    page_map = np.zeros((B, P), np.int32)
    pos_v = np.zeros((B,), np.int32)
    for b, pb in enumerate(pos):
        if pb is None:
            pos_v[b] = P * ps + 7
        else:
            page_map[b] = pages[b * P:(b + 1) * P] if N > B * P else \
                rng.choice(np.arange(1, N), size=P)
            pos_v[b] = pb
    cuda = lambda a: torch.from_numpy(a).cuda()  # noqa: E731
    pools = [(cuda(kp).to(dtype), cuda(vp).to(dtype))]
    # the timing copies: other values, the same shapes
    pools += [(torch.randn_like(pools[0][0]), torch.randn_like(pools[0][1]))
              for _ in range(copies - 1)]
    return cuda(q), pools, cuda(page_map), cuda(pos_v), window


def phase_paged_kernel() -> dict:
    """``paged_decode`` against its plain version at every case, f32 and
    bf16 pools (a second launch must give the same bits: the merge's
    order is fixed); then timed at the serve path's shape and at the
    balanced one against its bound, its plain version and a library
    yardstick."""
    import torch
    from repro_torch.kernels.paged_decode import (
        paged_decode, paged_decode_plain, split_plan)

    worst = {}
    for case, spec in PAGED_CASES.items():
        for dt in ("float32", "bfloat16"):
            q, pools, pm, pos, window = paged_inputs(spec, getattr(torch, dt))
            (kp, vp), = pools
            if case.startswith("split-"):
                assert split_plan(*spec[:6], kp.dtype).chunk == SPLIT_CHUNK
            out = paged_decode(q, kp, vp, pm, pos, window=window)
            torch.cuda.synchronize()
            plain = paged_decode_plain(q, kp, vp, pm, pos, window=window)
            assert out.dtype == torch.float32 and out.shape == q.shape
            assert torch.isfinite(out).all(), case
            assert torch.equal(
                paged_decode(q, kp, vp, pm, pos, window=window), out), case
            err = float((out - plain).abs().max())
            assert err <= PAGED_TOL, (case, dt, err)
            worst[dt] = max(worst.get(dt, 0.0), err)
            log(f"[kernels] paged_decode {case} {PAGED_CASES[case][:8]} "
                f"{dt} max_abs_err={err:.3e} (tol {PAGED_TOL})")

    # the serve path's shape; then every slot at its last position; then
    # the hybrid's serve shape with its window band; then the moe kind's
    numbers = time_paged(PAGED_CASES["qwen-serve"], "qwen-serve")
    numbers["at_balanced_shape"] = time_paged(PAGED_BALANCED,
                                              "qwen-balanced")
    numbers["at_hybrid_shape"] = time_paged(PAGED_CASES["hybrid-serve"],
                                            "hybrid-serve")
    numbers["at_scout_shape"] = time_paged(PAGED_CASES["scout-serve"],
                                           "scout-serve")
    numbers["max_abs_err_all_shapes"] = {
        "float32": max(worst["float32"], numbers["max_abs_err"],
                       numbers["at_balanced_shape"]["max_abs_err"],
                       numbers["at_hybrid_shape"]["max_abs_err"],
                       numbers["at_scout_shape"]["max_abs_err"]),
        "bfloat16": worst["bfloat16"]}
    return numbers


def time_paged(spec, label: str) -> dict:
    """``paged_decode`` at ``spec`` in f32, timed against its bound, its
    plain version and a library yardstick. Four copies of the pools (4 x
    42 MB at the serve shape) rotate, so each launch finds its pages out
    of the 50 MB L2, as every layer's pages are in a decode step."""
    import itertools

    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.paged_decode import (
        paged_decode, paged_decode_plain, split_plan)

    q, pools, pm, pos, window = paged_inputs(spec, torch.float32, seed=1,
                                             copies=4)
    B, K, G, hd, ps, P, _, _, _ = spec
    kp, vp = pools[0]
    out = paged_decode(q, kp, vp, pm, pos, window=window)
    torch.cuda.synchronize()
    err = float((out - paged_decode_plain(q, kp, vp, pm, pos,
                                          window=window)).abs().max())
    assert err <= PAGED_TOL, (label, err)
    turn = itertools.cycle(pools)
    ms = device_ms(lambda: paged_decode(q, *next(turn), pm, pos,
                                        window=window), iters=400)
    plain_ms = device_ms(lambda: paged_decode_plain(q, *next(turn), pm, pos,
                                                    window=window), iters=100)
    # the library yardstick: one gather of both pools and SDPA with the
    # same boolean mask (the G query heads of a kv head as its queries)
    kvs = [torch.stack([k, v]) for k, v in pools]
    pml = pm.long()
    k_pos = torch.arange(P * ps, device="cuda")
    keep = k_pos[None, :] <= pos.long()[:, None]
    if window:
        keep = keep & (k_pos[None, :] > pos.long()[:, None] - window)
    mask = keep[:, None, None, :]

    def library(kv):
        g = kv[:, pml].reshape(2, B, P * ps, K, hd).transpose(2, 3)
        return F.scaled_dot_product_attention(q, g[0], g[1], attn_mask=mask)

    lib_err = float((library(kvs[0]) - out).abs().max())
    rot = itertools.cycle(kvs)
    library_ms = device_ms(lambda: library(next(rot)), iters=100)
    # the positions the kernel walks: max(0, pos - window + 1) ..
    # min(pos, P*ps - 1)
    hi = torch.clamp(pos.long(), max=P * ps - 1)
    lo = torch.clamp(pos.long() - window + 1, min=0) if window else 0 * hi
    live = int((hi - lo + 1).clamp(min=0).sum())
    bytes_moved = (2 * live * K * hd * kp.element_size()
                   + 2 * q.numel() * 4 + (pm.numel() + pos.numel()) * 4)
    b_ms, b_by = bound(bytes_moved, 4 * live * K * G * hd)
    plan = split_plan(B, K, G, hd, ps, P, kp.dtype)
    log(f"[kernels] paged_decode {label} {spec[:8]} f32, {live} live "
        f"positions, chunk {plan.chunk}, {plan.n_split} splits: kernel "
        f"{ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, gather + "
        f"scaled_dot_product_attention {library_ms * 1e3:.2f} us (max |diff| "
        f"vs kernel {lib_err:.2e}), bound {b_ms * 1e3:.2f} us ({b_by}: "
        f"{bytes_moved} B at 3.35 TB/s), kernel at "
        f"{bytes_moved / ms / 1e6:.1f} GB/s, max_abs_err {err:.3e}")
    del pools, kvs
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by,
            "live_positions": live}


def ssd_inputs(shape, dtype, seed=0, copies=1):
    """[(x, dt, loga, B, C)] * copies on the card, the first from one
    numpy seed as tests/test_kernels.py makes them, the others (timing
    copies) from torch's generator on the card."""
    import torch
    BH, T, P, S, _ = shape
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(BH, T, P)).astype(np.float32)
    dt = rng.uniform(0.001, 0.1, size=(BH, T)).astype(np.float32)
    loga = (-dt * rng.uniform(0.5, 2.0, size=(BH, 1))).astype(np.float32)
    B = (rng.normal(size=(BH, T, S)) * 0.3).astype(np.float32)
    C = (rng.normal(size=(BH, T, S)) * 0.3).astype(np.float32)
    cuda = lambda a, d=dtype: torch.from_numpy(a).to("cuda", d)  # noqa
    sets = [(cuda(x), cuda(dt, torch.float32), cuda(loga, torch.float32),
             cuda(B), cuda(C))]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for _ in range(copies - 1):
        d = torch.rand((BH, T), generator=gen, device="cuda") * 0.099 + 1e-3
        sets.append((
            torch.randn((BH, T, P), generator=gen, device="cuda").to(dtype),
            d, -d, (torch.randn((BH, T, S), generator=gen, device="cuda")
                    * 0.3).to(dtype),
            (torch.randn((BH, T, S), generator=gen, device="cuda")
             * 0.3).to(dtype)))
    return sets


def ssd_compare(y, h, yp, hp, dt: str, what) -> tuple[float, float]:
    """(max |y - plain|, that over max |plain|), the second held to the
    dtype's tolerance; the float32 final state to rtol/atol 1e-4."""
    import torch
    assert y.dtype == yp.dtype and y.shape == yp.shape, what
    assert torch.isfinite(y.float()).all() and torch.isfinite(h).all(), what
    err = float((y.float() - yp.float()).abs().max())
    rel = err / (float(yp.float().abs().max()) + 1e-6)
    assert rel < SSD_TOL[dt], (what, dt, rel)
    assert torch.allclose(h, hp, rtol=1e-4, atol=1e-4), \
        (what, float((h - hp).abs().max()))
    return err, rel


def ssd_group_inputs(shape, dtype, seed=0, copies=1):
    """[(x (b, T, H, P), dt, loga (b, T, H), B, C (b, T, S))] * copies on
    the card, in the model's layout: the first from one numpy seed, the
    others (timing copies) from torch's generator on the card."""
    import torch
    b, H, T, P, S, _ = shape
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, T, H, P)).astype(np.float32)
    dt = rng.uniform(0.001, 0.1, size=(b, T, H)).astype(np.float32)
    loga = (-dt * rng.uniform(0.5, 2.0, size=(b, 1, H))).astype(np.float32)
    B = (rng.normal(size=(b, T, S)) * 0.3).astype(np.float32)
    C = (rng.normal(size=(b, T, S)) * 0.3).astype(np.float32)
    cuda = lambda a, d=dtype: torch.from_numpy(a).to("cuda", d)  # noqa
    sets = [(cuda(x), cuda(dt, torch.float32), cuda(loga, torch.float32),
             cuda(B), cuda(C))]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for _ in range(copies - 1):
        d = torch.rand((b, T, H), generator=gen, device="cuda") * 0.099 + 1e-3
        sets.append((
            torch.randn((b, T, H, P), generator=gen, device="cuda").to(dtype),
            d, -d, (torch.randn((b, T, S), generator=gen, device="cuda")
                    * 0.3).to(dtype),
            (torch.randn((b, T, S), generator=gen, device="cuda")
             * 0.3).to(dtype)))
    return sets


def ssd_work(shape) -> tuple[int, int]:
    """(bytes, operations) the grouped call needs: x and y, dt and loga
    and h per row, B and C per group, each read or written once; the
    operations are the kernel module's own count (``ssd_work`` there,
    also what the wrapper charges on fake tensors)."""
    from repro_torch.kernels.ssd_scan import ssd_work as operations
    b, H, T, P, S, Q = shape
    bytes_moved = 4 * (b * H * (2 * T * P + 2 * T + S * P) + b * 2 * T * S)
    return bytes_moved, operations(b, H, T, P, S, Q)


def phase_ssd_kernel() -> dict:
    """``ssd_scan`` against its plain version at the reference's shapes,
    one row per head; chunk 64 against 256; the main paths' grouped calls
    (B and C once per batch element, x in the model's layout) in f32 and
    bf16; timed at both main shapes against both bounds and the plain
    scan, beside the same kernel behind transposed copies of x, dt and
    loga, and behind those and per-head copies of B and C (what the
    model's wrapper did before B and C were shared by a group)."""
    import itertools

    import torch
    from repro_torch.kernels.ssd_scan import (
        ssd_chunked, ssd_scan, ssd_scan_heads, ssd_scan_plain)

    worst = {}
    shapes = SSD_TEST_SHAPES + list(SSD_MAIN_SHAPES.values())
    for i, shape in enumerate(shapes):
        chunk = shape[-1]
        for dt in ("float32", "bfloat16"):
            args, = ssd_inputs(shape, getattr(torch, dt), seed=i)
            y, h = ssd_scan(*args, chunk=chunk)
            torch.cuda.synchronize()
            yp, hp = ssd_scan_plain(*args, chunk=chunk)
            err, rel = ssd_compare(y, h, yp, hp, dt, shape)
            worst[dt] = max(worst.get(dt, 0.0), err)
            log(f"[kernels] ssd_scan {shape} {dt} max_abs_err={err:.3e}, "
                f"over max|y| {rel:.3e} (tol {SSD_TOL[dt]}), h max|diff| "
                f"{float((h - hp).abs().max()):.3e}")
            del args, y, h, yp, hp
    # the state carry across chunks: chunk 64 against chunk 256
    args, = ssd_inputs((2, 256, 32, 64, 64), torch.float32, seed=2)
    y64, h64 = ssd_scan(*args, chunk=64)
    y256, h256 = ssd_scan(*args, chunk=256)
    torch.cuda.synchronize()
    assert torch.allclose(y64, y256, rtol=1e-4, atol=1e-4)
    assert torch.allclose(h64, h256, rtol=1e-4, atol=1e-4)
    log(f"[kernels] ssd_scan chunk 64 vs 256: y max|diff| "
        f"{float((y64 - y256).abs().max()):.3e}, h max|diff| "
        f"{float((h64 - h256).abs().max()):.3e} (rtol/atol 1e-4)")

    def rows(t, b, H):        # (b, T, H, ...) -> (b*H, T, ...) copies
        return t.transpose(1, 2).reshape(b * H, *t.shape[1:2],
                                         *t.shape[3:]).contiguous()

    # the main paths' grouped calls: the model's layout through strides,
    # and rows with heads_per_group = H, against ssd_chunked
    for i, (name, shape) in enumerate(SSD_GROUP_SHAPES.items()):
        b, H, T, P, S, Q = shape
        for dt in ("float32", "bfloat16"):
            (x, d, la, B, C), = ssd_group_inputs(shape, getattr(torch, dt),
                                                 seed=20 + i)
            y, h = ssd_scan_heads(x, d, la, B, C, chunk=Q)
            y2, h2 = ssd_scan_heads(x, d, la, B, C, chunk=Q)
            yr, hr = ssd_scan(rows(x, b, H), rows(d, b, H), rows(la, b, H),
                              B, C, chunk=Q, heads_per_group=H)
            torch.cuda.synchronize()
            assert torch.equal(y, y2) and torch.equal(h, h2), (name, dt)
            yp, hp = ssd_chunked(x, d, la, B, C, chunk=Q)
            err, rel = ssd_compare(y, h, yp, hp, dt, (name, "heads"))
            err_r, _ = ssd_compare(
                yr, hr, rows(yp, b, H), hp.reshape(b * H, S, P), dt,
                (name, "rows"))
            worst[dt] = max(worst[dt], err, err_r)
            log(f"[kernels] ssd_scan grouped {name} {shape} {dt}: "
                f"ssd_scan_heads max_abs_err={err:.3e} (over max|y| "
                f"{rel:.3e}, tol {SSD_TOL[dt]}), h max|diff| "
                f"{float((h - hp).abs().max()):.3e}, a second launch "
                f"bitwise equal; rows with heads_per_group={H} "
                f"max_abs_err={err_r:.3e}")
            del x, d, la, B, C, y, h, y2, h2, yr, hr, yp, hp

    numbers = {}
    for name, shape in SSD_GROUP_SHAPES.items():
        b, H, T, P, S, Q = shape
        # inputs rotated so that every launch reads them from HBM: 16 sets
        # of the 4.8 MB serve shape, two of the 77 MB forward one
        sets = ssd_group_inputs(shape, torch.float32, seed=50,
                                copies=16 if name == "serve" else 2)
        y, h = ssd_scan_heads(*sets[0], chunk=Q)
        torch.cuda.synchronize()
        err, rel = ssd_compare(y, h, *ssd_chunked(*sets[0], chunk=Q),
                               "float32", shape)
        del y, h
        turn = itertools.cycle(sets)

        def copies(x, d, la, B, C):      # x, dt and loga transposed to rows
            return ssd_scan(rows(x, b, H), rows(d, b, H), rows(la, b, H),
                            B, C, chunk=Q, heads_per_group=H)

        def per_row(x, d, la, B, C):     # and B, C repeated for every head
            rep = lambda t: t[:, None].expand(  # noqa: E731
                b, H, T, S).reshape(b * H, T, S).contiguous()
            return ssd_scan(rows(x, b, H), rows(d, b, H), rows(la, b, H),
                            rep(B), rep(C), chunk=Q)

        iters = 200 if name == "serve" else 20
        kernel = lambda: ssd_scan_heads(*next(turn), chunk=Q)  # noqa: E731
        # the kernel timed three times, in turns with the two variants; its
        # median is the number kept
        runs = [device_ms(kernel, iters)]
        copies_ms = device_ms(lambda: copies(*next(turn)), iters)
        runs.append(device_ms(kernel, iters))
        per_row_ms = device_ms(lambda: per_row(*next(turn)), iters)
        runs.append(device_ms(kernel, iters))
        ms = float(np.median(runs))
        plain_ms = device_ms(lambda: ssd_chunked(*next(turn), chunk=Q),
                             iters=20 if name == "serve" else 4, warmup=1)
        bytes_moved, flops = ssd_work(shape)
        bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
        f32_ms = max(bytes_ms, flops / F32_FLOPS_PER_S * 1e3)
        tf32_ms = max(bytes_ms, 3 * flops / TF32_FLOPS_PER_S * 1e3)
        log(f"[kernels] ssd_scan {name} {shape} f32 (B/C ({b}, {T}, {S}), "
            f"{H} heads): ssd_scan_heads {ms:.4f} ms (median of "
            f"{', '.join(f'{t:.4f}' for t in runs)}; two launches a call), "
            f"behind transposed copies of x, dt, "
            f"loga {copies_ms:.4f} ms, behind those and per-head B, C "
            f"{per_row_ms:.4f} ms, plain ssd_chunked {plain_ms:.4f} ms; "
            f"{flops} FLOP and {bytes_moved} B: 3xTF32 bound {tf32_ms:.4f} "
            f"ms (3 x {flops} at 495 TFLOP/s; the products run on the "
            f"tensor cores), kernel at {tf32_ms / ms:.3f} of it; f32 bound "
            f"{f32_ms:.4f} ms (67 TFLOP/s), kernel at {f32_ms / ms:.3f} of "
            f"it; bytes {bytes_ms:.4f} ms; {flops / ms / 1e9:.1f} TFLOP/s; "
            f"no single PyTorch call computes the scan; max_abs_err "
            f"{err:.3e} (over max|y| {rel:.3e})")
        numbers[name] = {"max_abs_err": err, "ms": ms, "ms_runs": runs,
                         "plain_ms": plain_ms, "bound_ms": tf32_ms,
                         "bound_by": "operations" if tf32_ms > bytes_ms
                         else "bytes",
                         "bound_f32_ms": f32_ms, "copies_ms": copies_ms,
                         "per_row_ms": per_row_ms}
        del sets
        torch.cuda.empty_cache()
    return dict(numbers["serve"], library_ms=None,
                max_abs_err_all_shapes=worst,
                at_forward_shape=numbers["forward"])


TRACE_STATS = ("requests_done", "prefills", "decode_steps",
               "tokens_generated", "slot_steps", "live_slot_steps")
RECORD_FIELDS = ("rid", "submit", "admit", "first_token", "retire",
                 "decode", "budget")


def trace_stats(stats, sched=None) -> dict:
    """A trace's stats and per-request records; with a paged scheduler,
    its page counters too."""
    out = {f: getattr(stats, f) for f in TRACE_STATS}
    out["records"] = [tuple(getattr(r, f) for f in RECORD_FIELDS)
                      for r in stats.records]
    if hasattr(sched, "page_deferrals"):
        out.update(page_deferrals=sched.page_deferrals,
                   prefix_pages_hit=sched.prefix_pages_hit,
                   prefix_pages_possible=sched.prefix_pages_possible,
                   prefill_chunks=[r.prefill_chunks for r in stats.records])
    return out


def phase_serve(profile: bool = False) -> tuple:
    """Paged continuous-batching serving of the full-size qwen1.5-0.5b
    through the serve CLI's trace: the main path (the paged_decode
    kernel), the plain gather, a one-shot paged prefill and the ring
    scheduler held to it, teacher-forced logits, and a reduced trace on
    the card against the CPU. Returns paged_decode's launches in the
    main path's run, and that run's tokens, stats and wall (the bare run
    ``[obs]`` is held to)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels.paged_decode import paged_decode
    from repro_torch.launch.serve import make_arrivals
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_map
    from repro_torch.serving import (
        PageTable, make_scheduler, pages_per_slot, run_trace)

    cfg = get_arch("qwen1.5-0.5b")
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        "cuda")

    def run(kind, *, c=cfg, m=model, p=params, trace=SERVE_TRACE,
            device="cuda", **over):
        kw = dict(SERVE_SCHED, device=device, **over)
        if kind == "paged":
            kw = {**SERVE_PAGED, **kw}
        sched = make_scheduler(kind, m, **kw)
        arrivals = make_arrivals(c, **trace)
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.time()
        stats = run_trace(sched, p, arrivals)
        if device == "cuda":
            torch.cuda.synchronize()
        return sched, stats, arrivals, time.time() - t0

    # warm-up: allocator, cuBLAS handles, the kernel's first load
    _, st, _, wall = run("paged", trace=dict(SERVE_TRACE, requests=2, gen=4))
    log(f"[serve] warm-up: 2 requests, {st.decode_steps} decode steps in "
        f"{wall:.3f} s")

    # the main path: PagedContinuousScheduler with the kernel (auto-on)
    torch.cuda.reset_peak_memory_stats()
    paged_decode.launches = 0
    sched, stats, arrivals, wall = run("paged")
    launches = paged_decode.launches
    peak = torch.cuda.max_memory_allocated()
    main = trace_stats(stats, sched)
    pool_bytes = sum(t.numel() * t.element_size()
                     for t in sched._cache["layers"].values())
    assert sched.paged_kernel and sched.cache_pages == 321, sched.cache_pages
    assert stats.requests_done == SERVE_TRACE["requests"]
    assert launches == cfg.num_layers * stats.decode_steps, launches
    assert sched.table.num_free == sched.cache_pages - 1   # no page leaked
    assert len(sched.trie) == 0
    assert all(len(r.out_tokens) == r.budget for _, r in arrivals)
    assert sched.prefix_pages_hit > 0
    log(f"[serve] qwen1.5-0.5b paged (kernel): {stats.requests_done} "
        f"requests, {stats.prefills} prefills in "
        f"{sum(main['prefill_chunks'])} chunks, {stats.decode_steps} decode "
        f"steps, {stats.tokens_generated} tokens in {wall:.3f} s = "
        f"{stats.tokens_generated / wall:.1f} tokens/s, "
        f"{stats.decode_steps / wall:.2f} decode steps/s, util "
        f"{stats.utilization:.3f}, prefix hit rate {sched.prefix_hit_rate:.4f}"
        f" ({sched.prefix_pages_hit}/{sched.prefix_pages_possible} pages), "
        f"deferrals {sched.page_deferrals}, paged_decode launches {launches} "
        f"= {cfg.num_layers} x {stats.decode_steps}, pool {pool_bytes} B, "
        f"max_memory_allocated {peak} B, no page leaked")
    kernel_tokens = {r.rid: list(r.out_tokens) for _, r in arrivals}
    bare = {"tokens": kernel_tokens, "stats": main, "wall": wall}
    del sched
    torch.cuda.empty_cache()
    if profile:
        profile_main_path(lambda: run("paged")[3], "serve trace (paged)")

    # the same trace through the plain gather: the schedule and every
    # stat are the kernel run's (requests retire by budget, not by token)
    paged_decode.launches = 0
    sched, stats, arrivals, wall2 = run("paged", paged_kernel=False)
    assert paged_decode.launches == 0
    assert trace_stats(stats, sched) == main
    same = sum(kernel_tokens[r.rid] == r.out_tokens for _, r in arrivals)
    log(f"[serve] plain gather: {wall2:.3f} s = "
        f"{stats.tokens_generated / wall2:.1f} tokens/s, every stat and "
        f"record equal to the kernel run; {same}/{len(arrivals)} requests "
        f"with identical greedy tokens at the full vocabulary")
    del sched
    torch.cuda.empty_cache()

    # one-shot paged prefill against the ring scheduler: every stat equal
    sched, stats, _, wall3 = run("paged", prefill_chunk=None)
    oneshot = trace_stats(stats)
    del sched
    torch.cuda.empty_cache()
    sched, stats, _, wall4 = run("continuous")
    ring = trace_stats(stats)
    assert ring == oneshot, (ring, oneshot)
    for f in ("requests_done", "prefills", "tokens_generated"):
        assert ring[f] == main[f], f
    log(f"[serve] ring ContinuousScheduler: {wall4:.3f} s = "
        f"{stats.tokens_generated / wall4:.1f} tokens/s, every stat equal "
        f"to the one-shot paged run ({wall3:.3f} s, {ring['decode_steps']} "
        f"decode steps); the chunked run's {main['decode_steps']} decode "
        f"steps: its two-chunk prompts emit a tick later")
    del sched
    torch.cuda.empty_cache()

    # teacher forcing: 8 prompts of the trace prefilled, then 16 decode
    # steps fed the same tokens through the kernel and the plain gather
    ps, P = SERVE_PAGED["page_size"], pages_per_slot(
        SERVE_SCHED["max_total"], SERVE_PAGED["page_size"])
    slots, steps = SERVE_SCHED["slots"], 16
    cache = model.init_paged_cache(slots, slots * P + 1, ps, torch.float32,
                                   device="cuda")
    table = PageTable(slots * P + 1, ps)
    page_map = np.zeros((slots, P), np.int32)
    plens = np.zeros((slots,), np.int32)
    chunk = SERVE_PAGED["prefill_chunk"]
    for b, (_, req) in enumerate(arrivals[:slots]):
        plen = len(req.prompt)
        pages = table.alloc(-(-(plen + steps) // ps))
        page_map[b, :len(pages)] = pages
        padded = np.zeros((1, -(-plen // chunk) * chunk), np.int32)
        padded[0, :plen] = req.prompt
        for start in range(0, plen, chunk):
            toks = torch.from_numpy(padded[:, start:start + chunk]).cuda()
            model.prefill_chunk(params, cache, toks, start,
                                min(chunk, plen - start), page_map[b], b,
                                dtype=torch.float32)
        plens[b] = plen
    cache_plain = tree_map(lambda t: t.clone(), cache)
    feed = np.random.default_rng(5).integers(
        1, cfg.vocab_size, size=(steps, slots, 1)).astype(np.int32)
    pm, live = torch.from_numpy(page_map).cuda(), torch.ones(
        slots, dtype=torch.bool, device="cuda")
    pos = torch.from_numpy(plens).cuda()
    tf_err = 0.0
    for i in range(steps):
        tok = torch.from_numpy(feed[i]).cuda()
        lk, _ = model.decode_step_paged(params, tok, cache, pos, pm, live,
                                        dtype=torch.float32, use_kernel=True)
        lp, _ = model.decode_step_paged(params, tok, cache_plain, pos, pm,
                                        live, dtype=torch.float32,
                                        use_kernel=False)
        assert torch.isfinite(lk).all()
        tf_err = max(tf_err, float((lk - lp).abs().max()))
        pos = pos + 1
    assert tf_err <= 1e-4, tf_err
    log(f"[serve] teacher forcing, {slots} prefilled prompts of "
        f"{plens.tolist()} tokens, {steps} decode steps over "
        f"{cfg.num_layers} layers: logits max |kernel - plain| {tf_err:.3e} "
        f"(atol 1e-4)")
    del cache, cache_plain, params
    torch.cuda.empty_cache()

    # the card against the CPU: a reduced qwen, the same weights and trace
    small = cfg.reduced()
    sm = build_model(small)
    w_cpu = sm.init(torch.Generator().manual_seed(1), "cpu")
    w_gpu = tree_map(lambda t: t.cuda(), w_cpu)
    trace = dict(requests=8, prompt_len=64, gen=16, seed=1,
                 prefix_template=20, arrival_gap=2.0)
    over = dict(max_prompt=64, max_total=80, slots=4, prefill_chunk=32)
    outs = {}
    for dev, w in (("cuda", w_gpu), ("cpu", w_cpu)):
        sc, st, arr, _ = run("paged", c=small, m=sm, p=w, trace=trace,
                             device=dev, **over)
        outs[dev] = ([r.out_tokens for _, r in arr], trace_stats(st, sc))
    assert outs["cuda"] == outs["cpu"]
    log(f"[serve] reduced qwen paged trace on cuda vs cpu: the same tokens "
        f"for all {trace['requests']} requests and the same stats "
        f"({outs['cpu'][1]['decode_steps']} decode steps)")
    return launches, bare


def record_margins(cls) -> tuple:
    """Patch ``cls._sample`` to record, at every sampling, each emitting
    request's top-two logit margin and max |logit| at the index of the
    token it is about to emit: ``{(rid, index): (margin, max_abs)}``.
    Returns (the record, a function that removes the patch)."""
    import torch
    record = {}
    original = cls._sample

    def sample(self, logits):
        last = logits[:, -1].float()
        top = torch.topk(last, 2, dim=-1).values
        margin = (top[:, 0] - top[:, 1]).cpu().numpy()
        biggest = last.abs().amax(-1).cpu().numpy()
        for i, r in enumerate(self.active):
            if r is not None and not r.done and self._slot_ready(i):
                record[(r.rid, len(r.out_tokens))] = (float(margin[i]),
                                                      float(biggest[i]))
        return original(self, logits)

    cls._sample = sample
    return record, lambda: setattr(cls, "_sample", original)


def check_tokens(name: str, got: dict, ref: dict, margins: dict,
                 routed_apart: int | None = None,
                 calls_at: dict | None = None) -> list:
    """Every request's greedy tokens equal the plain run's, except that a
    request may part from it at a step where the plain run's top two
    logits are within LOGIT_TOL of its max |logit|, or (the moe kind:
    ``routed_apart``, the first router call at which the two runs routed
    a token apart, a near tie that :func:`first_routing_split` checked,
    and ``calls_at``, the router calls made before each sampling) after
    the two runs' routing parted: a decode step routes all its slots as
    one group, so one token's expert moves another's drop. After that
    step a request's tokens follow other inputs and are not compared.
    Returns the partings as (rid, index, margin / max |logit|)."""
    partings = []
    for rid, want in ref.items():
        have = got[rid]
        assert len(have) == len(want), (name, rid)
        k = next((i for i, (a, b) in enumerate(zip(have, want)) if a != b),
                 None)
        if k is None:
            continue
        margin, biggest = margins[(rid, k)]
        routed = routed_apart is not None and routed_apart < calls_at[(rid,
                                                                       k)]
        assert margin <= LOGIT_TOL * biggest or routed, (
            f"{name}: request {rid} diverged at token {k}, where the plain "
            f"run's top-two margin {margin} exceeds {LOGIT_TOL} x {biggest}"
            f" and the two runs' routing had not parted")
        partings.append((rid, k, margin / biggest))
    return partings


def record_routing(cls) -> tuple:
    """Patch ``apply_moe`` and ``cls._sample`` to record every router
    call's expert per routed token and its top-two margin over max
    |router logit| (one host copy a call), and, at every sampling, the
    number of router calls made so far for each emitting request.
    Returns ([(experts, margins)] a call, {(rid, index): calls}, a
    function that removes both patches)."""
    import torch
    from repro_torch.models import moe
    calls, calls_at = [], {}
    apply, sample = moe.apply_moe, cls._sample

    def spy(p, cfg, x, *a, token_mask=None, **kw):
        logits = (x @ p["router"].to(x.dtype)).float()
        top = torch.topk(logits, 2, dim=-1).values
        ratio = (top[..., 0] - top[..., 1]) / logits.abs().amax(-1)
        eid = torch.argmax(logits, -1)
        if token_mask is not None:
            eid, ratio = eid[token_mask], ratio[token_mask]
        calls.append((eid.cpu().numpy().ravel(),
                      ratio.cpu().numpy().ravel()))
        return apply(p, cfg, x, *a, token_mask=token_mask, **kw)

    def patched(self, logits):
        for r in self.active:
            if r is not None and not r.done:
                calls_at[(r.rid, len(r.out_tokens))] = len(calls)
        return sample(self, logits)

    moe.apply_moe, cls._sample = spy, patched

    def unpatch():
        moe.apply_moe, cls._sample = apply, sample
    return calls, calls_at, unpatch


def first_routing_split(got: list, ref: list):
    """The first router call at which two runs' records of
    :func:`record_routing` route a token to another expert, or None;
    it must be a near tie: that token's top two router logits within
    LOGIT_TOL of their max |logit| in ``ref``'s run. Returns (call,
    token, ``ref``'s margin ratio) or None."""
    assert len(got) == len(ref), (len(got), len(ref))
    for i, ((e1, _), (e2, r2)) in enumerate(zip(got, ref)):
        apart = np.flatnonzero(e1 != e2)
        if apart.size:
            t = int(apart[np.argmin(r2[apart])])
            assert r2[t] <= LOGIT_TOL, (
                f"router call {i}: token {t} routed apart with a top-two "
                f"margin of {r2[t]} of max |router logit| (tol {LOGIT_TOL})")
            return i, t, float(r2[t])
    return None


def phase_serve_ssm(profile: bool = False) -> int:
    """The serve CLI's continuous scheduler on the full-size mamba2-370m:
    the main path (``ssd_scan`` in every admission's prefill), the plain
    scan and the chunked paged scheduler held to it, and the trace's
    counts held to a CPU run at reduced width. Returns ssd_scan's
    launches in the main path's run."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_leaves
    from repro_torch.serving import ContinuousScheduler

    args = serve_cli.parse_args(SERVE_SSM_ARGV)
    cfg = get_arch(args.arch)
    model = build_model(cfg)
    device = torch.device("cuda")
    params = serve_cli.init_params(model, args, device)
    n_params = sum(t.numel() for t in tree_leaves(params))
    assert n_params == 368_285_184, n_params

    def run(argv=(), **over):
        a = serve_cli.parse_args(SERVE_SSM_ARGV + list(argv))
        return serve_cli.run_scheduler_trace(a, cfg, model, device, params,
                                             **over)

    # the trace's counts at reduced width on the CPU (they follow from the
    # trace, not the weights)
    small = cfg.reduced()
    _, cpu_stats, _, cpu_wall = serve_cli.run_scheduler_trace(
        serve_cli.parse_args(SERVE_SSM_ARGV + ["--reduced"]), small,
        build_model(small), torch.device("cpu"))
    log(f"[serve-ssm] the trace on the CPU at reduced width: "
        f"{cpu_stats.prefills} prefills, {cpu_stats.decode_steps} decode "
        f"steps, {cpu_stats.tokens_generated} tokens ({cpu_wall:.1f} s)")

    # warm-up: allocator, cuBLAS handles, the kernel's first load
    _, st, _, wall = run(["--requests", "2", "--gen", "4"])
    log(f"[serve-ssm] warm-up: 2 requests, {st.decode_steps} decode steps "
        f"in {wall:.3f} s")

    # the main path: the continuous scheduler with the kernel (auto-on)
    torch.cuda.reset_peak_memory_stats()
    ssd_scan.launches = 0
    sched, stats, arrivals, wall = run()
    launches = ssd_scan.launches
    peak = torch.cuda.max_memory_allocated()
    main = trace_stats(stats)
    state_bytes = sum(t.numel() * t.element_size()
                      for t in sched._cache["layers"].values())
    assert sched.ssd_kernel and stats.requests_done == 32
    assert main == trace_stats(cpu_stats), "the trace's counts moved"
    assert launches == cfg.num_layers * cpu_stats.prefills == 48 * 32, \
        launches
    assert all(len(r.out_tokens) == r.budget for _, r in arrivals)
    log(f"[serve-ssm] mamba2-370m continuous (kernel): "
        f"{stats.requests_done} requests, {stats.prefills} prefills, "
        f"{stats.decode_steps} decode steps, {stats.tokens_generated} "
        f"tokens in {wall:.3f} s = {stats.tokens_generated / wall:.1f} "
        f"tokens/s, {stats.decode_steps / wall:.2f} decode steps/s, util "
        f"{stats.utilization:.3f}, ssd_scan launches {launches} = "
        f"{cfg.num_layers} x {cpu_stats.prefills} prefills of the CPU run, "
        f"every stat and record equal to it; state cache {state_bytes} B, "
        f"max_memory_allocated {peak} B")
    kernel_tokens = {r.rid: list(r.out_tokens) for _, r in arrivals}
    del sched
    torch.cuda.empty_cache()
    if profile:
        profile_main_path(lambda: run()[3], "serve-ssm trace (continuous)")

    # the same trace through the plain scan, recording its logit margins
    ssd_scan.launches = 0
    margins, unpatch = record_margins(ContinuousScheduler)
    try:
        sched, stats, arrivals, wall2 = run(ssd_kernel=False)
    finally:
        unpatch()
    assert ssd_scan.launches == 0
    assert trace_stats(stats) == main
    plain_tokens = {r.rid: list(r.out_tokens) for _, r in arrivals}
    parted = check_tokens("kernel", kernel_tokens, plain_tokens, margins)
    closest = min(m / b for m, b in margins.values())
    log(f"[serve-ssm] plain ssd_chunked: {wall2:.3f} s = "
        f"{stats.tokens_generated / wall2:.1f} tokens/s (margins recorded: "
        f"one host copy per tick), every stat and record equal to the "
        f"kernel run; {32 - len(parted)}/32 requests with identical greedy "
        f"tokens, partings (rid, token, margin / max|logit|) {parted}; "
        f"smallest top-two margin of the plain run {closest:.3e} of max "
        f"|logit| over {len(margins)} sampled tokens (tol {LOGIT_TOL})")
    del sched
    torch.cuda.empty_cache()

    # the paged scheduler, chunks of 256: first chunks through the kernel,
    # later ones through ssd_chunked from the carried state
    ssd_scan.launches = 0
    sched, stats, arrivals, wall3 = run(["--scheduler", "paged",
                                         "--prefill-chunk", "256"])
    chunks = [r.prefill_chunks for r in stats.records]
    assert ssd_scan.launches == cfg.num_layers * 32, ssd_scan.launches
    assert sum(chunks) > 32 and sched.table.num_free == sched.cache_pages - 1
    for f in ("requests_done", "prefills", "tokens_generated"):
        assert getattr(stats, f) == main[f], f
    parted_paged = check_tokens(
        "paged", {r.rid: list(r.out_tokens) for _, r in arrivals},
        plain_tokens, margins)
    log(f"[serve-ssm] paged, chunks of 256: {wall3:.3f} s = "
        f"{stats.tokens_generated / wall3:.1f} tokens/s, {sum(chunks)} "
        f"chunks ({sum(c > 1 for c in chunks)} prompts in two), "
        f"{stats.decode_steps} decode steps, ssd_scan launches "
        f"{ssd_scan.launches} (the first chunks), no page used; requests, "
        f"prefills and tokens equal to the ring run; partings from the "
        f"plain run {parted_paged}")
    del sched, params
    torch.cuda.empty_cache()
    return launches


def phase_forward_ssm() -> None:
    """The full-size mamba2-370m forward through the kernel against the
    plain scan, and a reduced mamba2 serve trace on the card against the
    CPU."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.models import build_model
    from repro_torch.launch.serve import make_arrivals
    from repro_torch.models.common import tree_map
    from repro_torch.serving import make_scheduler, run_trace

    cfg = get_arch("mamba2-370m")
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        1, cfg.vocab_size, size=(8, 1024))).to("cuda")
    with torch.no_grad():
        model.forward(params, {"tokens": toks[:, :256]}, dtype=torch.float32,
                      use_kernel=True)                    # warm-up
        torch.cuda.synchronize()
        ssd_scan.launches = 0
        t0 = time.time()
        lk, _ = model.forward(params, {"tokens": toks}, dtype=torch.float32,
                              use_kernel=True)
        torch.cuda.synchronize()
        t_kernel = time.time() - t0
        assert ssd_scan.launches == cfg.num_layers, ssd_scan.launches
        t0 = time.time()
        lp, _ = model.forward(params, {"tokens": toks}, dtype=torch.float32)
        torch.cuda.synchronize()
        t_plain = time.time() - t0
    assert lk.shape == (8, 1024, cfg.padded_vocab)
    assert torch.isfinite(lk).all()
    err = float((lk - lp).abs().max())
    biggest = float(lp.abs().max())
    assert err <= 1e-4 * biggest, (err, biggest)
    log(f"[forward-ssm] mamba2-370m forward, 8 x 1024 tokens f32, "
        f"{cfg.num_layers} layers: kernel {t_kernel:.3f} s "
        f"({cfg.num_layers} ssd_scan launches), plain ssd_chunked "
        f"{t_plain:.3f} s; logits max "
        f"|kernel - plain| {err:.3e}, max |logit| {biggest:.3f} (tol "
        f"{1e-4 * biggest:.3e})")
    del lk, lp, params
    torch.cuda.empty_cache()

    # the card against the CPU: a reduced mamba2, the same weights and trace
    small = cfg.reduced()
    sm = build_model(small)
    w_cpu = sm.init(torch.Generator().manual_seed(1), "cpu")
    w_gpu = tree_map(lambda t: t.to("cuda"), w_cpu)
    trace = dict(requests=8, prompt_len=64, gen=16, seed=1,
                 prefix_template=20, arrival_gap=2.0)
    outs = {}
    for dev, w in (("cuda", w_gpu), ("cpu", w_cpu)):
        sched = make_scheduler("continuous", sm, slots=4, max_prompt=64,
                               max_total=80, temperature=0.0, device=dev)
        arrivals = make_arrivals(small, **trace)
        stats = run_trace(sched, w, arrivals)
        outs[dev] = ([r.out_tokens for _, r in arrivals], trace_stats(stats))
    assert outs["cuda"] == outs["cpu"]
    log(f"[forward-ssm] reduced mamba2 continuous trace on cuda (kernel) vs "
        f"cpu (plain): the same tokens for all {trace['requests']} requests "
        f"and the same stats ({outs['cpu'][1]['decode_steps']} decode "
        f"steps)")


# the instrumented paths: the reference's record fields (held to the
# reference on the CPU by tests/test_torch_obs.py)
OBS_ROUND_FIELDS = {
    "sim": {"step", "wall_s", "kind", "active_devices", "eta", "upsilon",
            "consensus_err", "mix_residual", "dispersion", "param_norm",
            "sigma_t", "dispersion_bound", "eps0", "gamma_used",
            "upsilon_pre", "lemma1_bound", "gamma_saturated",
            "gamma_saturated_total"},
    "scale": {"step", "wall_s", "kind", "train_loss", "upsilon",
              "consensus_err", "mix_residual", "dispersion", "param_norm",
              "sigma_t", "dispersion_bound", "eps0", "gamma_used",
              "lemma1_bound"}}
REQUEST_FIELDS = {"step", "wall_s", "kind", "rid", "submit", "admit",
                  "first_token", "queue_latency", "ttft", "decode", "budget",
                  "prefill_chunks", "prefix_pages_reused"}
# the serve path's flags (launch/serve.py), the trace of SERVE_TRACE
SERVE_ARGV = ["--scheduler", "paged", "--batch", "8", "--prompt-len", "512",
              "--gen", "128", "--requests", "32", "--prefill-chunk", "256",
              "--prefix-template", "128", "--temperature", "0"]


# ---------------------------------------------------------------------------
# sharded serving: the serve paths through a (1, 1) DeviceMesh
# ---------------------------------------------------------------------------

# [serve-mesh]: the serve and serve-ssm traces cut to 8 requests of 32
# new tokens, and qwen's direct path, bare and with --mesh host
SERVE_MESH_CUT = ["--requests", "8", "--gen", "32"]
SERVE_MESH_DIRECT_ARGV = ["--batch", "8", "--prompt-len", "512", "--gen",
                          "16", "--temperature", "0"]


def phase_serve_mesh(profile: bool = False) -> dict:
    """Sharded serving on the card: ``--mesh host`` over the one H100 is
    a (1, 1) ``DeviceMesh`` of an NCCL world of one rank, the params and
    caches DTensors placed by the serve rules, every op dispatched by
    DTensor, the ``hint`` calls redistributing, and the two serving
    kernels launched by each rank on its shard (here: the whole). The
    qwen1.5-0.5b paged trace and the mamba2-370m continuous trace are
    run bare and on the mesh: the same stats, and the same tokens up to
    a near tie of the bare run (``check_tokens``); the direct path's
    logits within LOGIT_TOL of max |logit| of its bare run, teacher-
    forced. Logs each run's tokens/s and wall and the mesh's overhead;
    ``profile`` adds one profiled trace of each, bare and on the mesh.
    Returns {kernel: launches in the mesh runs}."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_arch
    from repro_torch.kernels.paged_decode import paged_decode
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models import build_model
    from repro_torch.serving import (
        ContinuousScheduler, PagedContinuousScheduler, shard_params)

    device = torch.device("cuda")
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    launches = {}
    try:
        args = serve_cli.parse_args(SERVE_ARGV + ["--mesh", "host"])
        mesh = serve_cli.setup_mesh(args, device)
        assert tuple(mesh.mesh.shape) == (1, 1), mesh
        for tag, argv, kernel, cls in (
                ("qwen paged", SERVE_ARGV, paged_decode,
                 PagedContinuousScheduler),
                ("mamba2 continuous", SERVE_SSM_ARGV, ssd_scan,
                 ContinuousScheduler)):
            args = serve_cli.parse_args(argv + SERVE_MESH_CUT)
            cfg = get_arch(args.arch)
            model = build_model(cfg)
            params = serve_cli.init_params(model, args, device)
            sharded = shard_params(params, model, mesh)
            warm = serve_cli.parse_args(argv + ["--requests", "2", "--gen",
                                                "4"])
            for p, m in ((params, None), (sharded, mesh)):
                serve_cli.run_scheduler_trace(warm, cfg, model, device, p,
                                              mesh=m)
            margins, unpatch = record_margins(cls)
            try:
                sched, stats, arrivals, wall = serve_cli.run_scheduler_trace(
                    args, cfg, model, device, params)
            finally:
                unpatch()
            kernel.launches = 0
            sched_m, stats_m, arr_m, wall_m = serve_cli.run_scheduler_trace(
                args, cfg, model, device, sharded, mesh=mesh)
            n = kernel.launches
            want = cfg.num_layers * (stats_m.decode_steps
                                     if kernel is paged_decode
                                     else stats_m.prefills)
            assert n == want > 0, (tag, n, want)
            assert trace_stats(stats_m, sched_m) == trace_stats(stats, sched)
            parted = check_tokens(
                f"serve-mesh {tag}",
                {r.rid: list(r.out_tokens) for _, r in arr_m},
                {r.rid: list(r.out_tokens) for _, r in arrivals}, margins)
            tps, tps_m = (stats.tokens_generated / wall,
                          stats_m.tokens_generated / wall_m)
            log(f"[serve-mesh] {tag} ({cfg.name}, {args.requests} requests, "
                f"{args.gen} new tokens): bare {wall:.3f} s = {tps:.1f} "
                f"tokens/s; --mesh host (1, 1) {wall_m:.3f} s = "
                f"{tps_m:.1f} tokens/s, overhead {wall_m / wall:.2f}x; "
                f"{stats_m.decode_steps} decode steps, {stats_m.prefills} "
                f"prefills, {kernel.__name__} launches {n}; every stat "
                f"equal, tokens equal but for {len(parted)} near-tie "
                f"partings {parted}")
            launches[kernel.__name__] = n
            if profile:
                for label, p, m in (("bare", params, None),
                                    ("--mesh host", sharded, mesh)):
                    profile_main_path(
                        lambda: serve_cli.run_scheduler_trace(
                            args, cfg, model, device, p, mesh=m)[3],
                        f"serve-mesh {tag} {label}")
            del sched, sched_m, params, sharded
            torch.cuda.empty_cache()

        # the direct path, teacher-forced with the bare run's tokens
        args = serve_cli.parse_args(SERVE_MESH_DIRECT_ARGV)
        cfg = get_arch(args.arch)
        model = build_model(cfg)
        params = serve_cli.init_params(model, args, device)
        bare = serve_cli.run_direct(args, cfg, model, device, params,
                                    keep_logits=True)
        sharded = shard_params(params, model, mesh)
        on = serve_cli.run_direct(args, cfg, model, device, sharded,
                                  mesh=mesh, keep_logits=True,
                                  forced=bare["sampled"])
        want, got = bare["logits"].float(), on["logits"].float()
        assert torch.isfinite(got).all() and got.shape == want.shape
        err = float((got - want).abs().max())
        biggest = float(want.abs().max())
        assert err <= LOGIT_TOL * biggest, (err, biggest)
        B, gen = args.batch, args.gen
        log(f"[serve-mesh] direct qwen1.5-0.5b {B} x {args.prompt_len} + "
            f"{gen}: logits max |mesh - bare| {err:.3e} of max |logit| "
            f"{biggest:.3f} (tolerance {LOGIT_TOL}); prefill "
            f"{bare['prefill_s']:.3f} s bare, {on['prefill_s']:.3f} s mesh;"
            f" decode {B * gen / bare['decode_s']:.1f} tokens/s bare, "
            f"{B * gen / on['decode_s']:.1f} tokens/s mesh")
    finally:
        dist.destroy_process_group()
    return launches


# ---------------------------------------------------------------------------
# the hybrid kind (recurrentgemma-9b) and the chunked flash_attention
# ---------------------------------------------------------------------------

def flash_counter():
    """Count the calls of ``attention.flash_attention`` (plain torch, no
    kernel: the count shows that a path went through flash). Returns
    (the count, a function that removes the patch)."""
    from repro_torch.models import attention as attn
    count = [0]
    original = attn.flash_attention

    def counted(*a, **kw):
        count[0] += 1
        return original(*a, **kw)

    attn.flash_attention = counted
    return count, lambda: setattr(attn, "flash_attention", original)


def phase_serve_hybrid(profile: bool = False) -> int:
    """The serve CLI's paged scheduler on the full recurrentgemma-9b (38
    layers: 12 local-attention layers with a 2,048-token window, 26
    RG-LRU layers; random f32 weights from seed 0) through a trace whose
    prompts cross the window: the main path (``paged_decode`` with its
    window band in every attention layer of every decode step), the
    plain gather and the ring ``ContinuousScheduler`` (one-shot prefills
    through flash) held to it, teacher-forced logits, and the trace's
    counts held to a CPU run at reduced width. Returns paged_decode's
    launches in the main path's run."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels.paged_decode import paged_decode
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_items, tree_map
    from repro_torch.models.transformer import hybrid_layout
    from repro_torch.serving import (
        PageTable, PagedContinuousScheduler, pages_per_slot)

    args = serve_cli.parse_args(SERVE_HYBRID_ARGV)
    cfg = get_arch(args.arch)
    assert (cfg.kind, cfg.num_layers, cfg.d_model, cfg.attention_window) \
        == ("hybrid", 38, 4096, 2048), cfg
    n_attn = hybrid_layout(cfg)[1]
    model = build_model(cfg)
    device = torch.device("cuda")
    params = serve_cli.init_params(model, args, device)
    n_params = sum(t.numel() for _, t in tree_items(params))
    assert n_params == HYBRID_P, n_params

    def run(argv=(), **over):
        a = serve_cli.parse_args(SERVE_HYBRID_ARGV + list(argv))
        return serve_cli.run_scheduler_trace(a, cfg, model, device, params,
                                             **over)

    # the trace's counts at reduced width on the CPU (they follow from the
    # trace, not from the weights)
    small = cfg.reduced()
    cpu_sched, cpu_stats, _, cpu_wall = serve_cli.run_scheduler_trace(
        serve_cli.parse_args(SERVE_HYBRID_ARGV + ["--reduced"]), small,
        build_model(small), torch.device("cpu"))
    log(f"[serve-hybrid] the trace on the CPU at reduced width: "
        f"{cpu_stats.prefills} prefills, {cpu_stats.decode_steps} decode "
        f"steps, {cpu_stats.tokens_generated} tokens ({cpu_wall:.1f} s)")

    # warm-up: allocator, cuBLAS handles at these widths
    _, st, _, wall = run(["--requests", "1", "--gen", "2", "--prompt-len",
                          "256"])
    log(f"[serve-hybrid] warm-up: 1 request, {st.decode_steps} decode "
        f"steps in {wall:.3f} s")

    # the main path: the paged scheduler with the kernel (auto-on)
    torch.cuda.reset_peak_memory_stats()
    paged_decode.launches = 0
    sched, stats, arrivals, wall = run()
    launches = paged_decode.launches
    peak = torch.cuda.max_memory_allocated()
    main = trace_stats(stats, sched)
    pool_bytes = sum(t.numel() * t.element_size()
                     for t in sched._cache["groups"]["attn"].values())
    assert sched.paged_kernel and stats.requests_done == args.requests
    assert main == trace_stats(cpu_stats, cpu_sched), "the counts moved"
    assert launches == n_attn * stats.decode_steps, launches
    assert sched.table.num_free == sched.cache_pages - 1   # no page leaked
    assert sched.prefix_pages_possible == 0                # no sharing
    assert all(len(r.out_tokens) == r.budget for _, r in arrivals)
    plens = sorted(len(r.prompt) for _, r in arrivals)
    last = {r.rid: len(r.prompt) + len(r.out_tokens) - 1
            for _, r in arrivals}
    past = sorted(rid for rid, p in last.items()
                  if p >= cfg.attention_window)
    assert past, "no slot decoded past the window"
    log(f"[serve-hybrid] recurrentgemma-9b paged (kernel): {n_params} "
        f"parameters, {stats.requests_done} requests (prompts {plens}), "
        f"{stats.prefills} prefills in {sum(main['prefill_chunks'])} "
        f"chunks, {stats.decode_steps} decode steps, "
        f"{stats.tokens_generated} tokens in {wall:.3f} s = "
        f"{stats.tokens_generated / wall:.1f} tokens/s, "
        f"{stats.decode_steps / wall:.2f} decode steps/s, util "
        f"{stats.utilization:.3f}; {len(past)} requests decoded past the "
        f"{cfg.attention_window}-token window (last positions "
        f"{sorted(last.values())}); paged_decode launches {launches} = "
        f"{n_attn} x {stats.decode_steps}, pool {pool_bytes} B, "
        f"max_memory_allocated {peak} B, no page leaked; every stat and "
        f"record equal to the CPU run")
    kernel_tokens = {r.rid: list(r.out_tokens) for _, r in arrivals}
    del sched
    torch.cuda.empty_cache()
    if profile:
        profile_main_path(lambda: run()[3], "serve-hybrid trace (paged)")
        # the RG-LRU scan's share: its elementwise kernels carry no name of
        # their own, so time it alone at a prefill chunk's shape
        from repro_torch.models.rglru import linear_scan
        gen = torch.Generator(device="cuda").manual_seed(0)
        shape = (1, args.prefill_chunk, cfg.rglru_width)
        a = torch.rand(shape, generator=gen, device="cuda")
        b = torch.randn(shape, generator=gen, device="cuda")
        scan_ms = device_ms(lambda: linear_scan(a, b), iters=50)
        n_scans = (cfg.num_layers - n_attn) * sum(main["prefill_chunks"])
        log(f"[profile] RG-LRU linear_scan at {shape}: {scan_ms:.4f} ms a "
            f"call; {n_scans} calls in the trace's prefill chunks = "
            f"{scan_ms * n_scans / 1e3:.3f} s of device time")
        del a, b

    # the same trace through the plain gather, recording its margins
    paged_decode.launches = 0
    margins, unpatch = record_margins(PagedContinuousScheduler)
    try:
        sched, stats, arrivals, wall2 = run(paged_kernel=False)
    finally:
        unpatch()
    assert paged_decode.launches == 0
    assert trace_stats(stats, sched) == main
    plain_tokens = {r.rid: list(r.out_tokens) for _, r in arrivals}
    parted = check_tokens("kernel", kernel_tokens, plain_tokens, margins)
    closest = min(m / b for m, b in margins.values())
    log(f"[serve-hybrid] plain gather: {wall2:.3f} s = "
        f"{stats.tokens_generated / wall2:.1f} tokens/s (margins recorded), "
        f"every stat and record equal to the kernel run; "
        f"{len(plain_tokens) - len(parted)}/{len(plain_tokens)} requests "
        f"with identical greedy tokens, partings (rid, token, margin / "
        f"max|logit|) {parted}; smallest top-two margin "
        f"{closest:.3e} of max |logit| (tol {LOGIT_TOL})")
    del sched
    torch.cuda.empty_cache()

    # the ring scheduler: one-shot prefills of prompts padded to 3072,
    # every attention layer through flash; a ring of 2048 slots
    flashes, unpatch = flash_counter()
    try:
        sched, stats, arrivals, wall3 = run(["--scheduler", "continuous"])
    finally:
        unpatch()
    ring = sched._cache["groups"]["attn"]["k"].shape[2]
    assert ring == cfg.attention_window, ring
    assert flashes[0] == n_attn * stats.prefills, flashes
    for f in ("requests_done", "prefills", "tokens_generated"):
        assert getattr(stats, f) == main[f], f
    parted_ring = check_tokens(
        "continuous", {r.rid: list(r.out_tokens) for _, r in arrivals},
        plain_tokens, margins)
    log(f"[serve-hybrid] ring ContinuousScheduler: {wall3:.3f} s = "
        f"{stats.tokens_generated / wall3:.1f} tokens/s, "
        f"{stats.decode_steps} decode steps, a ring of {ring}, "
        f"flash_attention calls {flashes[0]} = {n_attn} x "
        f"{stats.prefills} one-shot prefills of {args.prompt_len} tokens; "
        f"requests, prefills and tokens equal to the paged run; partings "
        f"from the plain paged run {parted_ring}")
    del sched
    torch.cuda.empty_cache()

    # teacher forcing: the longest and the shortest prompt prefilled in
    # chunks of 256, then 8 decode steps fed the same tokens through the
    # kernel and through the plain gather
    ps, chunk, steps = args.page_size, args.prefill_chunk, 8
    order = sorted(arrivals, key=lambda a: len(a[1].prompt))
    reqs = [order[-1][1], order[0][1]]
    P = pages_per_slot(args.prompt_len + args.gen, ps)
    cache = model.init_paged_cache(2, 2 * P + 1, ps, torch.float32,
                                   device="cuda")
    table = PageTable(2 * P + 1, ps)
    page_map = np.zeros((2, P), np.int32)
    for b, req in enumerate(reqs):
        plen = len(req.prompt)
        pages = table.alloc(-(-(plen + steps) // ps))
        page_map[b, :len(pages)] = pages
        padded = np.zeros((1, -(-plen // chunk) * chunk), np.int32)
        padded[0, :plen] = req.prompt
        for start in range(0, plen, chunk):
            toks = torch.from_numpy(padded[:, start:start + chunk]).cuda()
            model.prefill_chunk(params, cache, toks, start,
                                min(chunk, plen - start), page_map[b], b,
                                dtype=torch.float32)
    cache_plain = tree_map(lambda t: t.clone(), cache)
    feed = np.random.default_rng(5).integers(
        1, cfg.vocab_size, size=(steps, 2, 1)).astype(np.int32)
    pm = torch.from_numpy(page_map).cuda()
    live = torch.ones(2, dtype=torch.bool, device="cuda")
    pos = torch.tensor([len(r.prompt) for r in reqs], dtype=torch.int32,
                       device="cuda")
    tf_err = tf_max = 0.0
    for i in range(steps):
        tok = torch.from_numpy(feed[i]).cuda()
        lk, _ = model.decode_step_paged(params, tok, cache, pos, pm, live,
                                        dtype=torch.float32, use_kernel=True)
        lp, _ = model.decode_step_paged(params, tok, cache_plain, pos, pm,
                                        live, dtype=torch.float32,
                                        use_kernel=False)
        assert torch.isfinite(lk).all()
        tf_err = max(tf_err, float((lk - lp).abs().max()))
        tf_max = max(tf_max, float(lp.abs().max()))
        pos = pos + 1
    assert tf_err <= LOGIT_TOL * tf_max, (tf_err, tf_max)
    log(f"[serve-hybrid] teacher forcing, prompts of "
        f"{[len(r.prompt) for r in reqs]} tokens in chunks of {chunk}, "
        f"{steps} decode steps: logits max |kernel - plain| {tf_err:.3e} "
        f"= {tf_err / tf_max:.3e} of max |logit| {tf_max:.3f} (tol "
        f"{LOGIT_TOL})")
    del cache, cache_plain, params
    torch.cuda.empty_cache()
    return launches


def phase_scale_hybrid() -> int:
    """ScaleTrainer on recurrentgemma-9b at full width and depth 5 (one
    (rec, rec, attn) group and the two-layer tail, the full model's
    structure): 2 replicas in one cluster of 2, τ 20, consensus every 5,
    Γ 2, batch 4 x 128, f32. The fused interval through
    ``fused_consensus_sgd`` on the hybrid's flat (2, P) buffer (4
    launches an interval), the per-leaf step held to it (loss rtol 1e-4,
    the same ledger, the global model within atol 1e-5). Returns the
    fused run's launches."""
    import dataclasses

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core.distributed import TTHFScaleConfig
    from repro_torch.kernels.consensus_mix import consensus_mix
    from repro_torch.kernels.fused_consensus_sgd import fused_consensus_sgd
    from repro_torch.kernels.fused_sgd import fused_sgd
    from repro_torch.models.common import tree_leaves

    cfg = dataclasses.replace(get_arch("recurrentgemma-9b"),
                              num_layers=SCALE_HYBRID_LAYERS)
    scale = TTHFScaleConfig(replicas=2, cluster_size=2, tau=20,
                            consensus_every=5, gamma_d2d=2, lr=SCALE_LR)
    batch, seq, intervals = 4, 128, 2
    tokens = intervals * scale.tau * scale.replicas * batch * seq
    # each run draws its weights in the trainer's init from seed 0 (the
    # same weights): a third 8.7 GB copy held beside the (2, P) buffer,
    # its gradient, the kernel's output and the buffer it replaces would
    # not fit the 80 GB
    torch.cuda.reset_peak_memory_stats()
    fused_consensus_sgd.launches = consensus_mix.launches = 0
    fused_sgd.launches = 0
    tr, losses, wall, ledger = scale_run(cfg, scale, True, intervals,
                                         "hybrid_fused", batch=batch,
                                         seq=seq)
    launches = fused_consensus_sgd.launches
    peak = torch.cuda.max_memory_allocated()
    assert tr._spec.total == SCALE_HYBRID_P, tr._spec.total
    assert np.isfinite(losses).all() and len(losses) == intervals, losses
    assert launches == intervals * scale.tau // scale.consensus_every, \
        launches
    assert consensus_mix.launches == fused_sgd.launches == 0
    spec = tr._spec
    g_fused = tr.params[0].cpu()
    log(f"[scale-hybrid] recurrentgemma-9b depth {cfg.num_layers} "
        f"({SCALE_HYBRID_P} parameters a replica, flat buffer "
        f"{tuple(tr.params.shape)}) fused interval: {intervals} intervals "
        f"in {wall:.3f} s = {intervals / wall:.4f} intervals/s, "
        f"{tokens / wall:.1f} tokens/s, loss {losses}, ledger {ledger}, "
        f"fused_consensus_sgd launches {launches}, max_memory_allocated "
        f"{peak} B")
    del tr
    torch.cuda.empty_cache()

    fused_consensus_sgd.launches = 0
    torch.cuda.reset_peak_memory_stats()
    tr2, losses2, wall2, ledger2 = scale_run(cfg, scale, False, intervals,
                                             "hybrid_perleaf", batch=batch,
                                             seq=seq)
    peak2 = torch.cuda.max_memory_allocated()
    assert fused_consensus_sgd.launches == 0
    np.testing.assert_allclose(losses2, losses, rtol=1e-4)
    assert ledger2 == ledger, (ledger2, ledger)
    diff = max(float((a - b.cuda()).abs().max()) for a, b in zip(
        tree_leaves(tr2._global_params()), spec.leaf_views(g_fused)))
    assert diff <= 1e-5, diff
    log(f"[scale-hybrid] per-leaf step: {intervals} intervals in "
        f"{wall2:.3f} s = {tokens / wall2:.1f} tokens/s, loss {losses2} "
        f"(rtol 1e-4 vs the fused run), same ledger, max_memory_allocated "
        f"{peak2} B, global model max |diff| {diff:.3e} (atol 1e-5)")
    del tr2, g_fused
    torch.cuda.empty_cache()
    return launches


def moe_aux_spy():
    """Record the aux values (load_balance, router_z, drop_frac) of every
    ``apply_moe`` call, one host copy each. Returns (the records, a
    function that removes the patch)."""
    from repro_torch.models import moe
    seen = []
    original = moe.apply_moe

    def spy(*a, **kw):
        y, aux = original(*a, **kw)
        seen.append({k: float(v) for k, v in aux.items()})
        return y, aux

    moe.apply_moe = spy
    return seen, lambda: setattr(moe, "apply_moe", original)


def phase_serve_moe(profile: bool = False) -> int:
    """The serve CLI's paged scheduler on llama4-scout at full width and
    depth 4 (16 experts, top-1, capacity factor 1.25; random f32 weights
    from seed 0): the main path (``paged_decode`` in every layer of every
    decode step, at the ``scout-serve`` shape), the plain gather held to
    it through the same scheduler, chunks and slots (so the same
    routing), teacher-forced logits, the trace's counts held to a CPU run
    at reduced width, and the routers' drop share in a prefill chunk and
    a decode step. Returns paged_decode's launches in the main path's
    run."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels.paged_decode import paged_decode
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_items, tree_map
    from repro_torch.serving import (
        PageTable, PagedContinuousScheduler, pages_per_slot)

    args = serve_cli.parse_args(SERVE_MOE_ARGV)
    cfg = dataclasses.replace(get_arch(args.arch),
                              num_layers=SERVE_MOE_LAYERS)
    assert (cfg.kind, cfg.moe_every, cfg.moe_num_experts, cfg.d_model,
            cfg.d_ff, cfg.moe_capacity_factor) == \
        ("moe", 1, 16, 5120, 8192, 1.25), cfg
    model = build_model(cfg)
    device = torch.device("cuda")
    params = serve_cli.init_params(model, args, device)
    n_params = sum(t.numel() for _, t in tree_items(params))
    assert n_params == SERVE_MOE_P, n_params

    def run(argv=(), **over):
        a = serve_cli.parse_args(SERVE_MOE_ARGV + list(argv))
        return serve_cli.run_scheduler_trace(a, cfg, model, device, params,
                                             **over)

    # the trace's counts at reduced width on the CPU (they follow from the
    # trace, not from the weights)
    small = get_arch(args.arch).reduced()
    cpu_sched, cpu_stats, _, cpu_wall = serve_cli.run_scheduler_trace(
        serve_cli.parse_args(SERVE_MOE_ARGV + ["--reduced"]), small,
        build_model(small), torch.device("cpu"))
    log(f"[serve-moe] the trace on the CPU at reduced width: "
        f"{cpu_stats.prefills} prefills, {cpu_stats.decode_steps} decode "
        f"steps, {cpu_stats.tokens_generated} tokens ({cpu_wall:.1f} s)")

    # warm-up: allocator, cuBLAS handles at these widths
    _, st, _, wall = run(["--requests", "1", "--gen", "2", "--prompt-len",
                          "256"])
    log(f"[serve-moe] warm-up: 1 request, {st.decode_steps} decode steps "
        f"in {wall:.3f} s")

    # the main path: the paged scheduler with the kernel (auto-on)
    torch.cuda.reset_peak_memory_stats()
    paged_decode.launches = 0
    sched, stats, arrivals, wall = run()
    launches = paged_decode.launches
    peak = torch.cuda.max_memory_allocated()
    main = trace_stats(stats, sched)
    B, K, G, hd, ps, P, N = PAGED_CASES["scout-serve"][:7]
    assert (sched.slots, cfg.num_kv_heads, cfg.num_heads // K, cfg.head_dim,
            sched.page_size, sched.pages_slot, sched.cache_pages) == \
        (B, K, G, hd, ps, P, N), "the scout-serve case left the path"
    assert sched.paged_kernel and stats.requests_done == args.requests
    assert main == trace_stats(cpu_stats, cpu_sched), "the counts moved"
    assert launches == cfg.num_layers * stats.decode_steps, launches
    assert sched.table.num_free == sched.cache_pages - 1   # no page leaked
    assert sched.prefix_pages_hit > 0                      # the template
    assert all(len(r.out_tokens) == r.budget for _, r in arrivals)
    log(f"[serve-moe] llama4-scout depth {cfg.num_layers} paged (kernel): "
        f"{n_params} parameters, {stats.requests_done} requests, "
        f"{stats.prefills} prefills in {sum(main['prefill_chunks'])} "
        f"chunks, prefix pages hit {sched.prefix_pages_hit} of "
        f"{sched.prefix_pages_possible}, {stats.decode_steps} decode "
        f"steps, {stats.tokens_generated} tokens in {wall:.3f} s = "
        f"{stats.tokens_generated / wall:.1f} tokens/s, "
        f"{stats.decode_steps / wall:.2f} decode steps/s, util "
        f"{stats.utilization:.3f}; paged_decode launches {launches} = "
        f"{cfg.num_layers} x {stats.decode_steps}, max_memory_allocated "
        f"{peak} B, no page leaked; every stat and record equal to the "
        f"CPU run")
    kernel_tokens = {r.rid: list(r.out_tokens) for _, r in arrivals}
    del sched
    torch.cuda.empty_cache()
    if profile:
        profile_main_path(lambda: run()[3], "serve-moe trace (paged)")

    # the same trace through the plain gather, recording its logits'
    # margins and its routing; then the kernel's trace again, recording
    # its routing (its tokens must be the timed run's)
    paged_decode.launches = 0
    margins, unpatch = record_margins(PagedContinuousScheduler)
    plain_route, calls_at, unpatch_route = record_routing(
        PagedContinuousScheduler)
    try:
        sched, stats, arrivals, wall2 = run(paged_kernel=False)
    finally:
        unpatch_route()
        unpatch()
    assert paged_decode.launches == 0
    assert trace_stats(stats, sched) == main
    plain_tokens = {r.rid: list(r.out_tokens) for _, r in arrivals}
    del sched
    kernel_route, _, unpatch_route = record_routing(PagedContinuousScheduler)
    try:
        sched, stats, arrivals, _ = run()
    finally:
        unpatch_route()
    assert {r.rid: list(r.out_tokens) for _, r in arrivals} == \
        kernel_tokens, "two kernel runs gave other tokens"
    split = first_routing_split(kernel_route, plain_route)
    parted = check_tokens("kernel", kernel_tokens, plain_tokens, margins,
                          None if split is None else split[0], calls_at)
    closest = min(m / b for m, b in margins.values())
    near = min(float(r.min()) for _, r in plain_route)
    log(f"[serve-moe] plain gather: {wall2:.3f} s = "
        f"{stats.tokens_generated / wall2:.1f} tokens/s (margins and "
        f"routing recorded), every stat and record equal to the kernel "
        f"run; {len(plain_tokens) - len(parted)}/{len(plain_tokens)} "
        f"requests with identical greedy tokens, partings (rid, token, "
        f"margin / max|logit|) {parted}; smallest top-two margin "
        f"{closest:.3e} of max |logit| (tol {LOGIT_TOL}); {len(plain_route)} "
        f"router calls, the routing of the kernel's second run (its tokens "
        f"the first's) against the plain run's: first routed apart at "
        f"(call, token, margin / max |router logit|) {split}; the closest "
        f"router top two {near:.3e} of max |router logit|")
    del sched
    torch.cuda.empty_cache()

    # teacher forcing: the longest and the shortest prompt prefilled in
    # chunks of 256 (the routers' aux recorded in the first chunk), then
    # 8 decode steps fed the same tokens through the kernel and through
    # the plain gather (the 2 slots one routing group, capacity 1)
    ps, chunk, steps = args.page_size, args.prefill_chunk, 8
    order = sorted(arrivals, key=lambda a: len(a[1].prompt))
    reqs = [order[-1][1], order[0][1]]
    P = pages_per_slot(args.prompt_len + args.gen, ps)
    cache = model.init_paged_cache(2, 2 * P + 1, ps, torch.float32,
                                   device="cuda")
    table = PageTable(2 * P + 1, ps)
    page_map = np.zeros((2, P), np.int32)
    prefill_aux, unpatch = moe_aux_spy()
    try:
        for b, req in enumerate(reqs):
            plen = len(req.prompt)
            pages = table.alloc(-(-(plen + steps) // ps))
            page_map[b, :len(pages)] = pages
            padded = np.zeros((1, -(-plen // chunk) * chunk), np.int32)
            padded[0, :plen] = req.prompt
            for start in range(0, plen, chunk):
                toks = torch.from_numpy(padded[:, start:start + chunk]).cuda()
                model.prefill_chunk(params, cache, toks, start,
                                    min(chunk, plen - start), page_map[b],
                                    b, dtype=torch.float32)
    finally:
        unpatch()
    first_chunk = prefill_aux[:cfg.num_layers]
    cache_plain = tree_map(lambda t: t.clone(), cache)
    feed = np.random.default_rng(5).integers(
        1, cfg.vocab_size, size=(steps, 2, 1)).astype(np.int32)
    pm = torch.from_numpy(page_map).cuda()
    live = torch.ones(2, dtype=torch.bool, device="cuda")
    pos = torch.tensor([len(r.prompt) for r in reqs], dtype=torch.int32,
                       device="cuda")
    tf_err = tf_max = 0.0
    decode_aux = []
    for i in range(steps):
        tok = torch.from_numpy(feed[i]).cuda()
        if i == 0:
            decode_aux, unpatch = moe_aux_spy()
        try:
            lk, _ = model.decode_step_paged(params, tok, cache, pos, pm,
                                            live, dtype=torch.float32,
                                            use_kernel=True)
        finally:
            if i == 0:
                unpatch()
        lp, _ = model.decode_step_paged(params, tok, cache_plain, pos, pm,
                                        live, dtype=torch.float32,
                                        use_kernel=False)
        assert torch.isfinite(lk).all()
        tf_err = max(tf_err, float((lk - lp).abs().max()))
        tf_max = max(tf_max, float(lp.abs().max()))
        pos = pos + 1
    assert tf_err <= LOGIT_TOL * tf_max, (tf_err, tf_max)
    assert len(first_chunk) == len(decode_aux) == cfg.num_layers

    def mean(recs, k):
        return sum(r[k] for r in recs) / len(recs)
    log(f"[serve-moe] teacher forcing, prompts of "
        f"{[len(r.prompt) for r in reqs]} tokens in chunks of {chunk}, "
        f"{steps} decode steps: logits max |kernel - plain| {tf_err:.3e} "
        f"= {tf_err / tf_max:.3e} of max |logit| {tf_max:.3f} (tol "
        f"{LOGIT_TOL}); the routers over the {cfg.num_layers} layers: "
        f"drop_frac {mean(first_chunk, 'drop_frac'):.4f} in the first "
        f"prefill chunk ({min(chunk, len(reqs[0].prompt))} tokens, "
        f"capacity "
        f"{max(1, round(chunk * cfg.moe_capacity_factor / cfg.moe_num_experts))}"
        f" "
        f"an expert), {mean(decode_aux, 'drop_frac'):.4f} in a decode "
        f"step (2 slots, capacity 1); load_balance "
        f"{mean(first_chunk, 'load_balance'):.4f}, router_z "
        f"{mean(first_chunk, 'router_z'):.4f} in the chunk")
    del cache, cache_plain, params
    torch.cuda.empty_cache()
    return launches


def phase_scale_moe(profile: bool = False) -> int:
    """ScaleTrainer on llama4-maverick's layout (one {dense_0, moe} group,
    depth 2) at full d_model, d_ff and heads, 8 experts and a vocabulary
    of 32,768 (1,593,902,080 parameters a replica): 2 replicas in one
    cluster of 2, τ 20, consensus every 5, Γ 2, batch 4 x 128, f32, the
    loss with both aux terms. After a warm-up, 2 fused intervals through
    ``fused_consensus_sgd`` (4 launches an interval) and the per-leaf
    step held to them bitwise (losses, ledger, every parameter of the
    global model); the aux terms of the trained model printed. Returns
    the fused run's launches."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core.distributed import TTHFScaleConfig
    from repro_torch.kernels.consensus_mix import consensus_mix
    from repro_torch.kernels.fused_consensus_sgd import fused_consensus_sgd
    from repro_torch.kernels.fused_sgd import fused_sgd
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.transformer import group_layout

    cfg = dataclasses.replace(get_arch("llama4-maverick-400b-a17b"),
                              num_layers=2,
                              moe_num_experts=SCALE_MOE_EXPERTS,
                              vocab_size=SCALE_MOE_VOCAB)
    assert group_layout(cfg)[1:] == (1, 0) and cfg.d_model == 5120, cfg
    scale = TTHFScaleConfig(replicas=2, cluster_size=2, tau=20,
                            consensus_every=5, gamma_d2d=2, lr=SCALE_LR)
    batch, seq, intervals = 4, 128, 2
    tokens = intervals * scale.tau * scale.replicas * batch * seq
    model = build_model(cfg)
    w0 = model.init(torch.Generator(device="cuda").manual_seed(0), "cuda")

    def run(fused: bool, n: int, name: str):
        return scale_run(cfg, scale, fused, n, name, batch=batch, seq=seq,
                         weights=w0)

    # warm-up: allocator, cuBLAS handles, the kernel's first load
    tr, losses, wall, _ = run(True, 1, "moe_warmup")
    log(f"[scale-moe] warm-up: 1 fused interval in {wall:.3f} s, loss "
        f"{losses}")
    del tr
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    fused_consensus_sgd.launches = consensus_mix.launches = 0
    fused_sgd.launches = 0
    tr, losses, wall, ledger = run(True, intervals, "moe_fused")
    launches = fused_consensus_sgd.launches
    peak = torch.cuda.max_memory_allocated()
    assert tr._spec.total == SCALE_MOE_P, tr._spec.total
    assert np.isfinite(losses).all() and len(losses) == intervals, losses
    assert launches == intervals * scale.tau // scale.consensus_every, \
        launches
    assert consensus_mix.launches == fused_sgd.launches == 0
    spec = tr._spec
    g_fused = tr.params[0].clone()
    log(f"[scale-moe] maverick layout, {cfg.moe_num_experts} experts, "
        f"vocabulary {cfg.vocab_size} ({SCALE_MOE_P} parameters a replica, "
        f"flat buffer {tuple(tr.params.shape)}) fused interval: "
        f"{intervals} intervals in {wall:.3f} s = {intervals / wall:.4f} "
        f"intervals/s, {tokens / wall:.1f} tokens/s, loss {losses}, ledger "
        f"{ledger}, fused_consensus_sgd launches {launches}, "
        f"max_memory_allocated {peak} B")
    del tr
    torch.cuda.empty_cache()
    if profile:
        profile_main_path(lambda: run(True, 1, "moe_profile")[2],
                          "1 scale-moe interval (fused)")
        torch.cuda.empty_cache()

    fused_consensus_sgd.launches = 0
    torch.cuda.reset_peak_memory_stats()
    tr2, losses2, wall2, ledger2 = run(False, intervals, "moe_perleaf")
    peak2 = torch.cuda.max_memory_allocated()
    assert fused_consensus_sgd.launches == 0
    assert losses2 == losses, (losses2, losses)
    assert ledger2 == ledger, (ledger2, ledger)
    same = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(tr2._global_params()), spec.leaf_views(g_fused)))
    assert same, "the per-leaf global model is not the fused one"
    log(f"[scale-moe] per-leaf step: {intervals} intervals in {wall2:.3f} "
        f"s = {tokens / wall2:.1f} tokens/s, loss {losses2}, the same "
        f"ledger, max_memory_allocated {peak2} B; losses and every "
        f"parameter of the global model bitwise the fused run's")
    # the trained global model's aux terms on one seeded batch
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, size=(batch, seq))).cuda()
    with torch.no_grad():
        _, aux = model.forward(spec.unflatten_one(g_fused),
                               {"tokens": toks}, dtype=torch.float32)
    assert all(np.isfinite(float(v)) for v in aux.values()), aux
    log(f"[scale-moe] the trained global model on a batch of {batch} x "
        f"{seq}: load_balance {float(aux['load_balance']):.6f} (1 is "
        f"balanced), router_z {float(aux['router_z']):.6f}")
    del tr2, g_fused, w0
    torch.cuda.empty_cache()
    return launches


def phase_flash() -> None:
    """``flash_attention`` at full width: qwen1.5-0.5b (24 layers) on one
    4,096-token sequence, the loss and every parameter's gradient through
    flash (the training path past 2,048 tokens) against the materialized
    attention (``flash_threshold`` raised: some 1 GB of f32 scores kept
    a layer); and a one-shot ring prefill of a 3,000-token prompt
    (through flash) against the same prompt in 256-token paged chunks."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    from repro_torch.serving import pages_per_slot

    cfg = get_arch("qwen1.5-0.5b")
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(1, FLASH_T))).cuda()
    hold_flash_loss("flash", model, params, {"tokens": toks},
                    flash_calls=cfg.num_layers)

    # a one-shot ring prefill past 2,048 tokens against paged chunks
    prompt = np.random.default_rng(1).integers(
        1, cfg.vocab_size, size=FLASH_PREFILL_T).astype(np.int32)
    flashes, unpatch = flash_counter()
    try:
        with torch.no_grad():
            ring, _, pos = model.prefill(
                params, {"tokens": torch.from_numpy(prompt[None]).cuda()},
                dtype=torch.float32, cache_dtype=torch.float32)
    finally:
        unpatch()
    assert flashes[0] == cfg.num_layers and int(pos) == FLASH_PREFILL_T
    ps, chunk = 16, 256
    P = pages_per_slot(FLASH_PREFILL_T, ps)
    cache = model.init_paged_cache(1, P + 1, ps, torch.float32,
                                   device="cuda")
    row = np.arange(1, P + 1, dtype=np.int32)
    padded = np.zeros((1, -(-FLASH_PREFILL_T // chunk) * chunk), np.int32)
    padded[0, :FLASH_PREFILL_T] = prompt
    with torch.no_grad():
        for start in range(0, FLASH_PREFILL_T, chunk):
            _, paged = model.prefill_chunk(
                params, cache, torch.from_numpy(
                    padded[:, start:start + chunk]).cuda(), start,
                min(chunk, FLASH_PREFILL_T - start), row, 0,
                dtype=torch.float32)
    err = float((ring - paged).abs().max()) / float(paged.abs().max())
    assert torch.isfinite(ring).all() and err <= LOGIT_TOL, err
    log(f"[flash] one-shot ring prefill of a {FLASH_PREFILL_T}-token "
        f"prompt ({flashes[0]} flash_attention calls) against "
        f"{-(-FLASH_PREFILL_T // chunk)} paged chunks of {chunk}: last "
        f"logits max |diff| {err:.3e} of max |logit| (tol {LOGIT_TOL})")
    del params, cache
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the vlm and audio kinds (paligemma-3b, whisper-small) in direct serving
# ---------------------------------------------------------------------------

class materialized:
    """Inside it every sequence attention materializes its scores up to
    ``threshold`` positions: ``flash_threshold`` raised in
    ``attention.sequence_attention`` (which the engine's prefill calls)
    and in ``attention.attention_block`` (the model's layers, the cross
    blocks)."""

    def __init__(self, threshold: int):
        self.threshold = threshold

    def __enter__(self):
        import functools
        from repro_torch.models import attention as attn
        self.saved = attn.sequence_attention, attn.attention_block
        attn.sequence_attention = functools.partial(
            self.saved[0], flash_threshold=self.threshold)
        attn.attention_block = functools.partial(
            self.saved[1], flash_threshold=self.threshold)

    def __exit__(self, *exc):
        from repro_torch.models import attention as attn
        attn.sequence_attention, attn.attention_block = self.saved


def direct_main_path(tag: str, argv: list) -> tuple[list, int]:
    """The main path: ``launch/serve.py``'s ``main(argv)`` in direct mode
    on the card (its default), with the ``flash_attention`` calls
    counted (the prefill's, where it passes 2,048 positions). Returns
    the lines it printed and that count."""
    import contextlib
    import io

    import torch
    from repro_torch.launch import serve as serve_cli

    out = io.StringIO()
    torch.cuda.reset_peak_memory_stats()
    flashes, unpatch = flash_counter()
    t0 = time.time()
    try:
        with contextlib.redirect_stdout(out):
            rc = serve_cli.main(argv)
    finally:
        unpatch()
    wall = time.time() - t0
    lines = out.getvalue().splitlines()
    assert rc == 0, rc
    for line in lines:
        log(f"[{tag}] main: {line}")
    log(f"[{tag}] main path ``serve.main({' '.join(argv)})``: {wall:.3f} s "
        f"with the weights' init, {flashes[0]} flash_attention calls, "
        f"max_memory_allocated {torch.cuda.max_memory_allocated()} B")
    torch.cuda.empty_cache()
    return lines, flashes[0]


def direct_checks(tag: str, argv: list, n_params: int, main_lines: list):
    """The same direct run through ``run_direct`` with the same weights
    (the tokens must be the main path's), its logits kept: the prefill's
    last-token logits against a materialized prefill of the same batch,
    and the decode steps' logits, teacher-forced with the greedy tokens,
    against one ``forward`` over the frontend, the prompt and the
    tokens, each within 1e-4 of max |logit|. Returns (cfg, model, args,
    params, the run)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels.runtime import resolve_device
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_items

    args = serve_cli.parse_args(argv)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    device = resolve_device(args.device)
    params = serve_cli.init_params(model, args, device)
    n = sum(t.numel() for _, t in tree_items(params))
    assert n == n_params, n
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        run = serve_cli.run_direct(args, cfg, model, device, params,
                                   keep_logits=True)
    peak = torch.cuda.max_memory_allocated()
    assert main_lines[-1] == ("sampled token ids (first row): "
                              f"{run['sampled'][0].tolist()}"), \
        "run_direct left the main path's tokens"
    B, T, gen = args.batch, args.prompt_len, args.gen
    log(f"[{tag}] {cfg.name}: {n} parameters, batch {B}, prompt {T} "
        f"(+{cfg.enc_seq_len} {'patches' if cfg.kind == 'vlm' else 'frames'}"
        f"), {gen} new tokens: prefill {run['prefill_s']:.3f} s, decode "
        f"{run['decode_s']:.3f} s = {gen * B / run['decode_s']:.1f} "
        f"tokens/s, max_memory_allocated {peak} B")
    feed = {k: torch.as_tensor(v, device=device)
            for k, v in run["batch"].items()}
    got = run["logits"]                                 # (B, gen + 1, V)
    with torch.no_grad(), materialized(1 << 30):
        lm, _, pos_m = model.prefill(
            params, feed, dtype=torch.float32, cache_dtype=torch.float32,
            cache_len=T + gen + (cfg.enc_seq_len if cfg.kind == "vlm"
                                 else 0))
    pre_err = float((got[:, :1] - lm).abs().max()) / float(lm.abs().max())
    assert torch.isfinite(got).all() and pre_err <= LOGIT_TOL, pre_err
    assert int(pos_m) == T + (cfg.enc_seq_len if cfg.kind == "vlm" else 0)
    del lm
    seq = torch.cat([feed["tokens"], torch.as_tensor(
        run["sampled"], device=device)], dim=1)
    with torch.no_grad():
        full, _ = model.forward(params, {**feed, "tokens": seq},
                                dtype=torch.float32)
        want = full[:, T - 1:].clone()
    del full
    tf_err = float((got - want).abs().max())
    tf_max = float(want.abs().max())
    assert got.shape == want.shape == (B, gen + 1, cfg.padded_vocab)
    assert tf_err <= LOGIT_TOL * tf_max, (tf_err, tf_max)
    log(f"[{tag}] the prefill's last-token logits against a materialized "
        f"prefill: max |diff| {pre_err:.3e} of max |logit| (tol "
        f"{LOGIT_TOL}); the prefill and {gen} decode steps teacher-forced "
        f"against one forward over {seq.shape[1]} tokens"
        f"{' behind the patches' if cfg.kind == 'vlm' else ''}: max |diff| "
        f"{tf_err:.3e} = {tf_err / tf_max:.3e} of max |logit| {tf_max:.3f} "
        f"(tol {LOGIT_TOL})")
    del want, got
    torch.cuda.empty_cache()
    return cfg, model, args, params, run


def hold_flash_loss(tag: str, model, params, batch: dict,
                    flash_calls: int) -> None:
    """The loss, the logits and every parameter's gradient of ``batch``
    through ``flash_attention`` against the materialized attention, as
    [flash] holds them: loss rtol 1e-4, logits 1e-4 of max |logit|,
    gradient relative L2 1e-4."""
    import torch
    from repro_torch.models.common import softmax_cross_entropy, tree_leaves

    leaves = tree_leaves(params)

    def loss_and_grads():
        for leaf in leaves:
            leaf.requires_grad_(True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        logits, _ = model.forward(params, batch, dtype=torch.float32)
        loss = softmax_cross_entropy(logits, batch["tokens"])
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        wall = time.time() - t0
        for leaf in leaves:
            leaf.requires_grad_(False)
        return (logits.detach(), float(loss.detach()), grads, wall,
                torch.cuda.max_memory_allocated())

    flashes, unpatch = flash_counter()
    try:
        lf, loss_f, gf, wall_f, peak_f = loss_and_grads()
    finally:
        unpatch()
    assert flashes[0] == flash_calls, flashes
    with materialized(1 << 30):
        lm, loss_m, gm, wall_m, peak_m = loss_and_grads()
    logit_err = float((lf - lm).abs().max()) / float(lm.abs().max())
    num = sum(float(((a - b) ** 2).sum()) for a, b in zip(gf, gm))
    den = sum(float((b ** 2).sum()) for b in gm)
    grad_rel = (num / den) ** 0.5
    assert np.isfinite(loss_f) and abs(loss_f - loss_m) <= 1e-4 * abs(loss_m)
    assert logit_err <= LOGIT_TOL, logit_err
    assert grad_rel <= 1e-4, grad_rel
    positions = batch["tokens"].shape[1] + (
        batch["patches"].shape[1] if "patches" in batch else 0)
    log(f"[{tag}] loss and gradient of one {positions}-position sequence: "
        f"through flash_attention ({flashes[0]} calls) {loss_f:.6f} vs "
        f"materialized {loss_m:.6f}; logits max |diff| {logit_err:.3e} of "
        f"max |logit| (tol {LOGIT_TOL}); gradient relative L2 "
        f"{grad_rel:.3e} (tol 1e-4); forward + backward {wall_f:.3f} s, "
        f"max_memory_allocated {peak_f} B through flash; {wall_m:.3f} s, "
        f"{peak_m} B materialized")
    del lf, lm, gf, gm
    torch.cuda.empty_cache()


def direct_card_vs_cpu(tag: str, arch: str, card: str = "cuda") -> None:
    """A reduced config's direct run on the card (``card``) against the
    same run on the CPU, the same weights: logits within 1e-4 of max
    |logit|, greedy tokens equal."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_map

    args = serve_cli.parse_args(["--arch", arch, "--reduced", "--batch", "2",
                                 "--prompt-len", "16", "--gen", "8",
                                 "--temperature", "0"])
    small = get_arch(arch).reduced()
    sm = build_model(small)
    w_cpu = serve_cli.init_params(sm, args, torch.device("cpu"))
    w_gpu = tree_map(lambda t: t.to(card), w_cpu)
    with torch.no_grad():
        on_card = serve_cli.run_direct(args, small, sm, torch.device(card),
                                       w_gpu, keep_logits=True)
        on_cpu = serve_cli.run_direct(args, small, sm, torch.device("cpu"),
                                      w_cpu, keep_logits=True)
    err = float((on_card["logits"].cpu() - on_cpu["logits"]).abs().max())
    biggest = float(on_cpu["logits"].abs().max())
    assert err <= LOGIT_TOL * biggest, (err, biggest)
    assert np.array_equal(on_card["sampled"], on_cpu["sampled"])
    log(f"[{tag}] reduced {arch} direct run (batch 2, prompt 16, 8 new "
        f"tokens) on {card} vs cpu: logits max |diff| {err:.3e} of max "
        f"|logit| {biggest:.3f} (tol {LOGIT_TOL}), the same greedy tokens")


def profile_direct(tag: str, args, cfg, model, params) -> None:
    """One more direct run of ``args`` under ``torch.profiler``: the
    device time by kernel and the idle share of its prefill and decode."""
    import torch
    from repro_torch.launch import serve as serve_cli

    def once():
        with torch.no_grad():
            run = serve_cli.run_direct(args, cfg, model,
                                       params["embed"].device, params)
        return run["prefill_s"] + run["decode_s"]

    profile_main_path(once, f"{tag} direct run (prefill and decode)")


def phase_vlm(argv: list = VLM_ARGV, n_params: int = VLM_P,
              profile: bool = False) -> None:
    """The full paligemma-3b (all 18 layers, random f32 weights from seed
    0) through the serve CLI's direct mode at batch 8: 256 stub patches
    and a 1,920-token prompt, 2,176 positions, so the prefill attends
    through ``flash_attention`` under the prefix mask; 64 greedy tokens.
    The prefill held to a materialized one, the decode teacher-forced
    against the forward, one sequence's loss and gradient through flash
    against the materialized path, and a reduced paligemma on the card
    against the CPU."""
    import torch

    lines, flashes = direct_main_path("vlm", argv)
    cfg, model, args, params, run = direct_checks("vlm", argv, n_params,
                                                  lines)
    assert flashes == cfg.num_layers, flashes
    if profile:
        profile_direct("vlm", args, cfg, model, params)
    device = params["embed"].device
    one = {k: torch.as_tensor(v[:1], device=device)
           for k, v in run["batch"].items()}
    hold_flash_loss("vlm", model, params, one, flash_calls=cfg.num_layers)
    del params
    torch.cuda.empty_cache()
    direct_card_vs_cpu("vlm", cfg.name)


def phase_audio(argv: list = AUDIO_ARGV, n_params: int = AUDIO_P,
                long_t: int = AUDIO_LONG_T, profile: bool = False) -> None:
    """The full whisper-small (12 encoder and 12 decoder layers, 1,500
    frames; random f32 weights from seed 0) through the serve CLI's
    direct mode at batch 8, prompt 64, 64 greedy tokens: the prefill held
    to a materialized one, the decode teacher-forced against the
    forward; the encoder timed alone; one 4,096-token prompt through a
    one-shot prefill and through the loss and gradient, its causal
    self-attention and its cross-attention (1,500 keys padded to 2,048,
    ``k_len`` 1,500) through ``flash_attention``, against the
    materialized path; and a reduced whisper on the card against the
    CPU."""
    import torch
    from repro_torch.models.transformer import encode

    lines, flashes = direct_main_path("audio", argv)
    assert flashes == 0, flashes
    cfg, model, args, params, run = direct_checks("audio", argv, n_params,
                                                  lines)
    if profile:
        profile_direct("audio", args, cfg, model, params)
    frames = torch.as_tensor(run["batch"]["frames"],
                             device=params["embed"].device)
    with torch.no_grad():
        enc_ms = cuda_ms(lambda: encode(params, cfg, frames, torch.float32),
                         iters=5)
    log(f"[audio] the encoder over {args.batch} x {cfg.enc_seq_len} frames "
        f"({cfg.enc_num_layers} layers, f32): {enc_ms:.3f} ms (CUDA "
        f"events, the mean of 5)")

    # one long prompt: a one-shot prefill through flash against the
    # materialized prefill, then its loss and gradient
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, size=(1, long_t))).to(frames.device)
    long = {"tokens": toks, "frames": frames[:1]}
    flashes, unpatch = flash_counter()
    try:
        with torch.no_grad():
            lf, _, pos = model.prefill(params, long, dtype=torch.float32,
                                       cache_dtype=torch.float32)
    finally:
        unpatch()
    # every decoder layer: its self-attention, then its cross block
    assert flashes[0] == 2 * cfg.num_layers and int(pos) == long_t
    with torch.no_grad(), materialized(1 << 30):
        lm, _, _ = model.prefill(params, long, dtype=torch.float32,
                                 cache_dtype=torch.float32)
    err = float((lf - lm).abs().max()) / float(lm.abs().max())
    assert torch.isfinite(lf).all() and err <= LOGIT_TOL, err
    kc = min(1024, cfg.enc_seq_len)
    log(f"[audio] one-shot prefill of a {long_t}-token prompt "
        f"({flashes[0]} flash_attention calls: {cfg.num_layers} causal, "
        f"{cfg.num_layers} cross over {cfg.enc_seq_len} keys padded to "
        f"{-(-cfg.enc_seq_len // kc) * kc}) against the materialized "
        f"prefill: last logits max |diff| "
        f"{err:.3e} of max |logit| (tol {LOGIT_TOL})")
    del lf, lm
    hold_flash_loss("audio", model, params, long,
                    flash_calls=2 * cfg.num_layers)
    del params
    torch.cuda.empty_cache()
    direct_card_vs_cpu("audio", cfg.name)


def obs_dir(name: str) -> Path:
    """A fresh trace dir under chiprun_out/."""
    import shutil
    d = ROOT / "chiprun_out" / f"obs_{name}"
    shutil.rmtree(d, ignore_errors=True)
    return d


def obs_records(d: Path, kind: str) -> list:
    return [r for r in (json.loads(line) for line in
                        (d / "metrics.jsonl").read_text().splitlines())
            if r["kind"] == kind]


def obs_trace(d: Path) -> dict:
    """trace.json, validated; its span and counter names counted."""
    from repro_torch.obs import validate_chrome_trace
    doc = json.loads((d / "trace.json").read_text())
    problems = validate_chrome_trace(doc)
    assert not problems, problems[:5]
    names: dict = {}
    for e in doc["traceEvents"]:
        names[e["name"]] = names.get(e["name"], 0) + 1
    return names


def probe_ms(probe, params, iters: int = 5) -> float:
    """The divergence probe's time a call (CUDA events, drained)."""
    import torch
    probe(params)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        out = probe(params)
    end.record()
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(v).all()) for v in out.values())
    return start.elapsed_time(end) / iters


def phase_obs(slice_run: dict, scale_bare: dict, serve_bare: dict) -> dict:
    """The observability sink and checkpoints on three main paths, each
    held to its bare run: the sim NN (paper size, Γ 2, 40 steps) with a
    trace dir and then with the profiler; the full qwen1.5-0.5b scale
    path (4 replicas, fused, 2 intervals) instrumented, checkpointed after
    interval 1 and resumed in a fresh trainer; the serve CLI's paged trace
    with a trace dir. Returns each kernel's launches on these runs."""
    import shutil

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core import TTHFTrainer, theory
    from repro_torch.kernels.consensus_mix import consensus_mix
    from repro_torch.kernels.fused_consensus_sgd import fused_consensus_sgd
    from repro_torch.kernels.paged_decode import paged_decode
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_leaves
    from repro_torch.obs import make_obs, telemetry
    from repro_torch.obs.trace import PROFILE_DIR, PROFILE_TRACE
    from repro_torch.train import ScaleTrainer, TrainerConfig

    launches = {}
    # ---- sim: bare twice, then with a trace dir, then profiled --------
    steps = 40
    data, topo, nn, _ = sim_setup()

    def sim(obs=None):
        tr = TTHFTrainer(nn, data, topo, sim_algo(), batch_size=16,
                         use_kernel=True)
        torch.cuda.synchronize()
        t0 = time.time()
        try:
            st, hist = tr.run(steps=steps, seed=0, eval_every=10, obs=obs)
        finally:
            if obs is not None:
                obs.close()
        torch.cuda.synchronize()
        return tr, st, hist, time.time() - t0

    tr_a, st_a, hist_a, wall_a = sim()
    sim_equals_plain("obs bare", hist_a, tr_a, slice_run)
    _, st_b, hist_b, wall_b = sim()
    bitwise = hist_b.global_loss == hist_a.global_loss and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(st_a.params),
                                          tree_leaves(st_b.params)))
    del st_b
    log(f"[obs] sim: two bare runs on the card are "
        f"{'bitwise equal' if bitwise else 'NOT bitwise equal'}; the "
        f"instrumented runs are held "
        f"{'bitwise' if bitwise else 'to the [slice] tolerances'}")

    def hold_sim(tag, tr, st, hist):
        if bitwise:
            assert hist.global_loss == hist_a.global_loss, tag
            for a, b in zip(tree_leaves(st_a.params),
                            tree_leaves(st.params)):
                assert torch.equal(a, b), tag
        else:
            np.testing.assert_allclose(hist.global_loss, hist_a.global_loss,
                                       rtol=1e-4)
        assert [g.tolist() for g in hist.gamma_used] == \
            [g.tolist() for g in hist_a.gamma_used], tag
        assert sim_ledger(tr) == sim_ledger(tr_a), tag

    d = obs_dir("sim")
    consensus_mix.launches = 0
    tr, st, hist, wall = sim(make_obs(str(d), run_name="train-sim"))
    launches["consensus_mix"] = consensus_mix.launches
    assert launches["consensus_mix"] == 32, launches
    hold_sim("obs sim", tr, st, hist)
    rounds = obs_records(d, "round")
    assert [r["step"] for r in rounds] == list(range(5, steps + 1, 5))
    names = obs_trace(d)
    assert names["round"] == len(rounds) and names["run"] == 1
    assert names["consensus_event"] == len(rounds)
    g = tr._obs_gauges
    N = tr.net.num_clusters
    t_prev = 0
    for r in rounds:
        assert set(r) == OBS_ROUND_FIELDS["sim"], set(r)
        assert np.isfinite(r["upsilon"]).all() and len(r["upsilon"]) == N
        # the gauges: Proposition 1 and Lemma 1 of core/theory.py
        eta = tr.algo.constant_lr
        k = g.constants
        sig = telemetry.sigma_t_general(k.beta, lambda j: eta, r["step"],
                                        t_prev)
        assert r["sigma_t"] == sig and r["eps0"] == eta * tr.algo.phi
        assert r["dispersion_bound"] == (12.0 / k.varrho_min) * sig ** 2 * (
            k.sigma ** 2 / k.beta ** 2 + k.delta ** 2 / k.beta ** 2
            + r["eps0"] ** 2)
        assert r["lemma1_bound"] == [
            theory.lemma1_bound(float(tr.net.lambdas[c]),
                                int(r["gamma_used"][c]),
                                tr.net.cluster_size, r["upsilon_pre"][c],
                                tr.model_dim) for c in range(N)]
        if r["step"] % tr.algo.tau == 0:
            t_prev = r["step"]
    evals = obs_records(d, "eval")
    assert len(evals) == 4 and all(np.isfinite(e["grad_norm"])
                                   for e in evals)
    sim_probe_ms = probe_ms(tr._obs_probe, st.params)
    del st
    # the first bare run warms the allocator up after the serve phases:
    # the rate is read in turns, bare, instrumented, bare
    _, st_c, _, wall_c = sim()
    del st_c
    log(f"[obs] sim nn-7840 with a trace dir: {steps / wall:.3f} steps/s, "
        f"bare {steps / wall_b:.3f} before and {steps / wall_c:.3f} after "
        f"({100 * (wall / (0.5 * (wall_b + wall_c)) - 1):+.1f} % wall; "
        f"the first bare run {steps / wall_a:.3f}), "
        f"{len(rounds)} round records, {len(evals)} eval records (grad_norm "
        f"{[round(e['grad_norm'], 6) for e in evals]}), trace.json valid "
        f"with {sum(names.values())} events, gauges equal core/theory.py; "
        f"divergence probe {sim_probe_ms:.3f} ms a round over the "
        f"{tr.model_dim}-parameter fleet of {tr.data.num_devices}; "
        f"consensus_mix launches "
        f"{launches['consensus_mix']}")

    d = obs_dir("sim_profile")
    tr, st, hist, wall_p = sim(make_obs(str(d), profile=True,
                                        run_name="train-sim"))
    hold_sim("obs sim profile", tr, st, hist)
    del st
    prof = d / PROFILE_DIR / PROFILE_TRACE
    size = prof.stat().st_size
    doc = json.loads(prof.read_text())
    kernels = [e for e in doc["traceEvents"]
               if e.get("cat") == "kernel" and "consensus_mix" in
               e.get("name", "")]
    annotated = sum(e.get("name") == "consensus_event"
                    for e in doc["traceEvents"])
    assert len(kernels) == 32, len(kernels)
    assert annotated >= 8, annotated
    log(f"[obs] sim with --profile: {steps / wall_p:.3f} steps/s; "
        f"{PROFILE_DIR}/{PROFILE_TRACE} {size} B with {len(kernels)} CUDA "
        f"kernel events named {kernels[0]['name'][:60]!r} and "
        f"{annotated} consensus_event annotations")
    shutil.rmtree(d / PROFILE_DIR)
    del doc, st_a, tr_a
    torch.cuda.empty_cache()

    # ---- scale: bare 1 interval, instrumented 2 with a checkpoint ------
    cfg = get_arch("qwen1.5-0.5b")
    scale = scale_cli_config()
    tokens = scale.tau * scale.replicas * SCALE_BATCH * 128
    w0 = build_model(cfg).init(
        torch.Generator(device="cuda").manual_seed(0), "cuda")

    def trainer(trace_dir=None):
        tr = ScaleTrainer(cfg, scale, TrainerConfig(
            batch_per_replica=SCALE_BATCH, seq_len=128, intervals=2,
            eval_every=2 if trace_dir else 0, eval_batches=1, seed=0,
            fused_interval=True, trace_dir=trace_dir), device="cuda")
        return tr.init(w0=w0, draws=NumpyDraws(0))

    def timed_run(tr, n):
        torch.cuda.synchronize()
        t0 = time.time()
        tr.run(n)
        torch.cuda.synchronize()
        return time.time() - t0

    def losses(tr):
        return list(tr.metrics._recent["train_loss"])

    tr = trainer()
    timed_run(tr, 1)
    warm = scale_bare["warm"]
    scale_bitwise = losses(tr) == warm["losses"] and torch.equal(
        tr.params[0].cpu(), warm["row0"])
    del tr
    torch.cuda.empty_cache()
    log(f"[obs] scale: two bare 1-interval runs on the card are "
        f"{'bitwise equal' if scale_bitwise else 'NOT bitwise equal'}; the "
        f"instrumented and resumed runs are held "
        f"{'bitwise' if scale_bitwise else 'to loss rtol 1e-4, atol 1e-5'}")

    def hold_scale(tag, got_losses, row0, want_losses, want_row0):
        if scale_bitwise:
            assert got_losses == want_losses, (tag, got_losses, want_losses)
            assert torch.equal(row0, want_row0), tag
        else:
            np.testing.assert_allclose(got_losses, want_losses, rtol=1e-4)
            diff = float((row0 - want_row0).abs().max())
            assert diff <= 1e-5, (tag, diff)

    d = obs_dir("scale")
    ckpt_dir = ROOT / "build" / "obs_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    ckpt_dir.mkdir(parents=True)
    tr = trainer(str(d))
    ckpt_bytes = tr.params[:, :tr._spec.total].numel() * 4
    free = shutil.disk_usage(ckpt_dir).free
    if free < 1.2 * ckpt_bytes:
        raise SystemExit(f"[obs] {free} B free at {ckpt_dir}: too little "
                         f"for the {ckpt_bytes} B checkpoint")
    fused_consensus_sgd.launches = 0
    wall1 = timed_run(tr, 1)
    t0 = time.time()
    path = Path(tr.save(str(ckpt_dir / "interval_1.npz")))
    save_s = time.time() - t0
    wall2 = timed_run(tr, 1)
    tr.close()
    launches["fused_consensus_sgd"] = fused_consensus_sgd.launches
    assert launches["fused_consensus_sgd"] == 8, launches
    assert bool((tr.params == tr.params[0]).all())   # broadcast: one model
    hold_scale("obs scale", losses(tr), tr.params[0].cpu(),
               scale_bare["losses"], scale_bare["row0"])
    led = tr.ledger
    assert (led.uplinks, led.d2d_msgs, led.d2d_rounds, led.local_steps) == \
        scale_bare["ledger"]
    rounds = obs_records(d, "round")
    (ev,) = obs_records(d, "eval")
    assert [r["step"] for r in rounds] == [1, 2]
    assert all(set(r) == OBS_ROUND_FIELDS["scale"] for r in rounds)
    assert np.isfinite(ev["grad_norm"]) and ev["grad_norm"] > 0
    names = obs_trace(d)
    assert names["interval"] == 2 and names["resolve"] == 2
    scale_probe_ms = probe_ms(tr._obs_probe, tr._probe_params(), iters=3)
    del tr
    torch.cuda.empty_cache()
    log(f"[obs] scale qwen1.5-0.5b fused with a trace dir: "
        f"{2 * tokens / (wall1 + wall2):.1f} tokens/s over the 2 intervals "
        f"(bare [scale] {2 * tokens / scale_bare['wall']:.1f}, "
        f"{100 * ((wall1 + wall2) / scale_bare['wall'] - 1):+.1f} % wall; "
        f"the second interval's wall includes the eval and the grad-norm "
        f"probe), "
        f"losses {scale_bare['losses']}, grad_norm {ev['grad_norm']:.6f}, "
        f"divergence probe {scale_probe_ms:.3f} ms a round over the (4, "
        f"{QWEN_P}) buffer; fused_consensus_sgd launches "
        f"{launches['fused_consensus_sgd']}")

    # the checkpoint into a fresh trainer, then interval 2
    size = path.stat().st_size
    tr = trainer()
    t0 = time.time()
    tr.restore(str(path))
    torch.cuda.synchronize()
    restore_s = time.time() - t0
    assert tr.interval == 1 and tr._train_draws == scale.tau
    assert not tr.params[:, tr._spec.total:].any()
    timed_run(tr, 1)
    hold_scale("obs resume", losses(tr), tr.params[0].cpu(),
               scale_bare["losses"][1:], scale_bare["row0"])
    led = tr.ledger
    assert (led.uplinks, led.d2d_msgs, led.d2d_rounds, led.local_steps) == \
        scale_bare["ledger"]
    del tr, w0
    shutil.rmtree(ckpt_dir)
    torch.cuda.empty_cache()
    log(f"[obs] checkpoint at full width: {size} B "
        f"({ckpt_bytes} B of f32 parameters), saved in {save_s:.3f} s, "
        f"restored into a fresh trainer in {restore_s:.3f} s; the resumed "
        f"interval 2 equal to the straight run, same ledger; deleted")

    # ---- serve: the CLI's paged trace, bare then with a trace dir --------
    # (the serve path's rate spreads widely from run to run: the bare
    # run just before is the one to read the instrumented run's against)
    model = build_model(cfg)
    _, _, arrivals, wall_b = serve_cli.run_scheduler_trace(
        serve_cli.parse_args(SERVE_ARGV), cfg, model, torch.device("cuda"))
    assert {r.rid: list(r.out_tokens) for _, r in arrivals} == \
        serve_bare["tokens"]
    d = obs_dir("serve")
    args = serve_cli.parse_args(SERVE_ARGV + ["--trace-dir", str(d)])
    paged_decode.launches = 0
    sched, stats, arrivals, wall = serve_cli.run_scheduler_trace(
        args, cfg, model, torch.device("cuda"))
    launches["paged_decode"] = paged_decode.launches
    assert launches["paged_decode"] == cfg.num_layers * stats.decode_steps
    assert trace_stats(stats, sched) == serve_bare["stats"]
    assert {r.rid: list(r.out_tokens) for _, r in arrivals} == \
        serve_bare["tokens"]
    reqs = obs_records(d, "request")
    assert len(reqs) == SERVE_TRACE["requests"]
    assert all(set(r) == REQUEST_FIELDS for r in reqs)
    assert [(r["rid"], r["submit"], r["admit"], r["first_token"], r["step"],
             r["decode"], r["budget"]) for r in reqs] == \
        serve_bare["stats"]["records"]
    names = obs_trace(d)
    assert names["decode_step"] == stats.decode_steps
    n_tok = stats.tokens_generated
    del sched
    torch.cuda.empty_cache()
    log(f"[obs] serve qwen1.5-0.5b paged with a trace dir: {n_tok / wall:.1f}"
        f" tokens/s (bare just before {n_tok / wall_b:.1f}, "
        f"{100 * (wall / wall_b - 1):+.1f} % wall; bare [serve] "
        f"{n_tok / serve_bare['wall']:.1f}), the "
        f"bare run's tokens and trace stats, {len(reqs)} request records, "
        f"trace.json valid with {sum(names.values())} events; paged_decode "
        f"launches {launches['paged_decode']}")
    return launches


# ---------------------------------------------------------------------------
# the dry run: sizes-only programs on the production mesh, and the same
# step builders executed on the card
# ---------------------------------------------------------------------------

DRYRUN_ARGV = {
    "train": ["--arch", "qwen1.5-0.5b", "--shape", "train_4k", "--mesh",
              "pod", "--out", "-"],
    "paged serve": ["--serve", "--paged", "--arch", "qwen1.5-0.5b",
                    "--mesh", "pod", "--out", "-"],
}
DRYRUN_CUT = (2, 4096)          # train_4k's 4,096 tokens, 2 sequences
DRYRUN_LR = 1e-3
PAIRS_T = 4096
PAIRS_WINDOW = 1024
# the --sync tthf-fused-interval program on one card: depth, tokens,
# microsteps and the block-end period
SYNC_LAYERS, SYNC_T, SYNC_B, SYNC_TAU, SYNC_CE, SYNC_R = 2, 512, 4, 4, 2, 2


# a product whose rows go over ``data`` and columns over ``model`` on the
# pod mesh: the counter must give the rank's share, whatever this torch's
# DTensor dispatch does around it
RANK_SHARE = """
import json, torch
from torch.distributed.tensor import Replicate, Shard
from repro_torch.launch import dryrun
from repro_torch.launch.steps import Program
mesh = dryrun.production_mesh("pod")
fn = Program(lambda x, y: (x @ y).full_tensor(), mesh,
             ((Shard(0), Replicate()), (Replicate(), Shard(1))))
rec, _, _ = dryrun.trace(fn, (torch.empty((64, 896), device="meta"),
                              torch.empty((896, 4864), device="meta")))
print(json.dumps({"flops": rec.flops, "counts": rec.coll_counts}))
"""


def dryrun_start() -> dict:
    """Both sizes-only dry runs as a user runs them, and the rank-share
    check, in subprocesses on the host's CPU (they place nothing on the
    card)."""
    env = {**__import__("os").environ, "PYTHONPATH": str(ROOT / "src")}
    runs = {name: ["-m", "repro_torch.launch.dryrun", *argv]
            for name, argv in DRYRUN_ARGV.items()}
    runs["rank share"] = ["-c", RANK_SHARE]
    return {name: (time.time(), subprocess.Popen(
        [sys.executable, *argv], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env))
        for name, argv in runs.items()}


def dryrun_finish(procs: dict) -> dict:
    """Each dry run's record, held to the contract: status ok on 256
    ranks, a dominant term, FLOPs counted (the train step's within 1 % of
    a rank's share of the model's); the product counted as the
    rank's share (2,179,072 FLOPs, not the global 557,842,432) with two
    all-gathers."""
    recs = {}
    for name, (t0, proc) in procs.items():
        out, err = proc.communicate(timeout=900)
        wall = time.time() - t0
        assert proc.returncode == 0, (name, err[-3000:])
        rec = json.loads(out.strip().splitlines()[-1])
        if name == "rank share":
            assert rec["flops"] == 2 * 4 * 896 * 304, rec
            assert rec["counts"]["all-gather"] == 2, rec
            log(f"[dryrun] (64, 896) @ (896, 4864) on the 256-rank pod "
                f"mesh: {rec['flops']:.0f} FLOPs a rank (the global "
                f"557842432 / 256), {rec['counts']}")
            continue
        assert rec["status"] == "ok" and rec["chips"] == 256, rec
        assert rec["dominant"] in ("compute", "memory", "collective"), rec
        assert rec["flops_dev"] > 0, rec
        if name == "train":
            # every projection tensor parallel: 6 N D over the ranks plus
            # the rectangular flash sweep (7 products of 2 T^2 H hd)
            T, B, L, hd = 4096, 256, 24, 16 * 64
            want = rec["model_flops"] + 7 * 2 * T * T * hd * L * B / 256
            assert 0.99 < rec["flops_dev"] / want < 1.01, (rec, want)
            log(f"[dryrun] train flops/rank {rec['flops_dev']:.4e} = "
                f"{rec['flops_dev'] / want:.5f} x (6 N D + flash) / 256")
        log(f"[dryrun] {name} (sizes only, 256 fake ranks, {wall:.1f} s "
            f"wall): flops/rank {rec['flops_dev']:.4e}, bytes/rank "
            f"{rec['bytes_dev']:.4e}, collective bytes/rank "
            f"{rec['coll_bytes_dev']:.4e}; terms compute "
            f"{rec['compute_s'] * 1e3:.3f} ms, memory "
            f"{rec['memory_s'] * 1e3:.3f} ms, collective "
            f"{rec['collective_s'] * 1e3:.3f} ms -> {rec['dominant']}")
        recs[name] = rec
    return recs


def params_close(a: dict, b: dict) -> float:
    import torch
    from repro_torch.models.common import tree_leaves
    with torch.no_grad():
        return max(float((x - y).abs().max())
                   for x, y in zip(tree_leaves(a), tree_leaves(b)))


def adamw_close(p_a, p_b, s_a, s_b, ratio: int) -> tuple:
    """One AdamW step at accumulation A and lr / ratio against one at
    accumulation A * ratio and lr: the moments of the summed gradients
    are ``ratio`` (m) and ``ratio ** 2`` (v) times the others, to 1e-5
    of their largest; the params to 1e-5 where the step is well
    conditioned. AdamW's step g / (|g| + eps) turns a gradient's last-ulp
    difference into up to 2 lr where |g| is near eps (the key bias's
    gradient is 0 in exact arithmetic: softmax ignores a shift of every
    score), so those params (|g| <= 1e-6) are held to 2 lr. Returns the
    largest of the scaled differences and what it covered."""
    import torch
    from repro_torch.dist.sharding import local
    from repro_torch.models.common import tree_leaves
    worst, odd, n = 0.0, 0, 0
    with torch.no_grad():
        for name, k in (("m", ratio), ("v", ratio ** 2)):
            for a, b in zip(tree_leaves(s_a[name]), tree_leaves(s_b[name])):
                a, b = local(a), local(b)
                top = float(b.abs().max()) or 1.0
                worst = max(worst, float((k * a - b).abs().max()) / top)
        for pa, pb, v in zip(tree_leaves(p_a), tree_leaves(p_b),
                             tree_leaves(s_b["v"])):
            good = (local(v) / (1 - 0.999)).sqrt() > 1e-6
            d = (pa - pb).abs()
            worst = max(worst, float(d[good].max()) if good.any() else 0.0)
            assert float(d.max()) <= 2 * DRYRUN_LR, float(d.max())
            odd += int((~good).sum())
            n += good.numel()
    return worst, (f"moments and params ({n - odd} of {n}; {odd} with "
                   f"|g| <= 1e-6 within 2 lr)")


def phase_dryrun() -> int:
    """(a) ``python -m repro_torch.launch.dryrun`` for qwen1.5-0.5b's
    train_4k step and its paged serving pair on the 256-rank pod mesh
    (fake process group, sizes only), started first and read last; (b)
    ``build_program``'s train step on a (1, 1) NCCL mesh at qwen's full
    width, train_4k cut to 2 sequences: 3 SGD steps and 1 AdamW step at
    ``accum_steps_for``'s accumulation and at 2, held together (loss
    rtol 1e-5, params 1e-5), the SGD program to a hand-written
    backward + update (1e-6), and the dry run's count of the program on
    this mesh to the executed step's (FLOPs equal); (c)
    ``flash_attention_pairs`` against ``flash_attention`` at 4,096
    tokens with qwen's heads, causal and sliding."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import InputShape, get_arch
    from repro_torch.dist.sharding import local
    from repro_torch.launch import dryrun
    from repro_torch.launch.analysis import HBM_BW, PEAK_FLOPS
    from repro_torch.launch.cost import measure
    from repro_torch.launch.steps import accum_steps_for, build_program
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_leaves
    from repro_torch.optim import make_optimizer

    procs = dryrun_start()
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        cfg = get_arch("qwen1.5-0.5b")
        model = build_model(cfg)
        B, T = DRYRUN_CUT
        shape = InputShape("train_4k", T, B, "train")
        acc = accum_steps_for(cfg, shape, mesh)
        rng = np.random.default_rng(0)
        batches = [{k: torch.from_numpy(rng.integers(
            0, cfg.vocab_size, size=(B, T)).astype(np.int32)).cuda()
            for k in ("tokens", "labels")} for _ in range(3)]
        idx = torch.zeros((), dtype=torch.int32, device="cuda")

        def run(optimizer, accum, steps, lr=DRYRUN_LR):
            params = model.init(torch.Generator(device="cuda").manual_seed(0),
                                "cuda")
            fn, _ = build_program(model, shape, mesh, optimizer=optimizer,
                                  dtype=torch.float32, lr=lr,
                                  accum_steps=accum)
            state = make_optimizer(optimizer).init(params)
            losses, times = [], []
            for b in batches[:steps]:
                torch.cuda.synchronize()
                t = time.time()
                _, state, loss = fn(params, state, b, idx)
                losses.append(float(local(loss)))
                torch.cuda.synchronize()
                times.append(time.time() - t)
            return params, losses, times, state

        for optimizer, steps in (("sgd", 3), ("adamw", 1)):
            # the summed microbatch gradients take 1 / accum in the
            # learning rate (the reference's fold, exact for SGD): AdamW,
            # blind to the gradient's scale, then steps lr / accum, so
            # accumulation 2 is held to lr / 2 at accumulation 1
            scale = 1 if optimizer == "sgd" else 2 // acc
            p_a, l_a, t_a, s_a = run(optimizer, acc, steps,
                                     DRYRUN_LR / scale)
            p_b, l_b, _, s_b = run(optimizer, 2, steps)
            dl = max(abs(x - y) / abs(y) for x, y in zip(l_a, l_b))
            if optimizer == "sgd":
                dp, what = params_close(p_a, p_b), "params"
            else:
                dp, what = adamw_close(p_a, p_b, s_a, s_b, 2 // acc)
            assert dl <= 1e-5 and dp <= 1e-5, (optimizer, dl, dp)
            log(f"[dryrun] {optimizer}: {steps} steps of build_program's "
                f"step at accumulation {acc} and 2 on a (1, 1) mesh "
                f"({B} x {T} tokens, f32): losses {l_a}, max rel diff "
                f"{dl:.2e}, {what} max |diff| {dp:.2e}; step "
                f"{min(t_a):.3f} s")
            if optimizer == "sgd":
                sgd_params, step_s = p_a, min(t_a)
            del p_a, p_b, s_a, s_b
        # the SGD program against a hand-written backward + update
        hand = model.init(torch.Generator(device="cuda").manual_seed(0),
                          "cuda")
        for v in tree_leaves(hand):
            v.requires_grad_(True)
        for b in batches:
            model.loss(hand, b, dtype=torch.float32).backward()
            with torch.no_grad():
                for v in tree_leaves(hand):
                    v -= DRYRUN_LR * v.grad
                    v.grad = None
        dh = params_close(sgd_params, hand)
        assert dh <= 1e-6, dh
        log(f"[dryrun] sgd program against loss.backward() + w -= lr g, 3 "
            f"steps: params max |diff| {dh:.2e} (tol 1e-6)")
        del hand
        # the dry run's count of this program against the executed step's
        fn, args = build_program(model, shape, mesh, dtype=torch.float32,
                                 lr=DRYRUN_LR, accum_steps=acc)
        dry, _, t_trace = dryrun.trace(fn, args)
        _, ran = measure(fn, sgd_params, (), batches[0], idx)
        assert dry.flops == ran.flops > 0, (dry.flops, ran.flops)
        log(f"[dryrun] (1, 1) mesh: the dry run's flops/rank "
            f"{dry.flops:.6e} (traced in {t_trace:.1f} s) = the executed "
            f"step's {ran.flops:.6e}; bytes {dry.bytes:.4e} (dry) "
            f"{ran.bytes:.4e} (executed)")
        log(f"[dryrun] {card_line()}: measured sgd step {step_s:.3f} s "
            f"(f32, TF32 off) against roofline terms compute "
            f"{dry.flops / PEAK_FLOPS:.4f} s (bf16 peak), "
            f"{dry.flops / F32_FLOPS_PER_S:.4f} s (f32 peak), memory "
            f"{dry.bytes / HBM_BW:.4f} s")
        del sgd_params
        torch.cuda.empty_cache()
        launches = sync_interval_check(mesh)
    finally:
        dist.destroy_process_group()
    pairs_check()
    dryrun_finish(procs)
    return launches


def sync_interval_check(mesh) -> int:
    """The dry run's ``--sync tthf-fused-interval`` program
    (``build_tthf_program``) executed on the (1, 1) mesh at 2 of qwen's
    24 layers (full width): 2 replicas in one cluster, a block end
    every 2 of 4 microsteps through ``fused_consensus_sgd``. Its launches are counted
    (reset just before); the same interval through the unsharded
    ``make_tthf_train_step`` holds it (1e-6). Returns the launches."""
    import torch
    from repro_torch.configs import InputShape, get_arch
    from repro_torch.core.distributed import (
        FlatParamSpec, TTHFScaleConfig, make_tthf_train_step,
        stack_replicas)
    from repro_torch.dist.sharding import local
    from repro_torch.kernels.fused_consensus_sgd import fused_consensus_sgd
    from repro_torch.launch import dryrun
    from repro_torch.models import build_model

    model = build_model(dataclasses.replace(get_arch("qwen1.5-0.5b"),
                                            num_layers=SYNC_LAYERS))
    fn, args = dryrun.build_tthf_program(
        model, InputShape("train_4k", SYNC_T, SYNC_B, "train"), mesh,
        "tthf", "fused", tau=SYNC_TAU, consensus_every=SYNC_CE,
        fused_interval=True, replicas=SYNC_R)
    R = args[0].shape[0]
    flat = FlatParamSpec.for_model(model).flatten(stack_replicas(
        model.init(torch.Generator(device="cuda").manual_seed(0), "cuda"),
        R))
    tb = torch.from_numpy(np.random.default_rng(2).integers(
        0, 32_000, size=tuple(args[1]["tokens"].shape)).astype(
            np.int32)).cuda()
    batch = {"tokens": tb, "labels": tb.roll(1, dims=-1)}
    picks = torch.zeros(tuple(args[2].shape), dtype=torch.int32,
                        device="cuda")
    fused_consensus_sgd.launches = 0
    got, loss = fn(flat.clone(), batch, picks, picks[0])
    torch.cuda.synchronize()
    launches = fused_consensus_sgd.launches
    assert launches == SYNC_TAU // SYNC_CE, launches
    step, _ = make_tthf_train_step(
        model, TTHFScaleConfig(replicas=R, cluster_size=R, tau=SYNC_TAU,
                               consensus_every=SYNC_CE, gamma_d2d=2,
                               consensus_mode="fused", lr=1e-2,
                               graph="ring"),
        dtype=torch.bfloat16, fused_interval=True, device="cuda")
    want, wloss = step(flat.clone(), batch, picks)
    err = float((local(got) - want).abs().max())
    dl = abs(float(local(loss)) - float(wloss))
    assert err <= 1e-6 and dl <= 1e-6 * abs(float(wloss)), (err, dl)
    log(f"[dryrun] --sync tthf-fused-interval program on the (1, 1) mesh "
        f"({SYNC_LAYERS} of qwen's layers, {R} replicas, tau {SYNC_TAU}, a "
        f"block end every {SYNC_CE}, {SYNC_B} x {SYNC_T} tokens): "
        f"fused_consensus_sgd launches {launches}; against the unsharded "
        f"interval: params max |diff| {err:.2e}, loss {float(wloss):.6f}")
    return launches


def pairs_check() -> None:
    """``flash_attention_pairs`` against ``flash_attention`` on one
    4,096-token sequence with qwen's heads: outputs within 2e-5 of max
    |out|, gradients within 5e-5 relative L2."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import attention as attn

    cfg = get_arch("qwen1.5-0.5b")
    K, G, hd = cfg.num_kv_heads, cfg.q_per_kv, cfg.head_dim
    gen = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn((1, PAIRS_T, K, G, hd), generator=gen, device="cuda")
    k = torch.randn((1, PAIRS_T, K, hd), generator=gen, device="cuda")
    v = torch.randn((1, PAIRS_T, K, hd), generator=gen, device="cuda")
    dout = torch.randn((1, PAIRS_T, K, G, hd), generator=gen, device="cuda")
    qc = 512
    for mode, window in (("causal", 0), ("sliding", PAIRS_WINDOW)):
        def grads(fa, **kw):
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            out = fa(*leaves, mode=mode, window=window, **kw)
            out.backward(dout)
            return out.detach(), [t.grad for t in leaves]

        out_p, g_p = grads(attn.flash_attention_pairs, q_chunk=qc,
                           k_chunk=qc)
        out_f, g_f = grads(attn.flash_attention, q_chunk=qc, k_chunk=1024)
        err = float((out_p - out_f).abs().max() / out_f.abs().max())
        gerr = max(float((a - b).norm() / b.norm())
                   for a, b in zip(g_p, g_f))
        assert err <= 2e-5 and gerr <= 5e-5, (mode, err, gerr)
        n = PAIRS_T // qc
        pairs = len(attn._block_pairs(n, n, qc, qc, mode, window, None, 0))
        ms_p = cuda_ms(lambda: grads(attn.flash_attention_pairs,
                                     q_chunk=qc, k_chunk=qc), 3)
        ms_f = cuda_ms(lambda: grads(attn.flash_attention, q_chunk=qc,
                                     k_chunk=1024), 3)
        log(f"[dryrun] flash_attention_pairs ({mode}, {PAIRS_T} tokens, K "
            f"{K}, G {G}, hd {hd}): out max |diff| {err:.2e} of max |out|,"
            f" grads {gerr:.2e} rel L2; {pairs} of {n * n} ({qc} x {qc}) "
            f"blocks (flash_attention's sweep: {n * (PAIRS_T // 1024)} of "
            f"{qc} x 1024); forward + backward {ms_p:.2f} ms against "
            f"{ms_f:.2f} ms")


def profile_main_path(fn, label: str) -> None:
    """Device time by kernel and the device's busy share over one run
    of a main path (torch.profiler, CUDA activity only: recording every
    host operator of a scale interval, some 10^6 events, takes minutes
    to process); ``fn`` runs it and returns its wall time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wall = fn()
    # device-side entries only (kernels, copies), not the runtime calls
    # that launched them
    events = [e for e in prof.key_averages()
              if str(getattr(e, "device_type", "")).endswith("CUDA")]

    def device_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    busy_us = sum(device_us(e) for e in events)
    log(f"[profile] {label}: wall {wall:.3f} s, device busy "
        f"{busy_us / 1e6:.3f} s, idle share {1 - busy_us / 1e6 / wall:.3f}")
    for kind in ("HtoD", "DtoH"):
        copies = [e for e in events if f"Memcpy {kind}" in e.key]
        log(f"[profile] copies {kind}: {sum(e.count for e in copies)}, "
            f"{sum(device_us(e) for e in copies) / 1e3:.3f} ms")
    for e in sorted(events, key=device_us, reverse=True)[:15]:
        if device_us(e) > 0:
            log(f"[profile] {device_us(e) / 1e3:10.3f} ms {e.count:6d}x "
                f"{e.key[:90]}")


def phases_arg(argv) -> "list | None":
    """``--phases a,b``: run only those phases (``PARTIAL_PHASES``)."""
    for i, a in enumerate(argv):
        if a == "--phases":
            names = argv[i + 1].split(",")
            bad = sorted(set(names) - set(PARTIAL_PHASES))
            if bad:
                raise SystemExit(f"unknown phases {bad}; choose from "
                                 f"{sorted(PARTIAL_PHASES)}")
            return names
    return None


# the phases ``--phases`` can run alone
PARTIAL_PHASES = {
    "kernels": lambda: (phase_kernels(), phase_fused_kernels()),
    "paged-kernel": phase_paged_kernel,
    "slice-fog": phase_slice_fog,
    "slice-control": phase_slice_control,
    "scale-forms": phase_scale_forms,
    "scale-ssm": phase_scale_ssm,
    "scale-hybrid": phase_scale_hybrid,
    "scale-moe": phase_scale_moe,
    "serve-hybrid": phase_serve_hybrid,
    "serve-moe": phase_serve_moe,
    "flash": phase_flash,
    "vlm": phase_vlm,
    "audio": phase_audio,
    "obs": phase_obs,
    "serve-mesh": phase_serve_mesh,
    "dryrun": phase_dryrun,
}


def main() -> int:
    import torch
    import repro_torch  # noqa: F401  (fails without the repository)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(card_line())
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    profile = "--profile" in sys.argv[1:]
    t0 = time.time()

    def timed(name, fn, *args, **kw):
        t = time.time()
        out = fn(*args, **kw)
        log(f"[time] phase {name}: {time.time() - t:.1f} s "
            f"(script at {time.time() - t0:.1f} s)")
        return out

    timed("build", phase_build)
    only = phases_arg(sys.argv[1:])
    if only is not None:
        # a quick check of some phases: no kernels line and no result;
        # the sim phases are held to phase 3's run
        slice_run = None
        for name in only:
            args = ()
            if name.startswith("slice-") or name == "obs":
                slice_run = slice_run or timed("slice", phase_slice)
                args = (slice_run,)
            if name == "obs":       # held to the bare scale and serve runs
                args += (timed("scale", phase_scale)[1],
                         timed("serve", phase_serve)[1])
            fn = PARTIAL_PHASES[name]
            kw = ({"profile": True} if profile and "profile" in
                  inspect.signature(fn).parameters else {})
            timed(name, fn, *args, **kw)
        log(f"[partial] phases {only} passed; no result line")
        return 0
    numbers = {"consensus_mix": timed("kernels", phase_kernels),
               **timed("fused kernels", phase_fused_kernels)}
    numbers["paged_decode"] = timed("paged kernel", phase_paged_kernel)
    numbers["ssd_scan"] = timed("ssd kernel", phase_ssd_kernel)
    # each path's launches, its counters reset just before it
    slice_run = timed("slice", phase_slice, profile=profile)
    by_path = {"consensus_mix": {
        "slice": slice_run["launches"],
        "slice-netsim": timed("slice-netsim", phase_slice_netsim, slice_run,
                              profile=profile),
        "slice-fog": timed("slice-fog", phase_slice_fog, slice_run),
        "slice-control": timed("slice-control", phase_slice_control,
                               slice_run)}}
    scale_launches, scale_bare = timed("scale", phase_scale, profile=profile)
    by_path["fused_sgd"] = {"scale": scale_launches["fused_sgd"]}
    by_path["fused_consensus_sgd"] = {
        "scale": scale_launches["fused_consensus_sgd"],
        "scale-ssm": timed("scale-ssm", phase_scale_ssm, profile=profile),
        "scale-forms": timed("scale-forms", phase_scale_forms,
                             warm_up=False),
        "scale-hybrid": timed("scale-hybrid", phase_scale_hybrid),
        "scale-moe": timed("scale-moe", phase_scale_moe, profile=profile)}
    serve_launches, serve_bare = timed("serve", phase_serve, profile=profile)
    by_path["paged_decode"] = {
        "serve": serve_launches,
        "serve-hybrid": timed("serve-hybrid", phase_serve_hybrid,
                              profile=profile)}
    timed("flash", phase_flash)
    by_path["paged_decode"]["serve-moe"] = timed("serve-moe",
                                                 phase_serve_moe,
                                                 profile=profile)
    by_path["ssd_scan"] = {"serve-ssm": timed("serve-ssm", phase_serve_ssm,
                                              profile=profile)}
    timed("forward-ssm", phase_forward_ssm)
    # sharded serving through a (1, 1) mesh: paged_decode and ssd_scan
    # launched by the rank on its shard
    for name, n in timed("serve-mesh", phase_serve_mesh,
                         profile=profile).items():
        by_path[name]["serve-mesh"] = n
    # the dry run's programs: sizes only on the pod mesh, and executed
    # on the card (its --sync tthf-fused-interval program through
    # fused_consensus_sgd)
    by_path["fused_consensus_sgd"]["dryrun"] = timed("dryrun", phase_dryrun)
    # the vlm and audio kinds in direct serving (no kernel on their path)
    timed("vlm", phase_vlm, profile=profile)
    timed("audio", phase_audio, profile=profile)
    # the instrumented paths (spans, metrics stream, probes, profiler,
    # checkpoint), each held to its bare run above
    for name, n in timed("obs", phase_obs, slice_run, scale_bare,
                         serve_bare).items():
        by_path[name]["obs"] = n
    replaces = {"consensus_mix": "src/repro/kernels/consensus_mix.py:44",
                "fused_consensus_sgd":
                    "src/repro/kernels/fused_consensus_sgd.py:52",
                "fused_sgd": "src/repro/kernels/fused_sgd.py:37",
                "paged_decode": "src/repro/kernels/paged_attn.py:76",
                "ssd_scan": "src/repro/kernels/ssd_scan.py:75"}
    # fused_sgd's streaming kernel shares fused_consensus_sgd.cu (and its
    # SGD step) with fused_consensus_sgd
    sources = {"consensus_mix": "src/repro_torch/csrc/consensus_mix.cu",
               "fused_consensus_sgd":
                   "src/repro_torch/csrc/fused_consensus_sgd.cu",
               "fused_sgd": "src/repro_torch/csrc/fused_consensus_sgd.cu",
               "paged_decode": "src/repro_torch/csrc/paged_decode.cu",
               "ssd_scan": "src/repro_torch/csrc/ssd_scan.cu"}
    kernels = []
    for name, nums in numbers.items():
        entry = {
            "name": name, "route": "cuda", "source": sources[name],
            "replaces": replaces[name],
            "launches": sum(by_path[name].values()),
            "launches_by_path": by_path[name],
            "on_main_path": name != "fused_sgd",
            "max_abs_err": nums["max_abs_err"], "ms": nums["ms"],
            "plain_ms": nums["plain_ms"], "bound_ms": nums["bound_ms"],
            "bound_by": nums["bound_by"], "library_ms": nums["library_ms"],
            "max_abs_err_all_shapes": nums["max_abs_err_all_shapes"]}
        entry.update({key: value for key, value in nums.items()
                      if key.startswith("at_")})
        kernels.append(entry)
    log(card_line())
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
