"""Training entry point of the port, with the flags of
``repro/launch/train.py`` plus ``--device``. Two modes:

* ``--mode sim``   — the paper's Algorithm 1 on the federated image task.
                     D2D mixing always goes through the ``consensus_mix``
                     wrapper: on the CUDA device it launches the kernel,
                     and on the CPU it runs the kernel's plain version.
* ``--mode scale`` — TT-HF as the sync strategy for a dense, moe, ssm
                     or hybrid model-zoo arch (``--arch``) through
                     ``ScaleTrainer``,
                     on one device, with the reference's per-leaf
                     interval step.

In both modes ``--scenario`` (netsim weather), ``--hierarchy`` (a fog
preset) and ``--control`` (a control policy) declare the round program
(:func:`build_program`), as in the reference; control with a hierarchy,
and control of a star baseline or star/local sync, raise ``ValueError``
as the reference's assertions do. ``--trace-dir D`` writes the run's
Chrome trace (``D/trace.json``), its metrics stream (``D/metrics.jsonl``:
the ``round``, ``comm`` and ``eval`` records) and ``D/manifest.json``;
``--profile`` adds a ``torch.profiler`` trace of host and CUDA activity
in ``D/torch_profile/trace.json``.

Examples:
  python -m repro_torch.launch.train --mode sim --model nn --hidden 7840 \
      --steps 40                                  # on the CUDA device
  python -m repro_torch.launch.train --mode sim --model svm \
      --devices 25 --clusters 5 --points 2500 --steps 20 --device cpu
  python -m repro_torch.launch.train --mode sim --model svm \
      --devices 20 --clusters 4 --points 800 --steps 20 --tau 10 \
      --scenario stragglers --device cpu
  python -m repro_torch.launch.train --mode sim --model svm \
      --devices 24 --clusters 8 --points 800 --steps 20 --tau 5 \
      --consensus-every 5 --hierarchy fog4 --scenario device_churn \
      --device cpu
  python -m repro_torch.launch.train --mode sim --model svm \
      --devices 20 --clusters 4 --points 800 --steps 20 --tau 10 \
      --control connectivity --device cpu
  python -m repro_torch.launch.train --mode scale --arch qwen1.5-0.5b \
      --reduced --replicas 8 --tau 2 --consensus-every 2 --steps 4 \
      --hierarchy fog3 --scenario device_churn --device cpu
  python -m repro_torch.launch.train --mode scale --arch qwen1.5-0.5b \
      --steps 2                                   # full size, on the card
  python -m repro_torch.launch.train --mode scale --arch mamba2-370m \
      --steps 2
  python -m repro_torch.launch.train --mode scale \
      --arch recurrentgemma-9b --reduced --steps 2 --tau 2 --batch 2 \
      --seq 16 --device cpu
  python -m repro_torch.launch.train --mode scale \
      --arch llama4-maverick-400b-a17b --reduced --steps 2 --tau 2 \
      --batch 2 --seq 16 --device cpu
  python -m repro_torch.launch.train --mode sim --model svm \
      --devices 20 --clusters 4 --points 800 --steps 20 --tau 10 \
      --trace-dir runs/sim --profile --device cpu

``--mode scale`` runs the dense, ssm, hybrid and moe (``--arch
llama4-scout-17b-a16e``, ``llama4-maverick-400b-a17b``; the loss adds
the routers' load-balance and z-losses) kinds. Not ported yet, and
refused with the ROADMAP.md item that brings it: ``--arch`` of the vlm
or audio kind (Queue 1 item 6c).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np


def build_program(args, tau: int):
    """The declarative round program: optional netsim dynamics, an
    optional fog hierarchy and an optional control policy, which both
    trainers resolve."""
    from repro_torch.rounds import RoundProgram

    dynamics = hierarchy = control = None
    if args.scenario:
        from repro_torch.netsim import scenarios
        dynamics = scenarios.get(args.scenario, seed=args.seed)
    if args.hierarchy:
        from repro_torch.hierarchy import presets
        hierarchy = presets.get(args.hierarchy, tau=tau)
    if getattr(args, "control", None) and args.control != "static":
        from repro_torch.control import get_policy
        control = get_policy(args.control)
    return RoundProgram(dynamics=dynamics, hierarchy=hierarchy,
                        control=control)


def run_sim(args):
    from repro_torch.configs import TopologyConfig, TTHFConfig
    from repro_torch.core import TTHFTrainer, make_baseline_config
    from repro_torch.data import fashion_synth, partition_noniid_labels
    from repro_torch.models import make_sim_model
    from repro_torch.obs.sink import make_obs

    x, y = fashion_synth(num_points=args.points, seed=args.seed)
    data = partition_noniid_labels(x, y, num_devices=args.devices,
                                   labels_per_device=3, seed=args.seed)
    topo = TopologyConfig(num_devices=args.devices,
                          num_clusters=args.clusters,
                          graph="geometric", seed=args.seed)
    model = make_sim_model(args.model, data.feature_dim, data.num_classes,
                           hidden=args.hidden)
    if args.baseline:
        algo = make_baseline_config(args.baseline, args.tau)
        algo = dataclasses.replace(algo, constant_lr=args.lr)
    else:
        algo = TTHFConfig(tau=args.tau, consensus_every=args.consensus_every,
                          gamma_d2d=args.gamma, constant_lr=args.lr,
                          phi=args.phi)
    tr = TTHFTrainer(model, data, topo, algo, batch_size=args.batch,
                     use_kernel=True, program=build_program(args, algo.tau),
                     device=args.device)
    # --trace-dir turns on spans + theory-bound telemetry + manifest;
    # --profile adds the torch.profiler trace
    obs = make_obs(args.trace_dir, profile=args.profile,
                   run_name="train-sim",
                   config={"args": vars(args), "algo": algo, "topo": topo},
                   extra={"mode": "sim", "model": args.model})
    t0 = time.time()
    try:
        st, hist = tr.run(steps=args.steps, seed=args.seed,
                          eval_every=args.eval_every, obs=obs)
    finally:
        obs.close()
    dt = time.time() - t0
    by_level = "".join(f" L{l}={n}" for l, n in
                       sorted(tr.ledger.uplinks_by_level.items()))
    print(f"steps={args.steps} wall={dt:.1f}s "
          f"final_loss={hist.global_loss[-1]:.4f} "
          f"final_acc={hist.global_acc[-1]:.4f} "
          f"uplinks={tr.ledger.uplinks}{by_level} "
          f"d2d_msgs={tr.ledger.d2d_msgs}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({k: np.asarray(v).tolist()
                       for k, v in hist.as_arrays().items()}, f)
    return 0


def run_scale(args):
    from repro_torch.configs import get_arch
    from repro_torch.core.distributed import TTHFScaleConfig
    from repro_torch.train import ScaleTrainer, TrainerConfig

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    # consensus_every must divide tau (static event calendar): snap to
    # the nearest divisor <= requested
    ce = max(1, min(args.consensus_every, args.tau))
    while args.tau % ce:
        ce -= 1
    scale = TTHFScaleConfig(replicas=args.replicas,
                            cluster_size=args.cluster_size, tau=args.tau,
                            consensus_every=ce, gamma_d2d=args.gamma,
                            lr=args.lr, consensus_mode=args.consensus_mode)
    tr = ScaleTrainer(
        cfg, scale,
        TrainerConfig(batch_per_replica=args.batch, seq_len=args.seq,
                      intervals=args.steps, eval_every=0, seed=args.seed,
                      trace_dir=args.trace_dir, profile=args.profile),
        sync=args.sync, program=build_program(args, args.tau),
        device=args.device)
    t0 = time.time()
    try:
        tr.init().run()
    finally:
        tr.close()
    by_level = "".join(f" L{l}={n}" for l, n in
                       sorted(tr.ledger.uplinks_by_level.items()))
    print(f"intervals={tr.interval} wall={time.time() - t0:.1f}s "
          f"uplinks={tr.ledger.uplinks}{by_level} "
          f"d2d_msgs={tr.ledger.d2d_msgs} (tau={scale.tau} local steps "
          f"per interval, sync={args.sync})")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["sim", "scale"], default="sim")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--tau", type=int, default=20)
    ap.add_argument("--gamma", type=int, default=2)
    ap.add_argument("--consensus-every", type=int, default=5)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--out", default=None)
    ap.add_argument("--trace-dir", default=None,
                    help="observability dir: Chrome trace, metrics.jsonl "
                         "telemetry, run manifest")
    ap.add_argument("--profile", action="store_true",
                    help="also run torch.profiler over the run (written "
                         "under <trace-dir>/torch_profile)")
    ap.add_argument("--scenario", default=None)
    ap.add_argument("--control", default="static",
                    choices=["static", "remark1", "connectivity"])
    ap.add_argument("--hierarchy", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; the run "
                         "fails without one unless 'cpu' is given)")
    # sim
    ap.add_argument("--model", choices=["svm", "nn"], default="svm")
    ap.add_argument("--devices", type=int, default=125)
    ap.add_argument("--clusters", type=int, default=25)
    ap.add_argument("--points", type=int, default=12_500)
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--phi", type=float, default=1.0)
    ap.add_argument("--eval-every", type=int, default=10)
    ap.add_argument("--baseline", choices=["centralized", "fedavg"],
                    default=None)
    # scale
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--replicas", type=int, default=4)
    ap.add_argument("--cluster-size", type=int, default=2)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--sync", choices=["tthf", "star", "local"],
                    default="tthf")
    ap.add_argument("--consensus-mode", choices=["fused", "rounds"],
                    default="fused")
    args = ap.parse_args(argv)
    return run_sim(args) if args.mode == "sim" else run_scale(args)


if __name__ == "__main__":
    import sys
    sys.exit(main())
