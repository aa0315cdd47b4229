"""Training entry point of the port — ``--mode sim``, the paper's Algorithm 1
on the federated image task, with the flags of ``repro/launch/train.py``
plus ``--device``. D2D mixing always goes through the ``consensus_mix``
wrapper: on the CUDA device it launches the kernel, and on the CPU it
runs the kernel's plain version.

Examples:
  python -m repro_torch.launch.train --mode sim --model nn --hidden 7840 \
      --steps 40                                  # on the CUDA device
  python -m repro_torch.launch.train --mode sim --model svm \
      --devices 25 --clusters 5 --points 2500 --steps 20 --device cpu

Not ported yet, and refused with the ROADMAP.md item that brings them:
``--mode scale`` (Queue 1 item 6); ``--scenario``, ``--hierarchy`` and
``--control`` other than static (item 4); ``--trace-dir`` and
``--profile`` (item 5).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np


def _refuse_unported(args) -> None:
    if args.scenario or args.hierarchy or args.control != "static":
        raise NotImplementedError(
            "--scenario/--hierarchy/--control are not ported yet "
            "(ROADMAP.md Queue 1 item 4)")
    if args.trace_dir or args.profile:
        raise NotImplementedError(
            "--trace-dir/--profile are not ported yet "
            "(ROADMAP.md Queue 1 item 5)")


def run_sim(args):
    from repro_torch.configs import TopologyConfig, TTHFConfig
    from repro_torch.core import TTHFTrainer, make_baseline_config
    from repro_torch.data import fashion_synth, partition_noniid_labels
    from repro_torch.models import make_sim_model

    _refuse_unported(args)
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
                     use_kernel=True, device=args.device)
    t0 = time.time()
    st, hist = tr.run(steps=args.steps, seed=args.seed,
                      eval_every=args.eval_every)
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
    ap.add_argument("--trace-dir", default=None)
    ap.add_argument("--profile", action="store_true")
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
    args = ap.parse_args(argv)
    if args.mode == "scale":
        raise NotImplementedError(
            "--mode scale is not ported yet (ROADMAP.md Queue 1 item 6)")
    return run_sim(args)


if __name__ == "__main__":
    import sys
    sys.exit(main())
