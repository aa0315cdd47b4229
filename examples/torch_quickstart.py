"""Quickstart on the PyTorch port: TT-HF (Algorithm 1) on the federated
image-classification task of the paper, next to its two FL baselines.
The twin of ``examples/quickstart.py``; it runs on the CUDA device unless
``--device cpu`` is given.

Run:  PYTHONPATH=src python examples/torch_quickstart.py
      PYTHONPATH=src python examples/torch_quickstart.py --device cpu \
          --steps 20 --points 2000
"""
import argparse
import dataclasses
import sys

from repro_torch.configs import TopologyConfig, TTHFConfig
from repro_torch.core import TTHFTrainer, make_baseline_config
from repro_torch.data import fashion_synth, partition_noniid_labels
from repro_torch.models import make_sim_model


def main(argv=None, *, init=None):
    """Prints the method x loss/acc/uplinks/d2d table and returns its
    rows. ``init(trainer, seed) -> TTHFState`` replaces each trainer's
    own ``init`` (starting weights and draw source)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--devices", type=int, default=25)
    ap.add_argument("--clusters", type=int, default=5)
    ap.add_argument("--points", type=int, default=6_000)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    # 1. A federated world: 25 devices in 5 D2D clusters, non-iid shards
    #    (3 labels per device), geometric graphs tuned to rho ~ 0.7.
    x, y = fashion_synth(num_points=args.points, seed=0)
    data = partition_noniid_labels(x, y, num_devices=args.devices,
                                   labels_per_device=3)
    topo = TopologyConfig(num_devices=args.devices,
                          num_clusters=args.clusters, graph="geometric",
                          target_spectral_radius=0.7, seed=0)
    model = make_sim_model("svm", data.feature_dim, data.num_classes)

    # 2. TT-HF: tau=20 local SGD steps per global aggregation, D2D
    #    consensus every 5 steps with Gamma=2 rounds, cluster-sampled
    #    uplinks.
    steps, lr = args.steps, 0.002
    tthf = TTHFConfig(tau=20, consensus_every=5, gamma_d2d=2, constant_lr=lr)

    print(f"{'method':16s} {'loss':>8s} {'acc':>7s} {'uplinks':>8s} "
          f"{'d2d':>7s}")
    rows = []
    for name, algo in [
        ("tthf", tthf),
        ("fl_tau20", dataclasses.replace(make_baseline_config("fedavg", 20),
                                         constant_lr=lr)),
        ("fl_tau1", dataclasses.replace(
            make_baseline_config("centralized", 1), constant_lr=lr)),
    ]:
        tr = TTHFTrainer(model, data, topo, algo, batch_size=16,
                         use_kernel=True, device=args.device)
        st = init(tr, 0) if init is not None else None
        _, hist = tr.run(steps=steps, eval_every=steps, state=st)
        rows.append(dict(method=name, loss=hist.global_loss[-1],
                         acc=hist.global_acc[-1], uplinks=tr.ledger.uplinks,
                         d2d_msgs=tr.ledger.d2d_msgs))
        print(f"{name:16s} {hist.global_loss[-1]:8.4f} "
              f"{hist.global_acc[-1]:7.3f} {tr.ledger.uplinks:8d} "
              f"{tr.ledger.d2d_msgs:7d}")

    print("\nTT-HF matches/beats FL tau=20 with 5x fewer uplink "
          "transmissions;\nincrease gamma_d2d to approach the tau=1 upper "
          "bound (Fig. 4).")
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
