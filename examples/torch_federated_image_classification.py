"""The paper's Sec.-IV experiment on the PyTorch port: I=125 devices,
N=25 clusters of s_c=5, geometric D2D graphs (avg spectral radius 0.7),
non-iid 3-label shards, SVM + adaptive Remark-1 consensus and the
decaying step size eta_t = gamma/(t+alpha) of Theorem 2. The twin of
``examples/federated_image_classification.py``; it runs on the CUDA
device unless ``--device cpu`` is given.

Plots-as-text: loss/accuracy trajectories + uplink/D2D accounting +
the analytic nu/(t+alpha) envelope.

Run:  PYTHONPATH=src python examples/torch_federated_image_classification.py
      (add --fast for a 25-device version)
"""
import argparse
import sys

import numpy as np

from repro_torch.configs import TopologyConfig, TTHFConfig
from repro_torch.core import TTHFTrainer, bound_curve
from repro_torch.data import fashion_synth, partition_noniid_labels
from repro_torch.models import make_sim_model


def main(argv=None, *, init=None):
    """Prints the trajectory table and the ledger's totals, and returns
    the trainer and its history. ``init(trainer, seed) -> TTHFState``
    replaces the trainer's own ``init`` (starting weights and draws)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    devices, clusters, points = ((25, 5, 6000) if args.fast
                                 else (125, 25, 31250))

    x, y = fashion_synth(num_points=points, seed=0, unit_norm=True)
    data = partition_noniid_labels(x, y, num_devices=devices,
                                   labels_per_device=3)
    topo = TopologyConfig(num_devices=devices, num_clusters=clusters,
                          graph="geometric", target_spectral_radius=0.7,
                          seed=0)
    model = make_sim_model("svm", data.feature_dim, data.num_classes)

    # Theorem-2 compliant schedules: eta_t = gamma/(t+alpha) with
    # gamma > 1/mu (mu = 0.1), eps^(t) = eta_t * phi via adaptive Gamma.
    algo = TTHFConfig(tau=10, consensus_every=5, gamma_d2d=-1, phi=0.05,
                      gamma=20.0, alpha=1000.0)
    tr = TTHFTrainer(model, data, topo, algo, batch_size=16,
                     use_kernel=True, device=args.device)
    print(f"network: {devices} devices, {clusters} clusters, "
          f"avg lambda={tr.net.lambdas.mean():.3f}")
    st = init(tr, 0) if init is not None else None
    _, hist = tr.run(steps=args.steps, eval_every=max(args.steps // 10, 1),
                     state=st)

    ts = np.asarray(hist.ts, float)
    loss = np.asarray(hist.global_loss)
    gap = loss - (loss.min() - 1e-3)
    nu = gap[0] * (ts[0] + algo.alpha)
    env = bound_curve(1.5 * nu, algo.alpha, ts)

    print(f"\n{'t':>6s} {'loss':>9s} {'acc':>7s} {'gap':>9s} "
          f"{'nu/(t+a)':>9s} {'Gamma_c (mean)':>14s}")
    for i, t in enumerate(ts):
        g = np.mean(hist.gamma_used[i])
        print(f"{int(t):6d} {loss[i]:9.4f} {hist.global_acc[i]:7.3f} "
              f"{gap[i]:9.4f} {env[i]:9.4f} {g:14.1f}")

    print(f"\nuplinks={tr.ledger.uplinks} (cluster-sampled; full "
          f"participation would be {tr.ledger.uplinks * topo.cluster_size})")
    print(f"d2d messages={tr.ledger.d2d_msgs}, "
          f"d2d rounds={tr.ledger.d2d_rounds}")
    print(f"energy @ E_D2D/E_Glob=0.1: {tr.ledger.energy(0.1):.2f} J; "
          f"delay @ 0.1: {tr.ledger.delay(0.1):.1f} s")
    print("O(1/t) envelope holds:", bool((gap[1:] <= env[1:]).all()))
    return tr, hist


if __name__ == "__main__":
    main(sys.argv[1:])
