"""End-to-end driver on the PyTorch port: pretrain a decoder LM with
TT-HF as the distributed sync strategy (scale mode). The twin of
``examples/tthf_lm_pretrain.py``; it runs on the CUDA device unless
``--device cpu`` is given.

4 model replicas in 2 clusters; each TT-HF interval = tau local SGD
steps + aperiodic D2D consensus (fused V^Gamma mixing) + a
cluster-sampled global aggregation. Replicas consume disjoint Zipf
shards (the non-iid delta>0 regime). The defaults are sized for a
smoke run.

Run:  PYTHONPATH=src python examples/torch_tthf_lm_pretrain.py \
          [--intervals 2] [--dim 768] [--layers 12]
"""
import argparse
import dataclasses
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.core.distributed import (
    TTHFScaleConfig, make_tthf_train_step, stack_replicas)
from repro_torch.core.sampling import TorchDraws
from repro_torch.data.tokens import synthetic_token_batches
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import build_model


def main(argv=None, *, params=None, draws=None):
    """Prints one line per interval and the uplink trailer, and returns
    the interval losses. ``params``: the starting weights of one replica
    (default: the model's init from a generator seeded with 0);
    ``draws``: the source of each interval's picks (default: a
    generator seeded with 1)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--intervals", type=int, default=2)
    ap.add_argument("--tau", type=int, default=4)
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--d-ff", type=int, default=1024)
    ap.add_argument("--vocab", type=int, default=32_000)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--sync", choices=["tthf", "star", "local"],
                    default="tthf")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = dataclasses.replace(
        get_arch("qwen1.5-0.5b"),
        num_layers=args.layers, d_model=args.dim, d_ff=args.d_ff,
        num_heads=max(4, args.dim // 64),
        num_kv_heads=max(4, args.dim // 64),
        head_dim=64, vocab_size=args.vocab, max_seq_len=4096)
    model = build_model(cfg)
    print(f"model: {cfg.param_count()/1e6:.0f}M params "
          f"(L={cfg.num_layers}, d={cfg.d_model}, vocab={cfg.vocab_size})")

    scale = TTHFScaleConfig(replicas=4, cluster_size=2, tau=args.tau,
                            consensus_every=max(args.tau // 2, 1),
                            gamma_d2d=2, lr=args.lr, consensus_mode="fused")
    step, net = make_tthf_train_step(model, scale, dtype=torch.float32,
                                     sync=args.sync, device=device)
    if params is None:
        params = model.init(torch.Generator(device).manual_seed(0), device)
    params = stack_replicas(params, scale.replicas)
    if draws is None:
        draws = TorchDraws(torch.Generator(device).manual_seed(1))
    gens = [synthetic_token_batches(args.batch, args.seq, cfg.vocab_size,
                                    seed=0, shard_id=r)
            for r in range(scale.replicas)]

    losses = []
    for it in range(args.intervals):
        mbs = [[next(g) for _ in range(scale.tau)] for g in gens]
        batch = {k: torch.as_tensor(np.stack(
            [[mbs[r][t][k] for r in range(scale.replicas)]
             for t in range(scale.tau)]), device=device)
            for k in ("tokens", "labels")}
        picks = draws.picks(net.num_clusters, scale.cluster_size, 1)
        t0 = time.time()
        params, loss = step(params, batch, picks.to(device), it)
        loss = float(loss)
        tok_s = scale.tau * scale.replicas * args.batch * args.seq \
            / (time.time() - t0)
        losses.append(loss)
        print(f"interval {it:3d}: loss={loss:.4f} "
              f"({scale.tau} local steps/replica, {tok_s:,.0f} tok/s, "
              f"sync={args.sync})")

    print("\nuplink traffic per interval: N_clusters models "
          f"({net.num_clusters}) vs full participation "
          f"({scale.replicas}) — the paper's cluster-sampling saving.")
    return losses


if __name__ == "__main__":
    main(sys.argv[1:])
