"""Inputs made from the run's seed, handed alike to the program and to
the reference: the federated data set of the simulation, the token
streams of a language-model job, the initial weights and the draw
source (minibatch indices and cluster picks).

The data generator and the label partition follow the paper's Sec.
IV-A setup (a Fashion-MNIST-shaped synthetic set, 3 labels per device)
and are frozen here, so the inputs of a cell never change with the
program.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def subseed(seed: int, name: str) -> int:
    """A 63-bit seed of its own for each named input stream."""
    ss = np.random.SeedSequence([int(seed) & (2**64 - 1), int(seed) >> 64,
                                 *name.encode()])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


# ---------------------------------------------------------------------------
# draws
# ---------------------------------------------------------------------------

class Draws:
    """A draw source from one numpy generator: minibatch indices, one
    call per local iteration, and the sampled device of each cluster,
    one call per aggregation. Two sources of one seed draw the same."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(subseed(seed, "draws"))

    def minibatch(self, num_devices, batch, points):
        return torch.from_numpy(
            self.rng.integers(0, points, size=(num_devices, batch)))

    def picks(self, num_clusters, cluster_size, k):
        if k == 1:
            return torch.from_numpy(
                self.rng.integers(0, cluster_size, size=(num_clusters,)))
        return torch.from_numpy(np.stack(
            [self.rng.permutation(cluster_size)[:k]
             for _ in range(num_clusters)]))

    def host_seed(self):
        return int(self.rng.integers(0, 2**31 - 1))


# ---------------------------------------------------------------------------
# the simulation's data (paper Sec. IV-A)
# ---------------------------------------------------------------------------

def fashion_data(num_points: int, dim: int, num_classes: int, rank: int,
                 noise: float, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """Class-conditional low-rank Gaussian images in [0, 1]: a smooth
    template per class, a shared low-rank basis and pixel noise."""
    rng = np.random.default_rng(subseed(seed, "fashion"))
    side = int(round(math.sqrt(dim)))
    templates = []
    for _ in range(num_classes):
        field = rng.normal(size=(side, side))
        for _ in range(3):
            f = np.pad(field, 1, mode="edge")
            field = sum(f[i:i + side, j:j + side]
                        for i in range(3) for j in range(3)) / 9.0
        field = (field - field.min()) / (np.ptp(field) + 1e-9)
        templates.append(field.reshape(-1))
    templates = np.stack(templates)
    basis = rng.normal(size=(dim, rank)) / np.sqrt(rank)
    y = rng.integers(0, num_classes, size=num_points).astype(np.int32)
    z = rng.normal(size=(num_points, rank)).astype(np.float32) * 0.5
    eps = rng.normal(size=(num_points, dim)).astype(np.float32)
    x = templates[y] + z @ basis.T.astype(np.float32) + noise * eps
    return np.clip(x, 0.0, 1.0).astype(np.float32), y


def partition_labels(x: np.ndarray, y: np.ndarray, num_devices: int,
                     labels_per_device: int, seed: int
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Non-iid split: device i holds points of the labels i, i+1, ...
    (mod C), an equal share of each -> x (I, D, m), y (I, D)."""
    rng = np.random.default_rng(subseed(seed, "partition"))
    num_classes = int(y.max()) + 1
    by_class = [rng.permutation(np.flatnonzero(y == c))
                for c in range(num_classes)]
    per_label = len(y) // num_devices // labels_per_device
    ptrs = [0] * num_classes
    xs, ys = [], []
    for i in range(num_devices):
        take = []
        for j in range(labels_per_device):
            c = (i + j) % num_classes
            idx = by_class[c]
            take.append(idx[np.arange(ptrs[c], ptrs[c] + per_label)
                            % len(idx)])
            ptrs[c] += per_label
        take = np.concatenate(take)
        take = take[rng.permutation(len(take))]
        xs.append(x[take])
        ys.append(y[take])
    return np.stack(xs).astype(np.float32), np.stack(ys).astype(np.int32)


def sim_data(cfg: dict, seed: int) -> tuple[np.ndarray, np.ndarray]:
    d = cfg["data"]
    x, y = fashion_data(d["points"], d["dim"], d["classes"], d["rank"],
                        d["noise"], seed)
    return partition_labels(x, y, cfg["topology"]["devices"],
                            d["labels_per_device"], seed)


def nn_weights(cfg: dict, seed: int, device) -> dict:
    """The one-hidden-layer network's initial weights: He-normal w1,
    1/sqrt(fan-in) w2, zero biases."""
    m = cfg["model"]
    dim, hidden, classes = m["dim"], m["hidden"], m["classes"]
    gen = torch.Generator(device=device).manual_seed(subseed(seed, "w0"))
    w = torch.randn(dim * hidden + hidden * classes, generator=gen,
                    device=device)
    return {"b1": torch.zeros(hidden, device=device),
            "b2": torch.zeros(classes, device=device),
            "w1": w[:dim * hidden].view(dim, hidden).mul_(
                math.sqrt(2.0 / dim)),
            "w2": w[dim * hidden:].view(hidden, classes).mul_(
                math.sqrt(1.0 / hidden))}


# ---------------------------------------------------------------------------
# a language-model job's tokens and weights
# ---------------------------------------------------------------------------

def token_stream(seed: int, replica: int, batch: int, seq_len: int,
                 vocab: int):
    """Endless {tokens, labels} batches of one replica: Zipf-distributed
    ids under a permutation of the vocabulary of the replica's own, so
    the replicas' data differ (the non-iid regime)."""
    rng = np.random.default_rng(subseed(seed, f"tokens{replica}"))
    cdf = np.cumsum(1.0 / np.arange(1, vocab + 1))
    cdf /= cdf[-1]
    perm = rng.permutation(vocab)
    while True:
        ids = np.minimum(np.searchsorted(cdf, rng.random(
            batch * (seq_len + 1))), vocab - 1)
        flat = perm[ids].reshape(batch, seq_len + 1).astype(np.int32)
        yield {"tokens": flat[:, :-1], "labels": flat[:, 1:]}


def ssm_dims(m: dict) -> tuple[int, int, int, int, int, int, int]:
    d = m["d_model"]
    d_in = m["ssm_expand"] * d
    return (d, d_in, m["ssm_num_heads"], m["ssm_head_dim"],
            m["ssm_state_dim"], m["ssm_conv_width"], m["num_layers"])


def mamba2_weights(cfg: dict, seed: int, device) -> dict:
    """Mamba-2 weights in the layout the program takes (layers stacked on
    a leading axis): normal projections scaled by 1/sqrt(fan-in), 0.02
    embeddings, 0.1 convolutions, A = -[1 .. 16], dt in [1e-3, 1e-1]
    through the softplus, D = 1, zero RMSNorm scales (the norm multiplies
    by 1 + scale). All random leaves come from one draw on ``device``."""
    m = cfg["model"]
    d, d_in, H, P, S, K, L = ssm_dims(m)
    V = m["vocab_rows"]
    shapes = {"embed": (V, d), "w_in": (L, d, 2 * d_in + 2 * S + H),
              "w_out": (L, d_in, d), "conv_x": (L, K, d_in),
              "conv_B": (L, K, S), "conv_C": (L, K, S)}
    scale = {"embed": 0.02, "w_in": 1 / math.sqrt(d),
             "w_out": 1 / math.sqrt(d_in), "conv_x": 0.1, "conv_B": 0.1,
             "conv_C": 0.1}
    gen = torch.Generator(device=device).manual_seed(subseed(seed, "w0"))
    flat = torch.randn(sum(math.prod(s) for s in shapes.values()),
                       generator=gen, device=device)
    leaves, off = {}, 0
    for k, s in shapes.items():
        n = math.prod(s)
        leaves[k] = flat[off:off + n].view(s).mul_(scale[k])
        off += n

    def per_head(v):
        return v.to(device).expand(L, H).contiguous()
    ssm = {"A_log": per_head(torch.log(torch.linspace(1.0, 16.0, H))),
           "D": torch.ones(L, H, device=device),
           "dt_bias": per_head(torch.log(torch.expm1(
               torch.linspace(1e-3, 1e-1, H)))),
           **{k: leaves[k] for k in ("w_in", "w_out", "conv_x", "conv_B",
                                     "conv_C")}}
    return {"embed": leaves["embed"],
            "ln_final": {"scale": torch.zeros(d, device=device)},
            "layers": {"ln": {"scale": torch.zeros(L, d, device=device)},
                       "ssm": ssm}}


def tree_items(tree: dict, prefix: tuple = ()) -> list:
    """(key path, leaf) pairs, keys sorted, depth first."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.extend(tree_items(v, prefix + (k,)))
        else:
            out.append((prefix + (k,), v))
    return out
