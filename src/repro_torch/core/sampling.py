"""Global aggregation with cluster sampling (eq. 7) and the trainer's
random draws — the port of ``repro/core/sampling.py``.

At t = t_k the server samples ONE device n_c uniformly from each cluster
and forms  w_hat = sum_c varrho_c * w_{n_c}.  ``sample_per_cluster > 1``
draws k representatives WITHOUT replacement and averages them within
the cluster.

Draws cross a seam: torch cannot reproduce JAX's threefry streams, so
the trainer takes its minibatch indices and per-cluster picks from a
*draw source* with four methods, ``minibatch(I, B, D) -> (I, B)`` (one
call per local-SGD iteration), ``picks(N, s, k) -> (N,) | (N, k)`` (one
call per sampled aggregation on the static topology, after the
iterations that precede it), ``host_seed() -> int`` (one call per
aggregation that samples on the host, in place of the picks: under
netsim dynamics, down a fog tree or under the control plane, it seeds
the host generator) and ``probe_minibatch(I, K, B, D, seed) -> (I, K,
B)`` (one call per gradient probe of the control plane: K minibatches
per device from a stream of its own, seeded once with ``seed``, that
never touches the training draws). Scale mode calls one of ``picks``
and ``host_seed`` per interval. :class:`TorchDraws` is the default
source; a test can hand the trainer any other object with those
methods, such as one that replays the reference's key schedule. A
source that is to be checkpointed also has ``state_dict()`` and
``load_state_dict(state)``: its state as a tree of numpy arrays.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def sample_devices(generator: torch.Generator, num_clusters: int,
                   cluster_size: int) -> torch.Tensor:
    """(N,) int64 — the sampled local index n_c within each cluster."""
    return torch.randint(0, cluster_size, (num_clusters,),
                         generator=generator, device=generator.device)


def sample_devices_multi(generator: torch.Generator, num_clusters: int,
                         cluster_size: int, k: int) -> torch.Tensor:
    """(N, k) int64 — k DISTINCT local indices per cluster, uniform
    without replacement (rank iid uniforms). k == 1 delegates to
    :func:`sample_devices`."""
    if not 1 <= k <= cluster_size:
        raise ValueError(
            f"sample_per_cluster must be in [1, {cluster_size}], got {k}")
    if k == 1:
        return sample_devices(generator, num_clusters, cluster_size)[:, None]
    scores = torch.rand((num_clusters, cluster_size), generator=generator,
                        device=generator.device)
    return torch.topk(scores, k, dim=1).indices


class TorchDraws:
    """The default draw source: one ``torch.Generator`` (on the
    trainer's device) serves every minibatch and every pick."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator
        self._probe: Optional[torch.Generator] = None

    def minibatch(self, num_devices: int, batch: int,
                  points: int) -> torch.Tensor:
        return torch.randint(0, points, (num_devices, batch),
                             generator=self.generator,
                             device=self.generator.device)

    def picks(self, num_clusters: int, cluster_size: int,
              k: int) -> torch.Tensor:
        if k == 1:
            return sample_devices(self.generator, num_clusters, cluster_size)
        return sample_devices_multi(self.generator, num_clusters,
                                    cluster_size, k)

    def host_seed(self) -> int:
        return int(torch.randint(0, 2**31 - 1, (), generator=self.generator,
                                 device=self.generator.device))

    def probe_minibatch(self, num_devices: int, draws: int, batch: int,
                        points: int, seed: int) -> torch.Tensor:
        if self._probe is None:
            self._probe = torch.Generator(
                device=self.generator.device).manual_seed(seed)
        return torch.randint(0, points, (num_devices, draws, batch),
                             generator=self._probe,
                             device=self._probe.device)

    def state_dict(self) -> dict:
        """The generators' states as uint8 arrays (a checkpoint's
        ``extra["draws"]``): restored, the source draws on as if it had
        never stopped."""
        state = {"generator": self.generator.get_state().numpy()}
        if self._probe is not None:
            state["probe"] = self._probe.get_state().numpy()
        return state

    def load_state_dict(self, state: dict) -> None:
        self.generator.set_state(_byte_state(state["generator"]))
        self._probe = None
        if "probe" in state:
            self._probe = torch.Generator(device=self.generator.device)
            self._probe.set_state(_byte_state(state["probe"]))


def _byte_state(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.uint8, copy=True))


def _take(z: torch.Tensor, picks: torch.Tensor) -> torch.Tensor:
    rows = torch.arange(z.shape[0], device=z.device)
    picks = picks.to(device=z.device, dtype=torch.long)
    return z[rows, picks] if picks.ndim == 1 else z[rows[:, None], picks]


def sampled_global_model(z: torch.Tensor, picks: torch.Tensor,
                         varrho: torch.Tensor) -> torch.Tensor:
    """z: (N, s, M), picks: (N,), varrho: (N,) -> (M,) the new w_hat."""
    return torch.einsum("c,cm->m", varrho.to(z.dtype), _take(z, picks))


def sampled_global_model_multi(z: torch.Tensor, picks: torch.Tensor,
                               varrho: torch.Tensor) -> torch.Tensor:
    """z: (N, s, M), picks: (N, k) -> (M,): varrho-weighted mean of the
    per-cluster averages of the k sampled representatives."""
    k = picks.shape[1]
    return torch.einsum("c,ckm->m", varrho.to(z.dtype) / k, _take(z, picks))


def sampled_global_pytree(params: dict, picks: torch.Tensor,
                          varrho: torch.Tensor, num_clusters: int) -> dict:
    """Leaves (I, ...) -> global model leaves (...). ``picks`` may be
    (N,) — the paper's eq. (7) — or (N, k)."""
    def one(leaf):
        z = leaf.reshape(num_clusters, leaf.shape[0] // num_clusters, -1)
        if picks.ndim == 1:
            g = sampled_global_model(z, picks, varrho)
        else:
            g = sampled_global_model_multi(z, picks, varrho)
        return g.reshape(leaf.shape[1:])
    return {k: one(v) for k, v in params.items()}


def full_global_pytree(params: dict, varrho: torch.Tensor,
                       num_clusters: int) -> dict:
    """Full-participation aggregation (baseline FL): weighted mean of all
    devices = sum_c varrho_c * (1/s_c) sum_i w_i."""
    def one(leaf):
        z = leaf.reshape(num_clusters, leaf.shape[0] // num_clusters,
                         -1).mean(dim=1)
        g = torch.einsum("c,cm->m", varrho.to(z.dtype), z)
        return g.reshape(leaf.shape[1:])
    return {k: one(v) for k, v in params.items()}


def broadcast_pytree(global_params: dict, num_devices: int) -> dict:
    """Server broadcast: w_i <- w_hat for all i (materialized copies, so
    the trainer may update them in place)."""
    return {k: g.repeat(num_devices, *([1] * g.ndim))
            for k, g in global_params.items()}


__all__ = ["TorchDraws", "broadcast_pytree", "full_global_pytree",
           "sample_devices", "sample_devices_multi", "sampled_global_model",
           "sampled_global_model_multi", "sampled_global_pytree"]
