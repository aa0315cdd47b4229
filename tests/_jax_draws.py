"""A draw source for the port's sim trainer that replays the reference
trainer's JAX key schedule (``repro/core/tthf.py``), shared by the
parity tests: ``init`` splits the seed key once; every local-SGD
iteration splits the key into (key, k_step, k_agg), and device i's
minibatch is ``randint(split(k_step, I)[i], (B,), 0, D)``. A static
aggregation's picks, and under netsim dynamics the seed of its host
generator (``repro.rounds.resolver.host_rng``), come from the last
iteration's k_agg."""
import jax
import numpy as np
import torch

from repro.core import sampling as j_smp


class JaxReplayDraws:
    def __init__(self, seed):
        _, self.key = jax.random.split(jax.random.PRNGKey(seed))
        self.k_agg = None
        self.host_seeds = 0         # host_seed() calls, for the tests

    def minibatch(self, num_devices, batch, points):
        self.key, k_step, self.k_agg = jax.random.split(self.key, 3)
        keys = jax.random.split(k_step, num_devices)
        idx = jax.vmap(lambda k: jax.random.randint(k, (batch,), 0,
                                                    points))(keys)
        return torch.from_numpy(np.array(idx)).long()

    def picks(self, num_clusters, cluster_size, k):
        if k == 1:
            p = j_smp.sample_devices(self.k_agg, num_clusters, cluster_size)
        else:
            p = j_smp.sample_devices_multi(self.k_agg, num_clusters,
                                           cluster_size, k)
        return torch.from_numpy(np.array(p)).long()

    def host_seed(self):
        self.host_seeds += 1
        return int(jax.random.randint(self.k_agg, (), 0, 2**31 - 1))
