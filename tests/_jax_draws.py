"""Draw sources for the port's trainers that replay the reference
trainers' JAX key schedules, shared by the parity tests.

:class:`JaxReplayDraws` (sim, ``repro/core/tthf.py``): ``init`` splits the
seed key once; every local-SGD iteration splits the key into (key,
k_step, k_agg), and device i's minibatch is ``randint(split(k_step,
I)[i], (B,), 0, D)``. A static aggregation's picks, and the seed of a
host generator (``repro.rounds.resolver.host_rng``: netsim dynamics, a
fog tree, the control plane), come from the last iteration's k_agg. The
control plane's gradient probe draws from a key of its own,
``PRNGKey(estimator_seed + 0x51F0)``, split once per probe into (key,
k); device i's draw d is ``randint(split(k, I * K).reshape(I, K)[i, d],
(B,), 0, D)``.

:class:`JaxScaleReplayDraws` (scale, ``repro/train/trainer.py``): the key
starts at ``PRNGKey(seed)`` and every interval splits it into (key, kp);
the interval's picks are ``sample_devices(kp, N, s)`` (or
``sample_devices_multi`` for k > 1), and a host generator's seed is
``randint(kp, (), 0, 2**31 - 1)``. Its ``state_dict()`` is the current
key, so that a checkpoint of the port's trainer resumes the schedule.
"""
import jax
import numpy as np
import torch

from repro.core import sampling as j_smp


def _host_seed(key):
    return int(jax.random.randint(key, (), 0, 2**31 - 1))


def _picks(key, num_clusters, cluster_size, k):
    if k == 1:
        p = j_smp.sample_devices(key, num_clusters, cluster_size)
    else:
        p = j_smp.sample_devices_multi(key, num_clusters, cluster_size, k)
    return torch.from_numpy(np.array(p)).long()


class JaxReplayDraws:
    def __init__(self, seed):
        _, self.key = jax.random.split(jax.random.PRNGKey(seed))
        self.k_agg = None
        self.ctl_key = None
        self.host_seeds = 0         # host_seed() calls, for the tests
        self.probes = 0             # probe_minibatch() calls

    def minibatch(self, num_devices, batch, points):
        self.key, k_step, self.k_agg = jax.random.split(self.key, 3)
        keys = jax.random.split(k_step, num_devices)
        idx = jax.vmap(lambda k: jax.random.randint(k, (batch,), 0,
                                                    points))(keys)
        return torch.from_numpy(np.array(idx)).long()

    def picks(self, num_clusters, cluster_size, k):
        return _picks(self.k_agg, num_clusters, cluster_size, k)

    def host_seed(self):
        self.host_seeds += 1
        return _host_seed(self.k_agg)

    def probe_minibatch(self, num_devices, draws, batch, points, seed):
        if self.ctl_key is None:
            self.ctl_key = jax.random.PRNGKey(seed)
        self.probes += 1
        self.ctl_key, k = jax.random.split(self.ctl_key)
        keys = jax.random.split(k, num_devices * draws).reshape(
            num_devices, draws, -1)
        idx = jax.vmap(jax.vmap(lambda kk: jax.random.randint(
            kk, (batch,), 0, points)))(keys)
        return torch.from_numpy(np.array(idx)).long()


class JaxScaleReplayDraws:
    def __init__(self, seed):
        self.key = jax.random.PRNGKey(seed)
        self.host_seeds = 0

    def state_dict(self):
        """The cursor into the key schedule: the current key."""
        return {"key": np.asarray(self.key)}

    def load_state_dict(self, state):
        self.key = jax.numpy.asarray(state["key"])

    def _split(self):
        self.key, kp = jax.random.split(self.key)
        return kp

    def picks(self, num_clusters, cluster_size, k):
        return _picks(self._split(), num_clusters, cluster_size, k)

    def host_seed(self):
        self.host_seeds += 1
        return _host_seed(self._split())
