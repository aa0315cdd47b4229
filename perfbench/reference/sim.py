"""Algorithm 1 (TT-HF) over a fleet of the paper's one-hidden-layer
network, in plain PyTorch: every device's local SGD step (eqs. 8-9),
the consensus events ``z_c <- V_c^Gamma z_c`` every ``consensus_every``
steps, and the cluster-sampled global model of eq. (7) broadcast every
``tau`` steps; the global loss F(w_hat) over all points at each
evaluation; and the communication counts.

Under device churn each device is a two-state Markov chain (up to down
with ``p_device_drop``, down to up with ``p_device_return``, one draw a
device and iteration). A dark device takes no step and holds its
parameters; a consensus event mixes with Metropolis weights on the
active subgraph (a dark device's row the identity), and a cluster
without a live edge runs no rounds; an aggregation samples one
available device per cluster that has one, weighs the live clusters
alike, and broadcasts to the devices that are up."""
from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import topology
from perfbench.reference.common import change_norms, mm, precision


def fleet_losses(p: dict, x: torch.Tensor, y: torch.Tensor, reg: float,
                 prec: str) -> torch.Tensor:
    """(I,) mean NLL of each device's batch plus (reg/2)||W||^2."""
    h = torch.relu(mm(x, p["w1"], prec) + p["b1"][:, None, :])
    s = mm(h, p["w2"], prec) + p["b2"][:, None, :]
    nll = -torch.gather(torch.log_softmax(s, -1), 2,
                        y.long()[..., None])[..., 0].mean(-1)
    return nll + 0.5 * reg * (p["w1"].square().sum((1, 2))
                              + p["w2"].square().sum((1, 2)))


class SimReference:
    def __init__(self, cfg: dict, x: np.ndarray, y: np.ndarray, w0: dict,
                 device, prec: str = "highest", fault: str | None = None,
                 churn: dict | None = None):
        topo, sched = cfg["topology"], cfg["schedule"]
        self.N, I = topo["clusters"], topo["devices"]
        self.s = I // self.N
        adj, V = topology.clusters(self.N, self.s, topo["graph"],
                                   topo["target_spectral_radius"],
                                   topo["seed"])
        self.adj = adj
        self.edges = adj.sum((1, 2)) // 2
        self.churn = churn
        if churn is not None:
            # the stream first draws its straggler and flash-crowd sets
            self.chain = np.random.default_rng(churn["seed"])
            self.chain.permutation(I)
            self.chain.permutation(I)
            self.up = np.ones((self.N, self.s), bool)
        self.V = torch.as_tensor(V, dtype=torch.float32, device=device)
        self.sched = sched
        self.reg = cfg["model"]["reg"]
        self.batch = cfg["batch"]
        self.prec = prec
        self.fault = fault          # the control's planted faults
        self.x = torch.as_tensor(x, device=device)
        self.y = torch.as_tensor(y, device=device).long()
        self.w0 = {k: v.to(device) for k, v in w0.items()}
        self.params = {k: v.expand((I,) + tuple(v.shape)).clone()
                       for k, v in self.w0.items()}
        self.global_params = dict(self.w0)
        self.ledger = {"uplinks": 0, "d2d_msgs": 0, "d2d_rounds": 0,
                       "local_steps": 0}
        self.t = 0

    def _advance(self) -> None:
        if self.churn is None:
            return
        u = self.chain.random((self.N, self.s))
        drop = self.up & (u < self.churn["p_device_drop"])
        ret = ~self.up & (u < self.churn["p_device_return"])
        self.up = self.up & ~drop | ret

    def _local_step(self, draws) -> None:
        I, D = self.y.shape
        idx = draws.minibatch(I, self.batch, D).to(self.x.device)
        if self.fault == "half_batch":
            idx = idx[:, :self.batch // 2]
        rows = torch.arange(I, device=self.x.device)[:, None]
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in self.params.items()}
        loss = fleet_losses(leaves, self.x[rows, idx], self.y[rows, idx],
                            self.reg, self.prec).sum()
        grads = torch.autograd.grad(loss, list(leaves.values()))
        up = torch.as_tensor(self.up.reshape(-1) if self.churn is not None
                             else np.ones(I, bool), device=self.x.device)
        with torch.no_grad():
            for (k, v), g in zip(self.params.items(), grads):
                v[up] -= g[up] * self.sched["lr"]
        self.ledger["local_steps"] += int(up.sum())

    @torch.no_grad()
    def _consensus(self) -> None:
        G = self.sched["gamma_d2d"]
        V, edges = self.V, self.edges
        if self.churn is not None:
            a = self.adj & self.up[:, :, None] & self.up[:, None, :]
            V = torch.as_tensor(np.stack([topology.metropolis(c) for c in a]),
                                dtype=torch.float32, device=self.x.device)
            edges = a.sum((1, 2)) // 2
        gammas = np.where(edges > 0, G, 0)
        for k, v in self.params.items():
            z = v.reshape(self.N, self.s, -1)
            for r in range(G):
                mixed = mm(V, z, self.prec)
                live = torch.as_tensor(gammas > r, device=z.device)
                z = torch.where(live[:, None, None], mixed, z)
            self.params[k] = z.reshape(v.shape)
        self.ledger["d2d_rounds"] += int(gammas.sum())
        self.ledger["d2d_msgs"] += int(sum(g * 2 * e
                                           for g, e in zip(gammas, edges)))

    @torch.no_grad()
    def _aggregate(self, draws) -> None:
        if self.churn is not None:
            return self._aggregate_available(draws)
        picks = draws.picks(self.N, self.s, 1).to(self.x.device).long()
        rows = torch.arange(self.N, device=self.x.device)
        for k, v in self.params.items():
            z = v.reshape(self.N, self.s, -1)[rows, picks]     # (N, M)
            g = (z / self.N).sum(0).reshape(v.shape[1:])
            self.global_params[k] = g
            self.params[k] = g.expand(v.shape).clone()
        self.ledger["uplinks"] += self.N

    def _aggregate_available(self, draws) -> None:
        rng = np.random.default_rng(draws.host_seed())
        w = np.zeros((self.N, self.s))
        live = [c for c in range(self.N) if self.up[c].any()]
        for c in live:
            pick = rng.choice(np.flatnonzero(self.up[c]), size=1,
                              replace=False)[0]
            w[c, pick] = 1.0 / len(live)
        if not live:
            return
        w = torch.as_tensor(w, dtype=torch.float32, device=self.x.device)
        up = torch.as_tensor(self.up.reshape(-1), device=self.x.device)
        for k, v in self.params.items():
            z = v.reshape(self.N, self.s, -1)
            g = (w[:, :, None] * z).sum((0, 1)).reshape(v.shape[1:])
            self.global_params[k] = g
            v[up] = g
        self.ledger["uplinks"] += len(live)

    @torch.no_grad()
    def global_loss(self) -> float:
        one = {k: v[None] for k, v in self.global_params.items()}
        x = self.x.reshape(1, -1, self.x.shape[-1])
        y = self.y.reshape(1, -1)
        return float(fleet_losses(one, x, y, self.reg, self.prec)[0])

    def run(self, steps: int, draws, eval_every: int) -> list:
        """``steps`` iterations on; -> the global losses of the
        evaluations that fall due."""
        losses = []
        sch = self.sched
        with precision(self.prec):
            for _ in range(steps):
                self.t += 1
                self._advance()
                self._local_step(draws)
                if self.t % sch["consensus_every"] == 0 \
                        and self.fault != "no_consensus":
                    self._consensus()
                if self.t % sch["tau"] == 0:
                    self._aggregate(draws)
                if self.t % eval_every == 0:
                    losses.append(self.global_loss())
        return losses

    def change_norms(self) -> dict:
        return change_norms(self.params, self.w0)
