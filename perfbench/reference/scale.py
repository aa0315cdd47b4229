"""The TT-HF interval over the replicas of any language model, in plain
PyTorch; the model enters as its loss (a model plug-in's ``loss``).

The interval: ``tau`` local SGD steps of every replica on its own
batches, after every ``consensus_every`` steps the mix ``w <- W w``
with ``W = V^Gamma`` within each cluster, then the cluster-sampled
global model (eq. 7) on every replica. The ``CommLedger`` counts follow
the same events. ``prec`` names the precision of every matrix product
(the control: ``"tf32"``); ``fault`` plants one of the check's faults:
``"half_batch"`` (half of each minibatch left out, the mean taken over
the rest) or ``"no_consensus"`` (the D2D mix left out)."""
from __future__ import annotations

import numpy as np
import torch

from perfbench.inputs import tree_items
from perfbench.reference import topology
from perfbench.reference.common import change_norms, mm, precision


def _tree(items):
    out: dict = {}
    for path, v in items:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


class ScaleReference:
    """TT-HF intervals over ``replicas`` copies of the model whose loss is
    ``loss(params, tokens, labels, cfg, prec)``, from ``w0``."""

    def __init__(self, cfg: dict, traffic: dict, w0: dict, loss, device,
                 prec: str = "highest", fault: str | None = None):
        self.cfg = cfg
        self.loss = loss
        self.tr = traffic
        R, s = traffic["replicas"], traffic["cluster_size"]
        self.N, self.s = R // s, s
        adj, V = topology.clusters(self.N, s, traffic["graph"])
        self.edges = [int(e) for e in adj.sum((1, 2)) // 2]
        W = np.stack([np.linalg.matrix_power(v, traffic["gamma_d2d"])
                      for v in V])
        self.W = torch.as_tensor(W, dtype=torch.float32, device=device)
        self.prec = prec
        self.fault = fault          # the control's planted faults
        self.paths = [p for p, _ in tree_items(w0)]
        self.w0 = [v for _, v in tree_items(w0)]
        self.reps = [[v.clone() for v in self.w0] for _ in range(R)]
        self.ledger = {"uplinks": 0, "d2d_msgs": 0, "d2d_rounds": 0,
                       "local_steps": 0}
        self.device = device

    def _grads(self, leaves, batch):
        ps = [v.detach().requires_grad_(True) for v in leaves]
        rows = len(batch["tokens"])
        if self.fault == "half_batch":
            rows //= 2
        tokens = torch.as_tensor(batch["tokens"][:rows], device=self.device)
        labels = torch.as_tensor(batch["labels"][:rows], device=self.device)
        ls = self.loss(_tree(zip(self.paths, ps)), tokens, labels, self.cfg,
                       self.prec)
        return ls.detach(), torch.autograd.grad(ls, ps)

    @torch.no_grad()
    def _mix(self):
        for j in range(len(self.w0)):
            z = torch.stack([r[j] for r in self.reps])
            shape = z.shape
            z = mm(self.W, z.reshape(self.N, self.s, -1), self.prec)
            for r, row in zip(self.reps, z.reshape(shape)):
                r[j] = row

    def interval(self, streams, draws) -> float:
        """One interval; ``streams`` the replicas' batch iterators. ->
        the mean loss over its steps and replicas."""
        tr = self.tr
        R = len(self.reps)
        losses = []
        with precision(self.prec):
            for t in range(tr["tau"]):
                step = []
                for r in range(R):
                    ls, gs = self._grads(self.reps[r], next(streams[r]))
                    with torch.no_grad():
                        for w, g in zip(self.reps[r], gs):
                            w.sub_(g * tr["lr"])
                    step.append(ls)
                losses.append(torch.stack(step).mean())
                self.ledger["local_steps"] += R
                if (t + 1) % tr["consensus_every"] == 0:
                    if self.fault != "no_consensus":
                        self._mix()
                    G = tr["gamma_d2d"]
                    self.ledger["d2d_rounds"] += G * self.N
                    self.ledger["d2d_msgs"] += sum(G * 2 * e
                                                   for e in self.edges)
            picks = draws.picks(self.N, self.s, 1).long()
            with torch.no_grad():
                chosen = [self.reps[c * self.s + int(picks[c])]
                          for c in range(self.N)]
                glob = [sum(rep[j] for rep in chosen) / self.N
                        for j in range(len(self.w0))]
                self.reps = [[g.clone() for g in glob] for _ in range(R)]
            self.ledger["uplinks"] += self.N
        return float(torch.stack(losses).mean())

    def change_norms(self) -> dict:
        name = ".".join
        return change_norms({name(p): v for p, v in
                             zip(self.paths, self.reps[0])},
                            {name(p): v for p, v in
                             zip(self.paths, self.w0)})
