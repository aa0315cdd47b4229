"""TT-HF *scale mode* — the port of ``repro/core/distributed.py``: the
paper's two-timescale sync as the distributed-training strategy for the
model zoo, on one device.

Mapping (as in the reference):
  FL device  -> model replica (a full copy of the parameters)
  cluster    -> a contiguous block of ``cluster_size`` replicas
  local SGD  -> tau microsteps with no cross-replica traffic
  D2D round  -> block-diagonal mixing over the replica axis
  global agg -> cluster-sampled, varrho-weighted average + broadcast

One ``step`` call is one aggregation interval (Algorithm 1 lines 4-15):
``tau // consensus_every`` blocks of ``consensus_every`` microsteps, each
block ending in a consensus event. The reference's ``vmap(value_and_grad)``
over replicas is a loop over replicas here: each replica's loss
backpropagates into its own parameters, which are views into the
replicated leaves (per-leaf step) or into the flat ``(R, P)`` buffer
(fused interval). The learning rate stays a float32 tensor.

JAX arrays are immutable; the port updates in place where that saves
memory: a step updates the parameters it is given (the microsteps write
into them) and returns the interval's result, which the caller keeps.
The reference's buffer donation has no other counterpart.

Ported: all three aggregation forms of the reference, for ``sync`` in
{tthf, star, local} and every mixing backend (``consensus_mode`` fused |
rounds | the backend names): ``picks`` (one sampled replica per
cluster), ``weights`` (the (N, s) per-device weights: multi-sampling,
netsim dynamics, the control plane) and ``matrix`` (a fog hierarchy's
composed (R, R) device matrix), with per-interval refreshes of the
mixing matrices (``refreshable``). The weights and matrix forms work in
place: the matrix form in column blocks of the buffer, so that at 8
replicas of qwen1.5-0.5b it never holds a second (R, P) buffer.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import TopologyConfig
from repro_torch.core.mixing import MixingPlan, build_mixing_plan
from repro_torch.core.topology import Network, build_network
from repro_torch.kernels.fused_consensus_sgd import fused_consensus_sgd
from repro_torch.kernels.runtime import DeviceLike, resolve_device
from repro_torch.models.common import (
    tree_from_items, tree_items, tree_leaves, tree_map)
from repro_torch.models.registry import ModelApi

# columns of the (R, P) buffer (or of a leaf) that the matrix form maps at
# a time: a (R, 2^22) f32 block is 128 MiB at R = 8
MATRIX_BLOCK_COLS = 1 << 22

SYNCS = ("tthf", "star", "local")


@dataclass(frozen=True)
class TTHFScaleConfig:
    replicas: int = 16              # I (devices) = replica count
    cluster_size: int = 4           # s_c
    tau: int = 20                   # local interval length
    consensus_every: int = 5        # D2D event calendar
    gamma_d2d: int = 2              # rounds per event (static)
    consensus_mode: str = "fused"   # mixing backend (core/mixing.py):
                                    # fused|rounds aliases or reference|
                                    # masked_loop|pallas|fused_power
    lr: float = 1e-2
    sample_per_cluster: int = 1
    graph: str = "ring"
    granularity: str = "dp"         # dp (replica = data rank) | pod; it
                                    # sets the shardings only
    seed: int = 0

    @property
    def num_clusters(self) -> int:
        if self.replicas % self.cluster_size:
            raise ValueError(f"{self.replicas} replicas do not split into "
                             f"clusters of {self.cluster_size}")
        return self.replicas // self.cluster_size

    def network(self) -> Network:
        return build_network(TopologyConfig(
            num_devices=self.replicas, num_clusters=self.num_clusters,
            graph=self.graph, seed=self.seed))


# ---------------------------------------------------------------------------
# replica-axis aggregation (per-leaf trees: leaves (R, ...))
# ---------------------------------------------------------------------------

def _varrho(net: Network, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(net.varrho, np.float32),
                           device=like.device).to(like.dtype)


def _sampled_global(z: torch.Tensor, net: Network,
                    picks: torch.Tensor) -> torch.Tensor:
    """z: (N, s, M), picks: (N,) -> (M,) = sum_c varrho_c z[c, picks_c]."""
    rows = torch.arange(z.shape[0], device=z.device)
    chosen = z[rows, picks.to(device=z.device, dtype=torch.long)]
    return torch.einsum("c,cm->m", _varrho(net, z), chosen)


def _broadcast(w_hat: torch.Tensor, shape) -> torch.Tensor:
    """The server broadcast as materialized copies (trainers update the
    replicas in place afterwards)."""
    return w_hat.expand(shape[0], -1).reshape(shape).contiguous()


def sampled_aggregation(params: dict, net: Network,
                        picks: torch.Tensor) -> dict:
    """eq. (7): w_hat = sum_c varrho_c w_{n_c}; broadcast to all replicas."""
    N, s = net.num_clusters, net.cluster_size
    return tree_map(lambda leaf: _broadcast(
        _sampled_global(leaf.reshape(N, s, -1), net, picks), leaf.shape),
        params)


def _weighted_rows(x: torch.Tensor, net: Network,
                   weights: torch.Tensor) -> torch.Tensor:
    """x: (R, M) -> the same rows, each set to sum_{c,i} w[c, i] x[c, i]
    in place; an all-dark event (weights summing to 0) leaves them as
    they were, decided on the device (no host sync)."""
    N, s = net.num_clusters, net.cluster_size
    w = weights.to(device=x.device, dtype=x.dtype)
    g = torch.einsum("cs,csm->m", w, x.view(N, s, -1))
    alive = w.sum() > 0
    for row in x:
        row.copy_(torch.where(alive, g, row))
    return x


def weighted_aggregation(params: dict, net: Network,
                         weights: torch.Tensor) -> dict:
    """Availability-aware eq. (7) over the replica axis, in place.

    ``weights``: the (N, s) per-device aggregation weights from
    :func:`repro_torch.netsim.faults.aggregation_weights`: every sampled
    replica enters with its renormalized weight, a dark cluster's
    replicas with 0. The global model goes to every replica (replicas are
    physical shards); an all-dark event is the identity."""
    for leaf in tree_leaves(params):
        _weighted_rows(leaf.view(leaf.shape[0], -1), net, weights)
    return params


def _matrix_rows(x: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """x: (R, K) <- M @ x in place, ``MATRIX_BLOCK_COLS`` columns at a
    time (out of place for each block, then copied back)."""
    M = M.to(device=x.device, dtype=x.dtype)
    for c0 in range(0, x.shape[1], MATRIX_BLOCK_COLS):
        blk = x[:, c0:c0 + MATRIX_BLOCK_COLS]
        blk.copy_(M @ blk)
    return x


def apply_device_matrix_pytree(params: dict, M: torch.Tensor) -> dict:
    """A fog hierarchy's composed (R, R) event matrix on every leaf
    (leaves (R, ...)), in place. Hold-rows (e_i) are built into M."""
    for leaf in tree_leaves(params):
        _matrix_rows(leaf.view(leaf.shape[0], -1), M)
    return params


def full_aggregation(params: dict, net: Network) -> dict:
    """Star/FedAvg baseline: full-participation weighted mean."""
    N, s = net.num_clusters, net.cluster_size

    def one(leaf):
        z = leaf.reshape(N, s, -1).mean(dim=1)
        return _broadcast(torch.einsum("c,cm->m", _varrho(net, z), z),
                          leaf.shape)
    return tree_map(one, params)


# ---------------------------------------------------------------------------
# the flattened replica buffer of the fused interval
# ---------------------------------------------------------------------------

LANE = 128      # the flat buffer's P is padded to a multiple of this once


@dataclass(frozen=True)
class FlatParamSpec:
    """Layout of the lane-padded flat ``(R, P)`` replica buffer.

    Leaves are packed back to back along P in the reference's leaf order
    (shapes exclude the replica axis); P is padded to a multiple of 128
    once. Every interval op is per-column linear over the replica axis,
    so the zero pad columns stay zero. :meth:`unflatten` and
    :meth:`unflatten_one` return views (slice + reshape, no copy)."""
    paths: tuple[tuple[str, ...], ...]
    shapes: tuple[tuple[int, ...], ...]
    offsets: tuple[int, ...]
    sizes: tuple[int, ...]
    dtype: torch.dtype
    total: int          # packed length (sum of leaf sizes)
    padded: int         # lane-padded P

    @classmethod
    def for_tree(cls, tree: dict) -> "FlatParamSpec":
        """Build from a per-replica tree of tensors (leaf shapes WITHOUT
        the replica axis; ``meta`` tensors will do)."""
        items = tree_items(tree)
        if not items:
            raise ValueError("empty parameter tree")
        dtypes = {v.dtype for _, v in items}
        if len(dtypes) != 1:
            raise TypeError(
                f"flat buffer needs a uniform param dtype, got {dtypes}")
        shapes = tuple(tuple(int(d) for d in v.shape) for _, v in items)
        sizes = tuple(int(np.prod(s, dtype=np.int64)) for s in shapes)
        offsets = tuple(int(o) for o in
                        np.concatenate([[0], np.cumsum(sizes)[:-1]]))
        total = int(sum(sizes))
        return cls(paths=tuple(p for p, _ in items), shapes=shapes,
                   offsets=offsets, sizes=sizes, dtype=dtypes.pop(),
                   total=total, padded=-(-total // LANE) * LANE)

    @classmethod
    def for_model(cls, model: ModelApi,
                  dtype=torch.float32) -> "FlatParamSpec":
        p_abs, _ = model.abstract_params(dtype=dtype)
        return cls.for_tree(p_abs)

    # -- conversions ----------------------------------------------------
    def flatten(self, tree: dict) -> torch.Tensor:
        """Replicated tree (leaves (R, *shape)) -> a new flat (R, P),
        leaves cast to the spec dtype, pad columns zero."""
        leaves = tree_leaves(tree)
        R = leaves[0].shape[0]
        flat = torch.empty((R, self.padded), dtype=self.dtype,
                           device=leaves[0].device)
        for leaf, o, n in zip(leaves, self.offsets, self.sizes):
            flat[:, o:o + n] = leaf.reshape(R, n)
        flat[:, self.total:] = 0
        return flat

    def leaf_views(self, row: torch.Tensor) -> list[torch.Tensor]:
        """Views of one replica's row (P,) as the leaves, in order."""
        return [row[o:o + n].view(s)
                for o, n, s in zip(self.offsets, self.sizes, self.shapes)]

    def unflatten(self, flat: torch.Tensor) -> dict:
        """Flat (R, P) -> replicated tree of views (leaves (R, *shape))."""
        R = flat.shape[0]
        return tree_from_items(
            (p, flat[:, o:o + n].view((R,) + s)) for p, o, n, s in
            zip(self.paths, self.offsets, self.sizes, self.shapes))

    def unflatten_one(self, row: torch.Tensor) -> dict:
        """One replica's row (P,) -> per-replica tree of views."""
        return tree_from_items(zip(self.paths, self.leaf_views(row)))


# flat (R, P) counterparts of the tree aggregations above — the same
# per-column linear maps

def sampled_aggregation_flat(flat: torch.Tensor, net: Network,
                             picks: torch.Tensor) -> torch.Tensor:
    N, s = net.num_clusters, net.cluster_size
    return _broadcast(_sampled_global(flat.view(N, s, -1), net, picks),
                      flat.shape)


def weighted_aggregation_flat(flat: torch.Tensor, net: Network,
                              weights: torch.Tensor) -> torch.Tensor:
    return _weighted_rows(flat, net, weights)


def apply_device_matrix_flat(flat: torch.Tensor,
                             M: torch.Tensor) -> torch.Tensor:
    return _matrix_rows(flat, M)


def full_aggregation_flat(flat: torch.Tensor, net: Network) -> torch.Tensor:
    N, s = net.num_clusters, net.cluster_size
    z = flat.view(N, s, -1).mean(dim=1)
    return _broadcast(torch.einsum("c,cm->m", _varrho(net, z), z),
                      flat.shape)


# ---------------------------------------------------------------------------
# sharding plumbing
# ---------------------------------------------------------------------------

def replica_axes_tree(axes_tree: dict) -> dict:
    """Prefix every logical-axes tuple with the replica axis."""
    return tree_map(lambda a: ("replica",) + tuple(a), axes_tree)


TTHF_PARAM_RULES = (
    ("replica", ("pod", "data")),
    # within-replica: tensor parallel over model ONLY (a replica must be
    # self-contained — no fsdp over the replica axes)
    ("embed", None),
    ("embed_nomodel", None),
    ("embed_fsdp", None),
    ("vocab", "model"),
    ("q_proj", "model"),
    ("kv_proj", "model"),
    ("ffn", "model"),
    ("experts", "model"),
    ("expert_ffn", None),
    ("experts_router", None),
    ("ssm_in", "model"),
    ("ssm_heads", "model"),
    ("ssm_state", None),
    ("rnn_width", "model"),
    ("rnn_width_in", None),
    ("conv_k", None),
    ("layers", None),
    ("batch", None),
)


def tthf_rules(scale: TTHFScaleConfig):
    """The replicated params' rule table. ``granularity == "pod"``: the
    replica axis maps to ``pod`` only and each replica FSDP-shards its
    weights over ``data`` — how the 400B MoE holds divergent TT-HF
    copies (a 16-chip replica cannot)."""
    from repro_torch.dist.sharding import ShardingRules
    table = dict(TTHF_PARAM_RULES)
    if scale.granularity == "pod":
        table.update(replica=("pod",), embed=("data",),
                     embed_fsdp=("data",), rnn_width_in=("data",),
                     batch="data")
    elif scale.granularity != "dp":
        raise ValueError(f"granularity must be 'dp' or 'pod', got "
                         f"{scale.granularity!r}")
    return ShardingRules(tuple(table.items()))


def tthf_shardings(model: ModelApi, scale: TTHFScaleConfig, mesh,
                   param_dtype=torch.float32):
    """(``meta`` replicated params (R, ...), their placements tree, the
    (tau, R, b, T) batch's placements) on ``mesh``, a ``DeviceMesh`` or
    an ``AbstractMesh``. The batch's replica dim goes over the replica
    axes and, at pod granularity, its rows over ``data``; mesh axes the
    mesh lacks are dropped, so one table serves the single-pod (data,
    model) mesh."""
    from repro_torch.dist.sharding import placements
    rules = tthf_rules(scale)
    p_abs, axes = model.abstract_params(dtype=param_dtype)
    R = scale.replicas
    p_abs_R = tree_map(lambda s: torch.empty((R,) + tuple(s.shape),
                                             dtype=s.dtype, device="meta"),
                       p_abs)
    sh = tree_map(lambda a: placements(rules.spec(tuple(a), mesh), mesh),
                  replica_axes_tree(axes))
    batch = placements(rules.spec((None, "replica", "batch", None), mesh),
                       mesh)
    return p_abs_R, sh, batch


def stack_replicas(params: dict, replicas: int) -> dict:
    """w_i^(0) = w_hat^(0): identical initial copies (server broadcast),
    materialized so that each replica can be updated in place."""
    return tree_map(lambda l: _broadcast(l.reshape(-1), (replicas,)
                                         + tuple(l.shape)), params)


# ---------------------------------------------------------------------------
# the TT-HF interval step
# ---------------------------------------------------------------------------

class _AllRows:
    """Every replica row lives here (one device)."""

    @staticmethod
    def cross(fn, x):
        return fn(x)

    @staticmethod
    def mean(loss):
        return loss


ALL_ROWS = _AllRows()


class MeshRows:
    """This rank holds its share of the replica rows: the replica dim
    is split over the mesh axes ``axes`` (``("pod", "data")`` or
    ``("pod",)``; those the mesh lacks are skipped), in mesh order.

    A cross-replica op (a D2D mix, an aggregation, the fused block end)
    maps each column over the replica axis alone, so it runs on columns:
    all-to-alls over the replica axes turn the rank's rows (r, M) into
    every replica's rows of a 1/n slice of the columns (R, M / n), the
    op runs there, and the inverse all-to-alls bring the rank's rows
    back; no rank holds more than its share. The loss is the mean over
    every rank's replicas."""

    def __init__(self, mesh, axes):
        names = tuple(mesh.mesh_dim_names)
        dims = [names.index(a) for a in axes if a in names]
        # the innermost axis first: its ranks hold adjacent rows
        self.groups = [mesh.get_group(d) for d in reversed(dims)
                       if mesh.size(d) > 1]
        self.ranks = 1
        for d in dims:
            self.ranks *= mesh.size(d)

    @staticmethod
    def _swap(t: torch.Tensor, group, to_columns: bool) -> torch.Tensor:
        """One all-to-all over ``group`` (n ranks): (r, M) rows -> (n r,
        M / n) columns, or back."""
        import torch.distributed as dist
        n = dist.get_world_size(group)
        if to_columns:
            r, M = t.shape
            t = t.reshape(r, n, M // n).transpose(0, 1).reshape(n * r, -1)
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t.contiguous(), group=group)
        if to_columns:
            return out
        r = out.shape[0] // n
        return out.reshape(n, r, -1).transpose(0, 1).reshape(r, -1)

    def _columns(self, t: torch.Tensor) -> torch.Tensor:
        pad = (-t[0].numel()) % self.ranks
        t = torch.nn.functional.pad(t.reshape(t.shape[0], -1), (0, pad))
        for g in self.groups:
            t = self._swap(t, g, to_columns=True)
        return t

    def _rows(self, t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        for g in reversed(self.groups):
            t = self._swap(t, g, to_columns=False)
        return t[:, :like[0].numel()].reshape(like.shape)

    def cross(self, fn, x):
        if not self.groups:
            return fn(x)
        if isinstance(x, dict):
            out = fn(tree_map(self._columns, x))
            return tree_map(self._rows, out, x)
        if isinstance(x, tuple):
            return self._rows(fn(tuple(self._columns(t) for t in x)), x[0])
        return self._rows(fn(self._columns(x)), x)

    def mean(self, loss):
        import torch.distributed as dist
        loss = loss.clone()
        for g in self.groups:
            dist.all_reduce(loss, group=g)
        return loss / self.ranks


def _loss_and_grads(model: ModelApi, params: dict, mb: dict, dtype):
    """One replica's loss and its gradients (the reference's
    ``value_and_grad``), in leaf order. The parameters are taken as new
    autograd leaves that share storage with ``params``."""
    items = tree_items(params)
    leaves = [v.detach().requires_grad_(True) for _, v in items]
    loss = model.loss(tree_from_items(
        (p, l) for (p, _), l in zip(items, leaves)), mb, dtype=dtype)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), grads


def _replica(mb: dict, r: int) -> dict:
    return {k: v[r] for k, v in mb.items()}


def _mean(losses: list) -> torch.Tensor:
    return torch.stack(losses).mean()


def _check(scale: TTHFScaleConfig, sync: str, hierarchy) -> None:
    """The reference's assertions, as ``ValueError``s."""
    if sync not in SYNCS:
        raise ValueError(f"unknown sync {sync!r}; expected one of {SYNCS}")
    if hierarchy is not None:
        if sync != "tthf":
            raise ValueError("hierarchical aggregation implies tthf sync")
        if hierarchy.taus[0] != scale.tau:
            raise ValueError(
                f"tier-1 period {hierarchy.taus[0]} must equal the "
                f"interval length tau={scale.tau}")
        if hierarchy.sample[0] != scale.sample_per_cluster:
            raise ValueError(
                f"tier-1 fan-in {hierarchy.sample[0]} must equal "
                f"sample_per_cluster={scale.sample_per_cluster}")
    if scale.tau % scale.consensus_every:
        raise ValueError(f"consensus_every={scale.consensus_every} must "
                         f"divide tau={scale.tau}")


def make_tthf_train_step(model: ModelApi, scale: TTHFScaleConfig, *,
                         dtype=torch.bfloat16,
                         sync: str = "tthf", refreshable: bool = False,
                         hierarchy=None, fused_interval: bool = False,
                         fused_kernel: Optional[bool] = None,
                         param_dtype=torch.float32,
                         device: DeviceLike = None, rows=None):
    """Returns ``(step, net)``; ``step(params, batch, agg, step_idx=None,
    mix_refresh=None) -> (params, loss)`` runs one aggregation interval.

    params: every leaf has a leading replica axis R (per-leaf step), or
    the flat ``(R, P)`` buffer of ``step.spec`` (``fused_interval=True``).
    batch: {"tokens", "labels"} of shape (tau, R, b, T). ``agg`` (read by
    ``sync="tthf"`` only; moved to the step's device) takes one form per
    build, as in the reference:

    * default — ``picks``: (N,) the sampled replica of each cluster;
    * ``sample_per_cluster > 1`` or ``refreshable=True`` — the (N, s)
      per-device weights of :func:`repro_torch.netsim.faults.
      aggregation_weights`: all k sampled replicas of a cluster enter the
      aggregate, dark clusters carry 0, an all-dark event is the
      identity. ``refreshable`` (netsim dynamics, the control plane) also
      takes ``mix_refresh``, the interval's mixing matrices from
      :func:`repro_torch.core.mixing.refresh_matrices` (the stacked powers
      ``W = V^Gamma`` for the fused backend, the masked V otherwise);
    * ``hierarchy`` (a non-flat ``HierarchyConfig``) — the composed (R, R)
      device matrix of a :class:`~repro_torch.hierarchy.aggregate.
      HierarchyEvent`, whatever the depth. A flat hierarchy is TT-HF and
      takes the picks form.
    ``dtype`` is the compute dtype of the model, ``param_dtype`` the flat
    buffer's. The step's matrices live on ``device`` (the CUDA device by
    default, see :func:`~repro_torch.kernels.runtime.resolve_device`).

    ``fused_interval=True``: each consensus block's last SGD update fuses
    with the ``W = V^Gamma`` mix (fused_power backend) in
    :func:`~repro_torch.kernels.fused_consensus_sgd.fused_consensus_sgd`,
    one read-w / read-g / write-mixed-w pass. ``fused_kernel``: None or
    True calls that wrapper (the CUDA kernel on a CUDA buffer, its plain
    version on the CPU); False mixes with one whole-buffer einsum after
    the block's last update instead. Other backends keep their exact
    per-event semantics on the flat buffer.
    sync: "tthf" (Algorithm 1) | "star" (FedAvg: full participation, no
    D2D) | "local" (no sync at all — diagnostics).

    ``rows``: where the replica rows live (:class:`MeshRows`; default,
    all of them here). The microsteps run on the rows given; the mixes,
    the aggregation and the reported loss go through ``rows``.
    """
    if hierarchy is not None and hierarchy.is_flat:
        hierarchy = None            # plain TT-HF
    _check(scale, sync, hierarchy)
    device = resolve_device(device)
    rows = rows or ALL_ROWS
    net = scale.network()
    n_blocks = scale.tau // scale.consensus_every
    plan: Optional[MixingPlan] = None
    if sync == "tthf":
        plan = build_mixing_plan(net, scale.gamma_d2d,
                                 backend=scale.consensus_mode, device=device)
    ce = scale.consensus_every
    # one aggregation form per build: its (per-leaf, flat) functions
    agg_kind = ("matrix" if hierarchy is not None
                else "weights" if (refreshable or
                                   scale.sample_per_cluster > 1)
                else "picks")
    agg_fns = {
        "picks": (sampled_aggregation, sampled_aggregation_flat),
        "weights": (weighted_aggregation, weighted_aggregation_flat),
        "matrix": (lambda p, _, m: apply_device_matrix_pytree(p, m),
                   lambda f, _, m: apply_device_matrix_flat(f, m)),
    }[agg_kind]

    def aggregate(params, agg, flat: bool):
        if sync == "tthf":
            return agg_fns[flat](params, net, agg.to(device))
        if sync == "star":
            return (full_aggregation_flat if flat
                    else full_aggregation)(params, net)
        return params

    def mix_active(refresh) -> bool:
        return plan is not None and not (plan.is_noop and refresh is None)

    def block_batches(batch, b):
        return [{k: v[b * ce + t] for k, v in batch.items()}
                for t in range(ce)]

    if fused_interval:
        return _make_fused_interval_step(
            model, scale, net=net, plan=plan, n_blocks=n_blocks,
            block_batches=block_batches, aggregate=aggregate,
            mix_active=mix_active, dtype=dtype, fused_kernel=fused_kernel,
            param_dtype=param_dtype, device=device, rows=rows, sync=sync)

    def microstep(params, mb, lr):
        """Per-replica SGD (eqs. 8-9), in place — no cross-replica
        traffic."""
        R = tree_leaves(params)[0].shape[0]
        losses = []
        for r in range(R):
            loss, grads = _loss_and_grads(
                model, tree_map(lambda l: l[r], params), _replica(mb, r),
                dtype)
            with torch.no_grad():
                for w, g in zip(tree_leaves(params), grads):
                    w[r].sub_(lr.to(w.dtype) * g.to(w.dtype))
            losses.append(loss)
        return _mean(losses)

    def mix(params, refresh):
        N, s = net.num_clusters, net.cluster_size
        return tree_map(lambda l: plan.apply(l.reshape(N, s, -1),
                                             refresh=refresh)
                        .reshape(l.shape).to(l.dtype), params)

    def step(params, batch, agg, step_idx=None, mix_refresh=None):
        lr = torch.full((), scale.lr, dtype=torch.float32, device=device)
        block_losses = []
        for b in range(n_blocks):
            losses = [microstep(params, mb, lr)
                      for mb in block_batches(batch, b)]
            if mix_active(mix_refresh):
                params = rows.cross(lambda p: mix(p, mix_refresh), params)
            block_losses.append(_mean(losses))
        if sync != "local":
            params = rows.cross(lambda p: aggregate(p, agg, flat=False),
                                params)
        return params, rows.mean(_mean(block_losses))

    return step, net


def _make_fused_interval_step(model: ModelApi, scale: TTHFScaleConfig, *,
                              net: Network, plan: Optional[MixingPlan],
                              n_blocks: int, block_batches, aggregate,
                              mix_active, dtype,
                              fused_kernel: Optional[bool], param_dtype,
                              device: torch.device, rows, sync: str):
    """The ``fused_interval=True`` build — see ``make_tthf_train_step``.

    The arithmetic is the per-leaf step's: gradients of the same tree
    (views into the buffer), the same elementwise update, and mixes and
    aggregations that are per-column identical to their per-leaf
    counterparts. The kernel block-end rounds the last update and the
    mix as the separate ops do, so it carries the kernel's tolerance. A
    refreshed interval's block ends take its ``W`` (``plan.fused_w
    (mix_refresh)``)."""
    spec = FlatParamSpec.for_model(model, dtype=param_dtype)
    N, s = net.num_clusters, net.cluster_size
    use_kernel = fused_kernel is None or fused_kernel

    def replica_grads(flat, mb, r):
        return _loss_and_grads(model, spec.unflatten_one(flat[r]),
                               _replica(mb, r), dtype)

    def sgd(flat, mb, lr):
        """One microstep on the flat buffer, in place."""
        losses = []
        for r in range(flat.shape[0]):
            loss, grads = replica_grads(flat, mb, r)
            with torch.no_grad():
                for w, g in zip(spec.leaf_views(flat[r]), grads):
                    w.sub_(lr.to(w.dtype) * g.to(w.dtype))
            losses.append(loss)
        return _mean(losses)

    def grad_flat(flat, mb):
        """Mean loss and the flat (R, P) gradients; pad columns zero."""
        g = torch.empty_like(flat)
        g[:, spec.total:] = 0
        losses = []
        for r in range(flat.shape[0]):
            loss, grads = replica_grads(flat, mb, r)
            for view, gr in zip(spec.leaf_views(g[r]), grads):
                view.copy_(gr)
            losses.append(loss)
        return g, _mean(losses)

    def step(flat, batch, agg, step_idx=None, mix_refresh=None):
        lr = torch.full((), scale.lr, dtype=torch.float32, device=device)
        active = mix_active(mix_refresh)
        W0 = plan.fused_w(mix_refresh) if active else None
        kernel_end = use_kernel and W0 is not None
        block_losses = []
        for b in range(n_blocks):
            mbs = block_batches(batch, b)
            if kernel_end:
                # the LAST microstep's update fuses with the mix: one
                # read-w / read-g / write-mixed-w pass
                losses = [sgd(flat, mb, lr) for mb in mbs[:-1]]
                g, last = grad_flat(flat, mbs[-1])
                flat = rows.cross(lambda fg: fused_consensus_sgd(
                    fg[0].view(N, s, -1), fg[1].view(N, s, -1), W0, lr
                ).view(fg[0].shape), (flat, g))
                del g
                losses.append(last)
            else:
                losses = [sgd(flat, mb, lr) for mb in mbs]
                if W0 is not None:
                    flat = rows.cross(lambda f: torch.einsum(
                        "nij,njm->nim", W0.to(f.dtype),
                        f.view(N, s, -1)).reshape(f.shape), flat)
                elif active:
                    # non-fused_power backend: exact per-event semantics
                    flat = rows.cross(lambda f: plan.apply(
                        f.view(N, s, -1), refresh=mix_refresh
                    ).reshape(f.shape).to(f.dtype), flat)
            block_losses.append(_mean(losses))
        if sync != "local":
            flat = rows.cross(lambda f: aggregate(f, agg, flat=True), flat)
        return flat, rows.mean(_mean(block_losses))

    step.spec = spec
    return step, net


__all__ = [
    "ALL_ROWS", "FlatParamSpec", "LANE", "MATRIX_BLOCK_COLS", "MeshRows",
    "SYNCS",
    "TTHF_PARAM_RULES", "TTHFScaleConfig",
    "apply_device_matrix_flat", "apply_device_matrix_pytree",
    "full_aggregation", "full_aggregation_flat", "make_tthf_train_step",
    "replica_axes_tree", "sampled_aggregation", "sampled_aggregation_flat",
    "stack_replicas", "tthf_rules", "tthf_shardings",
    "weighted_aggregation", "weighted_aggregation_flat",
]
