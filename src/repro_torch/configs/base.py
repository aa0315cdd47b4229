"""Configuration system for the repro framework.

Two families of configs:

* :class:`ModelConfig` — architecture hyperparameters for the model zoo.
  One instance per assigned architecture lives in ``repro/configs/<id>.py``.
* :class:`TTHFConfig` — the paper's algorithm knobs (tau, Gamma schedule,
  consensus topology, step-size schedule, cluster sampling).

Configs are plain frozen dataclasses: hashable (usable as jit static
args), serializable, and composable.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


# ---------------------------------------------------------------------------
# Model zoo configs
# ---------------------------------------------------------------------------

ARCH_KINDS = (
    "dense",      # decoder-only dense transformer
    "moe",        # decoder-only with MoE FFN layers
    "ssm",        # attention-free state space model (Mamba-2 / SSD)
    "hybrid",     # RG-LRU recurrent blocks + local attention (RecurrentGemma)
    "encdec",     # encoder-decoder (Whisper)
    "vlm",        # vision-language: stub vision frontend + dense decoder
    "audio",      # audio: stub conv frontend + encoder-decoder backbone
)


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters.

    Field conventions follow the assignment sheet: ``num_layers`` L,
    ``d_model``, ``num_heads`` H (query heads), ``num_kv_heads`` (GQA;
    1 = MQA), ``d_ff``, ``vocab_size``.
    """

    name: str
    kind: str                       # one of ARCH_KINDS
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // num_heads

    # --- MLP / activation ---
    mlp_variant: str = "swiglu"     # swiglu | geglu | gelu
    # --- attention details ---
    rope: bool = True
    rope_theta: float = 10_000.0
    qkv_bias: bool = False          # Qwen1.5 style
    sliding_window: int = 0         # 0 = full attention; >0 = SWA width
    local_attn_every: int = 0       # hybrid: attention layer period (RG)
    logit_softcap: float = 0.0      # gemma-style final softcap (0 = off)
    # --- norm / embedding ---
    norm: str = "rmsnorm"           # rmsnorm | layernorm
    tie_embeddings: bool = True
    scale_embed: bool = False       # gemma multiplies embeds by sqrt(d)
    # --- MoE ---
    moe_num_experts: int = 0        # 0 = dense FFN
    moe_top_k: int = 1
    moe_every: int = 1              # MoE FFN on every k-th layer
    moe_aux_loss_weight: float = 0.01
    moe_capacity_factor: float = 1.25
    # --- SSM (Mamba-2 / SSD) ---
    ssm_state_dim: int = 0
    ssm_num_heads: int = 0          # SSD heads (v-heads)
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_conv_width: int = 4
    # --- hybrid (RG-LRU) ---
    rglru_width: int = 0            # recurrent block width (RG: d_model)
    rglru_conv_width: int = 4
    attention_window: int = 2048    # local attention window for hybrid
    # --- encoder (enc-dec / vlm / audio) ---
    enc_num_layers: int = 0
    enc_seq_len: int = 0            # fixed encoder context (1500 whisper,
                                    # 256 paligemma patches)
    enc_is_stub: bool = True        # frontend provides embeddings directly
    cross_attention: bool = False
    # --- decode limits ---
    max_seq_len: int = 1_048_576
    # citation for the config (paper / model card)
    source: str = ""

    def __post_init__(self):
        assert self.kind in ARCH_KINDS, f"unknown kind {self.kind}"
        if self.head_dim == 0 and self.num_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    # -- derived quantities -------------------------------------------------
    @property
    def q_per_kv(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 so the vocab dim shards
        evenly over the 16-way model axis (padded ids are never targets)."""
        return ((self.vocab_size + 255) // 256) * 256

    def param_count(self) -> int:
        """Approximate parameter count (used for roofline MODEL_FLOPS)."""
        d, f, v, L = self.d_model, self.d_ff, self.vocab_size, self.num_layers
        emb = v * d if self.tie_embeddings else 2 * v * d
        n = emb
        kd = self.head_dim * self.num_kv_heads
        qd = self.head_dim * self.num_heads
        attn = d * qd + 2 * d * kd + qd * d
        gates = 3 if self.mlp_variant in ("swiglu", "geglu") else 2
        for layer in range(L):
            if self.kind == "ssm":
                din = self.ssm_expand * d
                n += d * (2 * din + 2 * self.ssm_num_heads * self.ssm_state_dim
                          + self.ssm_num_heads) + din * d
                continue
            if self.kind == "hybrid" and not self._is_attn_layer(layer):
                w = self.rglru_width or d
                n += d * w * 2 + w * w + 2 * w + w * d  # in-proj, gates, out
            else:
                n += attn
            if self.moe_num_experts and (layer % self.moe_every == self.moe_every - 1):
                n += self.moe_num_experts * gates * d * f + d * self.moe_num_experts
            else:
                n += gates * d * f
        if self.enc_num_layers and not self.enc_is_stub:
            n += self.enc_num_layers * (attn + gates * d * f)
        elif self.enc_num_layers:
            # stub frontend: encoder layers still counted (backbone spec)
            n += self.enc_num_layers * (attn + gates * d * f)
        return n

    def active_param_count(self) -> int:
        """Params active per token (MoE: top_k experts only)."""
        if not self.moe_num_experts:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        gates = 3 if self.mlp_variant in ("swiglu", "geglu") else 2
        n_moe_layers = len([l for l in range(self.num_layers)
                            if l % self.moe_every == self.moe_every - 1])
        dense_equiv = self.param_count() - n_moe_layers * (
            self.moe_num_experts * gates * d * f + d * self.moe_num_experts)
        return dense_equiv + n_moe_layers * self.moe_top_k * gates * d * f

    def _is_attn_layer(self, layer: int) -> bool:
        """Hybrid models: which layers are (local) attention layers."""
        if self.kind != "hybrid":
            return True
        p = self.local_attn_every or 3
        return layer % p == p - 1  # RG: 2 recurrent : 1 attention

    def reduced(self, *, num_layers: int = 2, d_model: int = 256,
                d_ff: int = 512, vocab_size: int = 512,
                num_experts: int = 4) -> "ModelConfig":
        """A tiny same-family variant for CPU smoke tests."""
        heads = max(2, min(4, self.num_heads))
        kv = max(1, min(self.num_kv_heads, heads))
        hd = max(32, d_model // heads)
        changes = dict(
            num_layers=num_layers,
            d_model=d_model,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=hd,
            d_ff=d_ff,
            vocab_size=vocab_size,
            max_seq_len=4096,
        )
        if self.moe_num_experts:
            changes["moe_num_experts"] = min(num_experts, 4)
        if self.kind == "ssm":
            d_in = self.ssm_expand * d_model
            changes.update(ssm_state_dim=32, ssm_head_dim=32,
                           ssm_num_heads=d_in // 32, ssm_chunk=32,
                           num_heads=0, num_kv_heads=0, head_dim=0)
        if self.kind == "hybrid":
            # 3 layers = one full (rec, rec, local-attn) group
            changes.update(rglru_width=d_model, attention_window=128,
                           num_layers=max(num_layers, 3))
        if self.enc_num_layers:
            changes.update(enc_num_layers=2, enc_seq_len=16)
        return dataclasses.replace(self, **changes)


# ---------------------------------------------------------------------------
# TT-HF algorithm config (the paper's knobs)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TopologyConfig:
    """Cluster/D2D topology (Sec. II-A)."""
    num_devices: int = 125          # I
    num_clusters: int = 25          # N
    graph: str = "geometric"        # geometric | ring | complete
    target_spectral_radius: float = 0.7   # rho(V - 11^T/s) tuning target
    weights: str = "metropolis"     # metropolis | laplacian
    seed: int = 0

    @property
    def cluster_size(self) -> int:
        assert self.num_devices % self.num_clusters == 0
        return self.num_devices // self.num_clusters


@dataclass(frozen=True)
class DynamicsConfig:
    """Time-varying network dynamics (``repro.netsim``).

    Describes the event processes the :class:`~repro.netsim.events.
    EventStream` draws at each iteration t:

    * per-edge 2-state Markov chains over the BASE D2D edges
      (``p_link_fail`` = P(up -> down), ``p_link_recover`` =
      P(down -> up), applied once per iteration);
    * per-device churn Markov chains (``p_device_drop`` /
      ``p_device_return``) — a dropped device neither trains, mixes,
      uploads, nor receives broadcasts: it *holds* its parameters;
    * stragglers: a fixed ``straggler_frac`` of devices drawn at
      stream construction; each consensus/uplink involving one pays a
      lognormal tail-delay multiplier ``1 + LogNormal(mu, sigma)``;
    * flash crowd: a deterministic mass departure — ``flash_drop_frac``
      of devices dark for ``t in [flash_at, flash_at+flash_duration)``.

    The all-defaults config is *static* (every process degenerate) and
    the trainers take the exact pre-netsim code path for it, so
    ``static`` trajectories are bit-for-bit the historical ones.
    """
    name: str = "static"
    # link dynamics (per base edge, per iteration)
    p_link_fail: float = 0.0
    p_link_recover: float = 1.0
    # device churn (per device, per iteration)
    p_device_drop: float = 0.0
    p_device_return: float = 1.0
    # stragglers
    straggler_frac: float = 0.0
    straggler_mu: float = 0.0        # lognormal location of the tail
    straggler_sigma: float = 1.0     # lognormal scale of the tail
    # flash crowd (deterministic window)
    flash_at: int = 0
    flash_duration: int = 0
    flash_drop_frac: float = 0.0
    seed: int = 0

    @property
    def is_static(self) -> bool:
        """True iff no event process can ever fire."""
        return (self.p_link_fail == 0.0 and self.p_device_drop == 0.0
                and self.straggler_frac == 0.0
                and (self.flash_duration == 0 or self.flash_drop_frac == 0.0))


CONTROL_POLICIES = ("static", "remark1", "connectivity")


@dataclass(frozen=True)
class ControlConfig:
    """Online control plane (``repro.control``, DESIGN.md §16).

    Declares how — if at all — the per-cluster D2D round counts Γ, the
    aggregation period τ, and the cluster-sampling weights are retuned
    each round from *measured* network/gradient state:

    * ``static`` — the control plane is off; the trainers take the
      exact historical code path (bit-for-bit trajectories, asserted in
      ``tests/test_control.py``);
    * ``remark1`` — the paper's Remark-1 Γ law run through the
      controller: per-event Γ_c from the *assumed* (eigendecomposed)
      contraction factors and the measured divergence Υ_c, with the
      Theorem-2 safety envelope and saturation counting;
    * ``connectivity`` — arXiv:2303.08988-style adaptation: Γ_c from
      power-iteration *estimates* of the active subgraph's contraction
      (no eigendecomposition oracle), availability/straggler-aware
      sampling weights, and (sim mode) an online τ retuned from the
      Theorem-2 bound with gradient diversity / SGD noise estimated on
      the fly (``core/theory.py`` estimators).

    Every decision passes the safety envelope first —
    ``check_theorem2_conditions`` plus decision sanity bounds — and
    falls back to the static schedule when a check fails.
    """
    policy: str = "static"
    # Remark-1 target: eps^(t) = eta_t * phi
    phi: float = 1.0
    # Γ bounds: decisions clamp to [0, gamma_max]; clamp events are
    # counted and surfaced through the obs metrics stream
    gamma_max: int = 64
    # spectral-gap estimator (power iteration on the active subgraph)
    power_iters: int = 40
    estimator_seed: int = 0
    # the contraction factor the static Γ was PROVISIONED for (the
    # worst-case design assumption): the equal-contraction law matches
    # lambda_ref^Γ_static on the measured spectrum, so a network that
    # measures better than the provisioning spends fewer rounds. None
    # (default) uses the build-time eigendecomposed spectrum — i.e.
    # "the design assumption was exact"
    lambda_ref: Optional[float] = None
    # online gradient-statistics window (aggregation rounds) feeding
    # the theory estimators; sgd_probe_draws minibatch draws per device
    # estimate sigma at fixed params
    stats_window: int = 8
    sgd_probe_draws: int = 4
    # τ retuning (sim mode — the scale-mode τ is a static jit shape)
    adapt_tau: bool = True
    tau_min: int = 5
    tau_max: int = 80
    # τ-law comm-cost weight: J(τ) = ν(τ)/ν(τ_0) + w · uplinks-per-step
    energy_weight: float = 2.0
    # availability/straggler-aware sampling weights
    adapt_sampling: bool = True
    # safety envelope master switch (tests only — keep it on)
    safety: bool = True

    def __post_init__(self):
        assert self.policy in CONTROL_POLICIES, \
            f"unknown control policy {self.policy!r}; " \
            f"expected one of {CONTROL_POLICIES}"
        assert self.gamma_max >= 1
        assert self.power_iters >= 1
        assert self.stats_window >= 2
        assert 1 <= self.tau_min <= self.tau_max

    @property
    def is_static(self) -> bool:
        return self.policy == "static"


@dataclass(frozen=True)
class HierarchyConfig:
    """L-level aggregation tree (``repro.hierarchy``, DESIGN.md §9).

    TT-HF's two timescales are the L = 2 special case of a multi-stage
    D2D-enabled fog hierarchy (Hosseinalipour et al. 2020): level 0 is
    the per-cluster D2D consensus tier (unchanged — ``core/mixing.py``),
    levels 1..L-1 are parent-node aggregations over child subtrees, and
    level L-1 is the root (the global model). Each aggregation tier
    l = 1..L-1 has its own period ``taus[l-1]`` and sampling fan-in
    ``sample[l-1]``:

    * tier 1 aggregates clusters — ``sample[0]`` is the paper's
      ``sample_per_cluster`` (devices drawn per cluster, eq. 7);
    * tier l >= 2 aggregates level-(l-1) nodes — ``sample[l-1]``
      children are drawn per parent (0 = full participation);
    * periods nest: ``taus[l-1]`` divides ``taus[l]``, so a deeper
      aggregation always composes with the shallower ones below it.

    ``branching[l-1]`` gives the children per level-l parent for the
    intermediate tiers l = 1..L-2 (the root absorbs every remaining
    node); an empty tuple asks :func:`repro.hierarchy.tree.build_tree`
    to balance the fan-ins automatically. The L = 2 config
    (``is_flat``) is today's TT-HF and the trainers route it through
    the historical code path — bit-for-bit identical trajectories.
    """
    levels: int = 2
    branching: Tuple[int, ...] = ()
    taus: Tuple[int, ...] = (20,)
    sample: Tuple[int, ...] = (1,)
    weights: str = "mass"           # child weights: subtree device mass

    def __post_init__(self):
        assert self.levels >= 2, "a hierarchy needs at least root+clusters"
        tiers = self.levels - 1
        assert len(self.taus) == tiers, \
            f"need one tau per aggregation tier: {tiers}, got {self.taus}"
        assert len(self.sample) == tiers, \
            f"need one fan-in per aggregation tier: {tiers}, " \
            f"got {self.sample}"
        assert len(self.branching) in (0, max(self.levels - 2, 0)), \
            "branching must be empty (auto) or cover every " \
            "intermediate tier (the root absorbs the rest)"
        assert all(t >= 1 for t in self.taus)
        assert all(k >= 0 for k in self.sample)
        assert self.sample[0] >= 1, "tier 1 must sample >= 1 device"
        for lo, hi in zip(self.taus, self.taus[1:]):
            assert hi % lo == 0, \
                f"tier periods must nest (each divides the next): {self.taus}"
        assert self.weights in ("mass",), f"unknown weights {self.weights!r}"

    @property
    def is_flat(self) -> bool:
        """True iff this is plain two-timescale TT-HF (no fog tiers)."""
        return self.levels == 2


@dataclass(frozen=True)
class TTHFConfig:
    """Algorithm 1 knobs + schedules (Sec. II-C, III)."""
    tau: int = 20                   # local model training interval length
    # step size eta_t = gamma / (t + alpha)
    gamma: float = 1.0
    alpha: float = 1.0
    constant_lr: float = 0.0        # >0 overrides the decaying schedule
    # D2D consensus schedule
    consensus_every: int = 5        # run consensus each k-th local step
    gamma_d2d: int = 2              # fixed Gamma (rounds per event); -1 = adaptive
    phi: float = 1.0                # target eps^(t) = eta_t * phi (Remark 1)
    # cluster sampling
    sample_per_cluster: int = 1
    # baseline switches
    mode: str = "tthf"              # tthf | fedavg (star) | centralized
    full_participation: bool = False
    seed: int = 0

    def is_aggregation_step(self, t: int) -> bool:
        return t > 0 and t % self.tau == 0

    def is_consensus_step(self, t: int) -> bool:
        if self.mode != "tthf":
            return False
        return self.consensus_every > 0 and t % self.consensus_every == 0


@dataclass(frozen=True)
class TrainConfig:
    """Scale-mode training-loop config."""
    global_batch: int = 256
    seq_len: int = 4096
    steps: int = 100
    learning_rate: float = 3e-3
    warmup: int = 0
    optimizer: str = "sgd"          # sgd | momentum | adamw
    momentum: float = 0.9
    weight_decay: float = 0.0
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: bool = True
    # TT-HF scale mode
    sync: str = "star"              # star | tthf
    tthf: TTHFConfig = field(default_factory=TTHFConfig)
    clusters_of_replicas: int = 4   # N in scale mode
    seed: int = 0


# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    phase: str                      # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
