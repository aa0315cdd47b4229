"""TT-HF core of the port — topology, mixing, sampling, schedules, the
ledger, the convergence theory and the Algorithm-1 trainer, each
mirroring ``repro/core/``.
"""
from repro_torch.core.topology import (
    Network, build_network, metropolis_weights, laplacian_weights,
    spectral_radius, check_assumption2, ring_adjacency,
    complete_adjacency, geometric_adjacency,
)
from repro_torch.core.consensus import (
    mix, mix_once, mix_pytree, cluster_means, consensus_error,
    divergence_upsilon, masked_divergence_upsilon,
)
from repro_torch.core.mixing import (
    BACKENDS, MixingPlan, build_mixing_plan, canonical_backend,
    masked_consensus_matrix, matrix_powers, refresh_matrices,
)
from repro_torch.core.schedule import (
    adaptive_gamma, adaptive_gamma_info, fixed_gamma, make_lr_schedule)
from repro_torch.core.sampling import (
    TorchDraws, sample_devices, sample_devices_multi, sampled_global_model,
    sampled_global_model_multi, sampled_global_pytree,
    full_global_pytree, broadcast_pytree,
)
from repro_torch.core.theory import (
    ProblemConstants, check_theorem2_conditions, theorem2_Z, theorem2_nu,
    bound_curve, lemma1_bound, dispersion_bound,
)
from repro_torch.core.energy import CommLedger, E_GLOB_J, DELTA_GLOB_S
from repro_torch.core.tthf import TTHFTrainer, TTHFState, History, \
    make_baseline_config

__all__ = [
    "Network", "build_network", "metropolis_weights", "laplacian_weights",
    "spectral_radius", "check_assumption2", "ring_adjacency",
    "complete_adjacency", "geometric_adjacency",
    "mix", "mix_once", "mix_pytree", "cluster_means", "consensus_error",
    "divergence_upsilon", "masked_divergence_upsilon",
    "BACKENDS", "MixingPlan", "build_mixing_plan", "canonical_backend",
    "masked_consensus_matrix", "matrix_powers", "refresh_matrices",
    "adaptive_gamma", "adaptive_gamma_info", "fixed_gamma",
    "make_lr_schedule",
    "TorchDraws", "sample_devices", "sample_devices_multi",
    "sampled_global_model", "sampled_global_model_multi",
    "sampled_global_pytree", "full_global_pytree", "broadcast_pytree",
    "ProblemConstants", "check_theorem2_conditions", "theorem2_Z",
    "theorem2_nu", "bound_curve", "lemma1_bound", "dispersion_bound",
    "CommLedger", "E_GLOB_J", "DELTA_GLOB_S",
    "TTHFTrainer", "TTHFState", "History", "make_baseline_config",
]
