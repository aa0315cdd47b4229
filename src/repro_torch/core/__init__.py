"""TT-HF core of the port — topology, mixing, sampling, schedules, the
ledger and the Algorithm-1 trainer, each mirroring ``repro/core/``.

``core/theory.py`` is not copied yet: it comes with the obs port (its
gauges) and scale mode.
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
    "CommLedger", "E_GLOB_J", "DELTA_GLOB_S",
    "TTHFTrainer", "TTHFState", "History", "make_baseline_config",
]
