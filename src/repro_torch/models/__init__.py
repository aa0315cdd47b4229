from repro_torch.models.simple import SimModel, make_sim_model, params_from_jax
from repro_torch.models.registry import ModelApi, build_model

__all__ = ["ModelApi", "SimModel", "build_model", "make_sim_model",
           "params_from_jax"]
