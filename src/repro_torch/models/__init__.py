from repro_torch.models.simple import SimModel, make_sim_model, params_from_jax

__all__ = ["SimModel", "make_sim_model", "params_from_jax"]
