from repro_torch.obs.sink import NULL_OBS

__all__ = ["NULL_OBS"]
