"""The scale-mode training loop of the port (``repro/train/``)."""
from repro_torch.train.trainer import ScaleTrainer, TrainerConfig
from repro_torch.train.metrics import MetricLogger
from repro_torch.train.prefetch import PrefetchLoader

__all__ = ["ScaleTrainer", "TrainerConfig", "MetricLogger",
           "PrefetchLoader"]
