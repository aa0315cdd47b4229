from repro_torch.optim.optimizers import (
    Optimizer, sgd, momentum, adamw, make_optimizer, apply_updates,
)
from repro_torch.optim.schedules import (
    paper_schedule, constant, cosine, warmup_cosine,
)

__all__ = [
    "Optimizer", "sgd", "momentum", "adamw", "make_optimizer",
    "apply_updates",
    "paper_schedule", "constant", "cosine", "warmup_cosine",
]
