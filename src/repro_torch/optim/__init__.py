from repro_torch.optim.schedules import (
    paper_schedule, constant, cosine, warmup_cosine,
)

__all__ = ["paper_schedule", "constant", "cosine", "warmup_cosine"]
