from repro_torch.optim.optimizers import (
    Optimizer,
    OptState,
    adamw,
    clip_by_global_norm,
    global_norm,
    sgd,
)
from repro_torch.optim.schedules import constant_schedule, cosine_schedule, linear_warmup_cosine

__all__ = [
    "Optimizer",
    "OptState",
    "adamw",
    "sgd",
    "global_norm",
    "clip_by_global_norm",
    "constant_schedule",
    "cosine_schedule",
    "linear_warmup_cosine",
]
