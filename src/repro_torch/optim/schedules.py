"""Learning-rate schedules: pure functions of the int32 step tensor that
return a 0-d fp32 tensor on the step's device (no host sync)."""
from __future__ import annotations

import math

import torch


def constant_schedule(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32, device=step.device)


def cosine_schedule(lr: float, total_steps: int, final_frac: float = 0.1):
    def f(step):
        t = torch.clamp(step.float() / total_steps, 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * t))
        return lr * (final_frac + (1.0 - final_frac) * cos)

    return f


def linear_warmup_cosine(lr: float, warmup_steps: int, total_steps: int,
                         final_frac: float = 0.1):
    cos = cosine_schedule(lr, max(1, total_steps - warmup_steps), final_frac)

    def f(step):
        warm = lr * step.float() / max(1, warmup_steps)
        return torch.where(step <= warmup_steps, warm, cos(step - warmup_steps))

    return f
