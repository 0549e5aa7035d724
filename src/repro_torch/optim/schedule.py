"""LR schedules (pure functions of the step), in float32 as the
reference computes them (``repro.optim.schedule``)."""
from __future__ import annotations

import math

import torch

__all__ = ["cosine_schedule", "linear_warmup_cosine"]


def cosine_schedule(step: torch.Tensor, total_steps: int, peak: float, floor: float = 0.0) -> torch.Tensor:
    frac = torch.clamp(step.to(torch.float32) / max(total_steps, 1), 0.0, 1.0)
    return floor + 0.5 * (peak - floor) * (1.0 + torch.cos(math.pi * frac))


def linear_warmup_cosine(step: torch.Tensor, warmup: int, total_steps: int, peak: float,
                         floor: float = 0.0) -> torch.Tensor:
    step = step.to(torch.float32)
    warm = peak * step / max(warmup, 1)
    cos = cosine_schedule(step - warmup, max(total_steps - warmup, 1), peak, floor)
    return torch.where(step < warmup, warm, cos)
