"""Learning-rate schedules, ``step -> lr`` callables on an int tensor step
(the JAX package's ``optim/schedules.py``); each returns an f32 tensor."""
from __future__ import annotations

import math

import torch


def constant_schedule(lr: float):
    def f(step: torch.Tensor) -> torch.Tensor:
        return torch.tensor(lr, dtype=torch.float32, device=step.device)

    return f


def cosine_schedule(peak_lr: float, total_steps: int, final_frac: float = 0.1):
    def f(step: torch.Tensor) -> torch.Tensor:
        t = torch.clamp(step.to(torch.float32) / max(total_steps, 1), 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * t))
        return peak_lr * (final_frac + (1 - final_frac) * cos)

    return f


def warmup_cosine_schedule(peak_lr: float, warmup_steps: int, total_steps: int,
                           final_frac: float = 0.05):
    def f(step: torch.Tensor) -> torch.Tensor:
        s = step.to(torch.float32)
        warm = s / max(warmup_steps, 1)
        t = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps, 1),
                        0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (1.0 + torch.cos(math.pi * t))
        return peak_lr * torch.where(s < warmup_steps, warm, cos)

    return f
