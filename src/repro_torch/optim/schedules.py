"""Learning-rate schedules, pure functions of the step (``repro/optim/schedules.py``).

The returned ``lr(step)`` takes an int or a step tensor and returns a float32
tensor on the step's device (the CPU for an int).
"""

from __future__ import annotations

import math

import torch


def _step_f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def cosine_schedule(base_lr: float, total_steps: int, final_frac: float = 0.1):
    def lr(step):
        t = torch.clamp(_step_f32(step) / max(total_steps, 1), 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * t))
        return base_lr * (final_frac + (1.0 - final_frac) * cos)

    return lr


def linear_warmup_cosine(
    base_lr: float, warmup_steps: int, total_steps: int, final_frac: float = 0.1
):
    cos = cosine_schedule(base_lr, max(total_steps - warmup_steps, 1), final_frac)

    def lr(step):
        step = torch.as_tensor(step)
        step_f = step.to(torch.float32)
        warm = base_lr * step_f / max(warmup_steps, 1)
        return torch.where(step_f < warmup_steps, warm, cos(step - warmup_steps))

    return lr
