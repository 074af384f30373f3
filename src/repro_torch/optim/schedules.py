"""Learning-rate schedules: step (an int tensor) -> lr (fp32 tensor).

Port of ``src/repro/optim/schedules.py``.
"""

from __future__ import annotations

import math

import torch


def constant_schedule(lr: float):
    return lambda step: torch.as_tensor(lr, dtype=torch.float32)


def cosine_schedule(peak_lr: float, total_steps: int, final_frac: float = 0.1):
    def fn(step):
        t = torch.clamp(torch.as_tensor(step).to(torch.float32) / total_steps,
                        0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * t))
        return peak_lr * (final_frac + (1.0 - final_frac) * cos)
    return fn


def linear_warmup_cosine(peak_lr: float, warmup: int, total_steps: int,
                         final_frac: float = 0.1):
    cos = cosine_schedule(peak_lr, max(total_steps - warmup, 1), final_frac)

    def fn(step):
        step = torch.as_tensor(step)
        warm = peak_lr * step.to(torch.float32) / max(warmup, 1)
        return torch.where(step <= warmup, warm, cos(step - warmup))
    return fn
