"""Learning-rate schedules (port of ``repro.optim.schedule``): pure
functions of the step."""
from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, peak_lr: float, warmup_steps: int,
                  total_steps: int, min_ratio: float = 0.1) -> torch.Tensor:
    """Linear warmup to ``peak_lr`` over ``warmup_steps``, then a cosine
    decay to ``min_ratio * peak_lr`` at ``total_steps``: a float32 scalar on
    the step's device."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = peak_lr * step / max(warmup_steps, 1)
    frac = ((step - warmup_steps) / max(total_steps - warmup_steps, 1)
            ).clamp(0.0, 1.0)
    cos = peak_lr * (min_ratio + (1 - min_ratio) * 0.5
                     * (1 + torch.cos(math.pi * frac)))
    return torch.where(step < warmup_steps, warm, cos)
