"""LR schedules (pure functions of the step counter); port of
``repro.optim.schedule``."""
from __future__ import annotations

import math

import torch


def cosine_warmup(base_lr: float, warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.1):
    def lr(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = base_lr * step / max(warmup_steps, 1)
        t = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1),
                        0.0, 1.0)
        cos = base_lr * (min_ratio + (1 - min_ratio) * 0.5 *
                         (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup_steps, warm, cos)
    return lr
