"""Learning-rate schedules (linear warmup + cosine decay), ported from
``repro.optim.schedule``: computed in f32 on a tensor step, on its device."""
from __future__ import annotations

import math

import torch


def warmup_cosine(step: torch.Tensor, *, peak_lr: float, warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.1) -> torch.Tensor:
    """The learning rate at ``step`` (a 0-d tensor; the optimizer's count
    before this step's increment), a 0-d f32 tensor on ``step``'s device."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = s / max(warmup_steps, 1)
    prog = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = min_ratio + (1.0 - min_ratio) * 0.5 * (1.0 + torch.cos(math.pi * prog))
    return peak_lr * torch.where(s < warmup_steps, warm, cos)
