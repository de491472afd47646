"""Learning-rate schedules (port of ``repro.optimizer.schedules``)."""

from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, peak_lr: float, warmup_steps: int,
                  total_steps: int, final_frac: float = 0.1):
    """Linear warmup to ``peak_lr``, then cosine decay to
    ``final_frac * peak_lr``.  ``step`` is a number or a tensor (the
    optimizer's step counter); returns an f32 tensor on its device."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = peak_lr * step / max(warmup_steps, 1)
    t = torch.clamp((step - warmup_steps)
                    / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = peak_lr * (final_frac + (1 - final_frac)
                     * 0.5 * (1 + torch.cos(math.pi * t)))
    return torch.where(step < warmup_steps, warm, cos)
