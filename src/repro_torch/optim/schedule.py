"""Learning-rate schedules (the port of `repro.optim.schedule`)."""

from __future__ import annotations

import math

import torch


def cosine_schedule(step, cfg) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_ratio * lr, in f32 (a 0-d
    tensor on `step`'s device when it is a tensor).  Step 0 gives 0, so the
    first AdamW step moves only the moments, as in the reference."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    scale = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
    return cfg.lr * warm * scale
