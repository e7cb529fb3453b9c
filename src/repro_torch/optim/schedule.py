"""Learning-rate schedules (warmup + cosine decay); port of
`repro.optim.schedule`."""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import TrainConfig


def lr_schedule(cfg: TrainConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a 0-d tensor), a float32
    0-d tensor on the step's device."""
    step = torch.as_tensor(step).to(torch.float32)
    if cfg.warmup_steps <= 0:
        warm = torch.ones_like(step)
    else:
        warm = torch.clamp((step + 1.0) / cfg.warmup_steps, max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * t))
    return cfg.learning_rate * warm * (0.1 + 0.9 * cos)
