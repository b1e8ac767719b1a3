"""BertAdam's warmup schedules over the progress x = step / t_total.

Counterpart of ``oktopk_tpu/optim/schedules.py:15-32``. ``x`` is a
float32 tensor (on the optimizer's device, so no step waits for the
host); the result is float32. ``multistep_lr`` is not ported yet
(ROADMAP.md).
"""

from __future__ import annotations

import math

import torch


def warmup_cosine(x: torch.Tensor, warmup: float = 0.002) -> torch.Tensor:
    return torch.where(x < warmup, x / warmup,
                       0.5 * (1.0 + torch.cos(math.pi * x)))


def warmup_constant(x: torch.Tensor, warmup: float = 0.002) -> torch.Tensor:
    return torch.where(x < warmup, x / warmup, torch.ones_like(x))


def warmup_linear(x: torch.Tensor, warmup: float = 0.002) -> torch.Tensor:
    return torch.where(x < warmup, x / warmup,
                       torch.clamp(1.0 - x, min=0.0))


SCHEDULES = {
    "warmup_cosine": warmup_cosine,
    "warmup_constant": warmup_constant,
    "warmup_linear": warmup_linear,
}
