"""LR schedules.

Counterpart of ``oktopk_tpu/optim/schedules.py``:

- BertAdam's warmup schedules over the progress x = step / t_total
  (:15-32). ``x`` is a float32 tensor (on the optimizer's device, so no
  step waits for the host); the result is float32.
- ``multistep_lr`` (:35-44), the CNN step decay at epoch milestones.
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


def multistep_lr(base_lr: float, milestones, gamma: float = 0.1):
    """Step decay at epoch milestones: ``schedule(epoch)`` is ``base_lr *
    gamma ** (number of milestones <= epoch)``, float32 on ``epoch``'s
    device (a tensor) or on the CPU (a number)."""
    ms = torch.as_tensor(milestones)

    def schedule(epoch):
        e = torch.as_tensor(epoch)
        drops = torch.sum(e >= ms.to(e.device)).to(torch.float32)
        return base_lr * torch.pow(
            torch.tensor(gamma, dtype=torch.float32, device=e.device), drops)

    return schedule
