"""Layers shared by the port's models, written out to match flax.

- ``BatchNorm``: flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over
  the ``axes`` it reduces (``(0, 2, 3)`` for NCHW feature maps, ``(0, 1)``
  for sequence features ``[B, T, F]``), the one axis left being the
  features:
  - batch variance E[x^2] - E[x]^2 (biased, clipped at 0), not the
    unbiased variance ``nn.BatchNorm2d`` puts into its running
    statistics;
  - running statistics ``m * running + (1 - m) * batch`` with flax's
    momentum m = 0.9 (torch's momentum 0.1), updated only where the
    caller asks (``update_stats``: worker 0's microbatches, H7);
  - y = (x - mean) * (rsqrt(var + eps) * scale) + bias, eps = 1e-5.
- ``dropout``: flax ``Dropout``, its masks drawn from an explicit
  ``torch.Generator`` (one per worker, ``train/trainer.py``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the ``axes`` of its input; the features
    lie on the one axis not in ``axes``."""

    def __init__(self, features: int, axes: Sequence[int] = (0, 2, 3),
                 momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.axes = tuple(axes)
        self.momentum = momentum
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x, train: bool = True, update_stats: bool = True):
        if train:
            mean = x.mean(self.axes)
            mean2 = (x * x).mean(self.axes)
            var = torch.clamp(mean2 - mean * mean, min=0.0)
            if update_stats:
                with torch.no_grad():
                    m = self.momentum
                    self.mean.copy_(m * self.mean + (1.0 - m) * mean)
                    self.var.copy_(m * self.var + (1.0 - m) * var)
        else:
            mean, var = self.mean, self.var
        shape = [1 if d in self.axes else -1 for d in range(x.dim())]
        mul = torch.rsqrt(var + self.eps) * self.scale
        return (x - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)


def dropout(x: torch.Tensor, rate: float, train: bool,
            generator: Optional[torch.Generator],
            shape: Optional[Tuple[int, ...]] = None) -> torch.Tensor:
    """flax ``Dropout``: keep with probability 1 - rate (a uniform draw
    below it), kept values divided by 1 - rate. ``shape`` broadcasts one
    mask (flax's attention dropout)."""
    if not train or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout needs an explicit torch.Generator")
    keep_prob = 1.0 - rate
    keep = torch.rand(shape or x.shape, generator=generator,
                      device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype,
                                                        device=x.device))
