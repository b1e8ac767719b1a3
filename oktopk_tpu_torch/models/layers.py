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
- ``dropout`` and ``attention_dropout``: flax's masks, bit for bit. A
  model lists its dropout sites (``dropout_sites``: the flax scope path
  and the count of that scope's ``make_rng`` calls, in the order the
  forward pass runs them); ``SiteKeys`` derives every site's key from the
  apply's dropout key in one host call (``ops/prng.py``), and each site
  draws ``keep_mask`` (the threefry kernel on the card) under its key.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn as nn

from oktopk_tpu_torch.ops import prng


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


class SiteKeys:
    """The keys of a model's dropout sites under one apply's dropout key
    ``rng`` ([2] uint32), handed out in the order the sites run:
    ``hashes`` are the sites' ``prng.site_hash`` values."""

    def __init__(self, rng, hashes: np.ndarray):
        if rng is None:
            raise ValueError("dropout in train mode needs a key (the "
                             "apply's dropout rng)")
        self.keys = prng.site_keys(rng, hashes)
        self.used = 0

    def next(self) -> np.ndarray:
        key = self.keys[self.used]
        self.used += 1
        return key


def site_hashes(sites) -> np.ndarray:
    """[S] uint32: each ``make_rng`` suffix's hash (``prng.site_hash``)."""
    return np.array([prng.site_hash(s) for s in sites], dtype=np.uint32)


def _divisor(keep_prob: float, like: torch.Tensor) -> torch.Tensor:
    """``keep_prob`` as a 0-d tensor on ``like``'s device: PyTorch divides
    a CUDA tensor by a Python number as a multiply by its reciprocal,
    which can differ from flax's division in the last bit. ``full`` fills
    it on the device, without a copy from the host."""
    return torch.full((), keep_prob, dtype=like.dtype, device=like.device)


def dropout(x: torch.Tensor, rate: float, train: bool,
            keys: SiteKeys) -> torch.Tensor:
    """flax ``nn.Dropout``: ``select(mask, x / keep_prob, 0)`` with the
    mask ``bernoulli(key, keep_prob, x.shape)`` of the next site's key."""
    if not train or rate == 0.0:
        return x
    keep_prob = 1.0 - rate
    keep = prng.keep_mask(keys.next(), x.shape, keep_prob, x.device)
    return torch.where(keep, x / _divisor(keep_prob, x),
                       torch.zeros((), dtype=x.dtype, device=x.device))


def attention_dropout(w: torch.Tensor, rate: float, train: bool,
                      keys: SiteKeys) -> torch.Tensor:
    """flax ``MultiHeadDotProductAttention``'s broadcast dropout on the
    weights [B, heads, Tq, Tk]: one mask over (Tq, Tk), and
    ``w * (mask / keep_prob)`` (a multiply, as flax does)."""
    if not train or rate == 0.0:
        return w
    keep_prob = 1.0 - rate
    keep = prng.keep_mask(keys.next(), (1, 1) + tuple(w.shape[-2:]),
                          keep_prob, w.device)
    return w * (keep.to(w.dtype) / _divisor(keep_prob, w))


def flatten_nhwc(x: torch.Tensor) -> torch.Tensor:
    """An NCHW map flattened in NHWC order, as a flax model flattens."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def pad_bottom_right(x: torch.Tensor, value: float) -> torch.Tensor:
    """An NCHW map padded by one row below and one column right."""
    return torch.nn.functional.pad(x, (0, 1, 0, 1), value=value)
