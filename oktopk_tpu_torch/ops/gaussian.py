"""Gaussian threshold estimation.

Counterpart of ``oktopk_tpu/ops/gaussian.py:22-57``: a first threshold
from a normal fit (the two-sided ppf of N(mean, std) at the target
density), then a fixed number of bisection steps on count(|x| >= t)
between 0 and max|x|, seeded on the side of the fit the count puts it.

The bisection is exact (integer counts, IEEE midpoints), so the result
depends on the fit alone, and the fit is computed so that the CPU and the
card agree bit for bit: the mean and the variance are summed in float64
and rounded to float32 once (a float32 sum's last bits depend on the
summation order, which differs between devices), and ``erfinv(2p - 1)``
depends only on k and n, so it is evaluated once on the host. Against
the JAX package (float32 sums in XLA's order, ``lax.erf_inv``) the fit
differs in the last bits, and so may the threshold (ROADMAP.md, Queue 3).
"""

from __future__ import annotations

import math

import numpy as np
import torch

_F32 = np.float32
_SQRT2 = float(_F32(math.sqrt(2.0)))


def erfinv_at_density(k: int, n: int) -> float:
    """``erfinv(2p - 1)`` with ``p = 1 - clip(k/n)/2`` (so sqrt(2) times
    it is the standard normal's two-sided quantile at density k/n), each
    step rounded to float32 as in the JAX form."""
    ratio = np.clip(_F32(k / n), _F32(1e-9), _F32(0.5))
    q = _F32(2.0) * (_F32(1.0) - ratio / _F32(2.0)) - _F32(1.0)
    return float(torch.erfinv(torch.tensor(float(q), dtype=torch.float32)))


def gaussian_threshold(x: torch.Tensor, k: int,
                       refine_iters: int = 16) -> torch.Tensor:
    """Threshold t with count(|x| >= t) ~= k, along the last dimension of
    ``x`` (one threshold per row), without sorting."""
    abs_x = x.abs()
    f32 = torch.float32
    mean = x.double().mean(-1, keepdim=True).to(f32)
    std = x.double().var(-1, correction=0, keepdim=True).sqrt().to(f32)
    std = std + 1e-12
    t0 = torch.abs(mean + std * _SQRT2 * erfinv_at_density(k, x.shape[-1]))
    hi0 = abs_x.amax(-1, keepdim=True)
    t0 = torch.minimum(torch.clamp(t0, min=0.0), hi0)
    zero = torch.zeros_like(t0)
    above = (abs_x >= t0).sum(-1, keepdim=True) > k
    lo = torch.where(above, t0, zero)
    hi = torch.where(above, hi0, t0)
    for _ in range(refine_iters):
        mid = 0.5 * (lo + hi)
        above = (abs_x >= mid).sum(-1, keepdim=True) > k
        lo = torch.where(above, mid, lo)
        hi = torch.where(above, hi, mid)
    return (0.5 * (lo + hi)).squeeze(-1)
