"""One-pass histogram selection thresholds.

Counterpart of ``oktopk_tpu/ops/hist_threshold.py``. Bins are the f32
biased exponent of |x|, read by bit extraction (``view(torch.int32)``) as
the JAX package does (:42-55, :97): a float log is inexact at octave
boundaries, and the fused kernel (``ops/fused_select.py``) must produce
the same bins bit-for-bit. Subnormals go to bin 1 (the min-normal edge),
exact zeros are excluded, inf/nan land in bin 255.
"""

from __future__ import annotations

import torch

HIST_BINS = 256
_MAX_EDGE_BIN = 254   # bin 255 holds inf/nan; its edge (2^128) is not f32


def log2_bins(x: torch.Tensor) -> torch.Tensor:
    """Per-element bin: biased exponent of |x|, subnormals promoted to 1,
    zeros marked -1."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    mag = bits & 0x7FFFFFFF
    e = mag >> 23
    return torch.where(mag == 0, torch.full_like(e, -1),
                       torch.clamp(e, min=1))


def log2_hist(x: torch.Tensor) -> torch.Tensor:
    """[HIST_BINS] i32 counts of the nonzero elements of ``x`` by octave.
    Integer counts, so any order of accumulation gives the same result."""
    b = log2_bins(x).reshape(-1)
    b = torch.where(b < 0, torch.full_like(b, HIST_BINS), b)
    h = torch.zeros(HIST_BINS + 1, dtype=torch.int32, device=x.device)
    h.scatter_add_(0, b.long(), torch.ones_like(b))
    return h[:HIST_BINS]


def hist_to_threshold(hist: torch.Tensor, k) -> torch.Tensor:
    """The largest bin edge 2^(j-127), j in [1, 254], whose suffix count is
    >= k; exactly 0 only for an empty histogram. The edge is assembled
    from exponent bits, never from exp2."""
    hist = hist.to(torch.int32)
    cum = torch.flip(torch.cumsum(torch.flip(hist, (0,)), 0,
                                  dtype=torch.int32), (0,))
    j = torch.arange(HIST_BINS, dtype=torch.int32, device=hist.device)
    ok = (cum >= k) & (j >= 1) & (j <= _MAX_EDGE_BIN)
    jstar = torch.max(torch.where(ok, j, torch.ones_like(j)))
    t = (jstar << 23).view(torch.float32)
    return torch.where(cum[0] > 0, t, torch.zeros_like(t))


def k2threshold_hist(x_abs: torch.Tensor, k) -> torch.Tensor:
    """Histogram + cumsum read: count(|x| >= t) >= k and kth/2 < t <= kth
    whenever at least k elements are live."""
    return hist_to_threshold(log2_hist(x_abs), k).to(x_abs.dtype)
