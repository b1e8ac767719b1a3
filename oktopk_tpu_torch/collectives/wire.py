"""bf16 wire format for sparse message values, and the byte accounting.

Counterpart of ``oktopk_tpu/collectives/wire.py:59-123``: values cross the
exchange as bfloat16 (indices stay int32), and the rounding error is kept
in the error-feedback residual, so quantised mass is delivered later
rather than lost. ``wire_dtype="float32"`` sends values unrounded.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from oktopk_tpu_torch.config import OkTopkConfig
from oktopk_tpu_torch.ops.residual import (
    update_residual_at_selection,
    update_residual_at_winners,
)

# Fault-injection seam: a transform applied to every value buffer [W, ...]
# as it crosses an exchange, called as hook(buffer, cfg, step), ``step``
# the bucket's host step counter. None (the default) applies nothing;
# ``resilience/faults.py::make_wire_hook`` builds a fault plan's hook.
_WIRE_FAULT: Optional[Callable] = None


def install_wire_fault(hook: Optional[Callable]) -> Optional[Callable]:
    """Install (or clear, with None) the wire hook; returns the previous."""
    global _WIRE_FAULT
    prev = _WIRE_FAULT
    _WIRE_FAULT = hook
    return prev


def on_wire(x: torch.Tensor, cfg: OkTopkConfig, step=None) -> torch.Tensor:
    """The value buffer as it crosses the exchange."""
    if cfg.wire_dtype != "float32":
        x = x.to(torch.bfloat16)
    if _WIRE_FAULT is not None:
        x = _WIRE_FAULT(x, cfg, step)
    return x


def pair_wire_bytes(pairs, cfg: OkTopkConfig):
    """Bytes for ``pairs`` (index, value) pairs: 4 + 2 (bf16) or 4 + 4,
    as a float32 product. A count tensor gives a tensor on its device; a
    Python number (a static count) gives a Python float."""
    if isinstance(pairs, torch.Tensor):
        return pairs.to(torch.float32) * float(cfg.wire_pair_bytes)
    return float(np.float32(pairs) * np.float32(cfg.wire_pair_bytes))


def dense_wire_bytes(values, value_bytes: int = 4) -> float:
    """Bytes for ``values`` bare scalars (the dense allreduce)."""
    return float(values) * float(value_bytes)


def wire_round(x: torch.Tensor, cfg: OkTopkConfig) -> torch.Tensor:
    """Round through the wire dtype (bf16 -> f32 is exact)."""
    if cfg.wire_dtype == "float32":
        return x
    return x.to(torch.bfloat16).to(x.dtype)


def residual_after_selection(acc, sel_mask, cfg: OkTopkConfig):
    """Zero the residual at the local selection; under bf16 keep the
    rounding error there instead."""
    if cfg.wire_dtype == "float32":
        return update_residual_at_selection(acc, sel_mask)
    return torch.where(sel_mask, acc - wire_round(acc, cfg), acc)


def residual_after_winners(acc, winner_mask, sent_mask, reduced,
                           cfg: OkTopkConfig, owner_scale=None):
    """Zero the residual at global winners. Under bf16: keep
    ``acc - round(acc)`` at winners this worker sent, 0 at winners it did
    not, and on the region owner (``reduced != 0``) also the phase-(b)
    rounding of its reduced sums, times ``owner_scale`` (a 0/1 float32
    tensor broadcast against ``acc``; 0 where the gather was not rounded,
    as in topkSA's dense fallback)."""
    if cfg.wire_dtype == "float32":
        return update_residual_at_winners(acc, winner_mask)
    zero = torch.zeros((), dtype=acc.dtype, device=acc.device)
    quant_err = acc - wire_round(acc, cfg)
    res = torch.where(winner_mask, torch.where(sent_mask, quant_err, zero),
                      acc)
    comp = torch.where(winner_mask & (reduced != 0.0),
                       reduced - wire_round(reduced, cfg), zero)
    if owner_scale is not None:
        comp = comp * owner_scale
    return res + comp
