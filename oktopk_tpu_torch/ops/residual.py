"""Error-feedback residual transforms.

Counterpart of ``oktopk_tpu/ops/residual.py:22-39``: oktopk keeps acc as
residual except at global winners, topkA-style compressors except at the
local selection.
"""

from __future__ import annotations

import torch


def add_residual(grad: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
    """acc = grad + residual."""
    return grad + residual


def update_residual_at_winners(acc: torch.Tensor,
                               winner_mask: torch.Tensor) -> torch.Tensor:
    """Keep acc as residual except at global winners (zeroed)."""
    return torch.where(winner_mask, torch.zeros((), dtype=acc.dtype,
                                                device=acc.device), acc)


def update_residual_at_selection(acc: torch.Tensor,
                                 selected_mask: torch.Tensor) -> torch.Tensor:
    """Keep everything not locally selected."""
    return torch.where(selected_mask, torch.zeros((), dtype=acc.dtype,
                                                  device=acc.device), acc)
