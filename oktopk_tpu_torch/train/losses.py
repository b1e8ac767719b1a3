"""Loss functions (counterpart of ``oktopk_tpu/train/losses.py``; the CNN
cross entropy only so far)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def softmax_cross_entropy(logits: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy over integer labels [B], computed in float32."""
    return F.cross_entropy(logits.to(torch.float32), labels.long())
